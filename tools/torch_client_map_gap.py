#!/usr/bin/env python3
"""Where the sp engine's vmapped client map and its one-by-one map part on
a deep ReLU MLP: ``pipe_mlp`` at ``chip_smoke.py`` phase 18 (a)'s
arguments (hidden 4096, depth 16, f32, batch 16, lr 0.05), two clients'
local SGD through ``LocalTrainer.make_local_train`` under
``core.federated.client_map`` "vmap" and "scan", from the same weights
and the same batches (the first two clients' rows of the dataset, in
order, wrapping round past their last).

For each step ``s``: before it, the ReLU masks (pre-activation > 0, every
layer, row and unit) of the two runs' forwards of that step's batch, each
in its own map and at its own params: how many differ, the smallest and
the largest ``|pre-activation|`` among them (the smaller of the two
runs'), and the largest pre-activation difference among the masks that
agree; after it, the two runs' largest params difference.  Then the sp
engine itself, as phase 18 (a) runs it, in both maps from the same
weights: the params difference after each round.  Writes
``chiprun_out/client_map_gap.json``.

    python3 tools/torch_client_map_gap.py [--steps 8] [--rounds 2]
        [--device cuda] [--hidden 4096] [--depth 16]
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--hidden", type=int, default=None)
    ap.add_argument("--depth", type=int, default=None)
    opts = ap.parse_args()
    import torch
    if opts.device == "cuda" and not torch.cuda.is_available():
        sys.exit("needs a CUDA device (or --device cpu)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from chip_smoke import PIPE_CFG, _engine, params_err, sp_args
    import fedml_tpu_torch
    from fedml_tpu_torch import data, model
    from fedml_tpu_torch.core.federated import client_map
    from fedml_tpu_torch.ml.trainer.local_trainer import LocalTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(opts.device)
    cfg = dict(PIPE_CFG)
    if opts.hidden:
        cfg["model_dim"] = opts.hidden
    if opts.depth:
        cfg["model_layers"] = opts.depth
    args = sp_args(fedml_tpu_torch, **cfg)
    ds, n_out = data.load(args)
    tm = model.create(args, n_out)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = tm.init(gen)
    local_train = LocalTrainer(tm, args).make_local_train()
    bsz, n_clients, steps = int(args.batch_size), 2, opts.steps
    # a client's rows in order, again from its first past its last
    rows = [np.resize(ds.client_idxs[c], steps * bsz)
            for c in range(n_clients)]
    x = torch.stack([torch.as_tensor(ds.train_x[r]) for r in rows]).to(dev)
    y = torch.stack([torch.as_tensor(ds.train_y[r]) for r in rows]).to(dev)
    x = x.reshape((n_clients, steps, bsz) + tuple(x.shape[2:]))
    y = y.reshape(n_clients, steps, bsz).long()

    def run(mode, k):
        """Both clients' params after ``k`` local steps under ``mode``
        (the engine's round program: global params closed over)."""
        if k == 0:
            return {n: p.expand((n_clients,) + p.shape)
                    for n, p in params.items()}
        mask = torch.ones((n_clients, k), device=dev)
        fn = lambda xb, yb, mb: local_train(params, xb, yb, mb)["params"]
        return client_map(fn, mode)(x[:, :k], y[:, :k], mask)

    def preacts(p, xb):
        """Every ReLU's input of one forward, in the model's order."""
        out = [torch.nn.functional.linear(
            xb.reshape(xb.shape[0], -1), p["embed.weight"], p["embed.bias"])]
        h = torch.relu(out[0])
        for layer in range(p["blocks_w"].shape[0]):
            out.append(h @ p["blocks_w"][layer] + p["blocks_b"][layer])
            h = torch.relu(out[-1])
        return torch.stack(out)

    def forwards(mode, p, xb):
        """``preacts`` of each client at its params, in ``mode``'s map
        (at step 0 the params are shared, as the round program's)."""
        if mode == "scan":
            return torch.stack([preacts({n: v[c] for n, v in p.items()},
                                        xb[c]) for c in range(n_clients)])
        if all(v.stride(0) == 0 for v in p.values()):
            shared = {n: v[0] for n, v in p.items()}
            return torch.func.vmap(lambda a: preacts(shared, a))(xb)
        return torch.func.vmap(preacts)(p, xb)

    smi = ""
    if opts.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    n_params = sum(v.numel() for v in params.values())
    record = {"card": smi, "hidden": cfg["model_dim"],
              "depth": cfg["model_layers"], "n_params": n_params,
              "batch_size": bsz, "clients": n_clients, "steps": []}
    with torch.no_grad():
        for s in range(steps):
            pv, ps = run("vmap", s), run("scan", s)
            av, as_ = forwards("vmap", pv, x[:, s]), forwards("scan", ps,
                                                              x[:, s])
            flip = (av > 0) != (as_ > 0)
            n_flip = int(flip.sum())
            near = torch.minimum(av.abs(), as_.abs())[flip]
            if not n_flip:
                near = torch.full((1,), float("nan"))
            agree = (av - as_).abs()[~flip]
            pv, ps = run("vmap", s + 1), run("scan", s + 1)
            err = max(float((pv[n] - ps[n]).abs().max()) for n in pv)
            rec = {"step": s + 1, "masks": flip.numel(),
                   "masks_differ": n_flip,
                   "min_abs_preact_flipped": float(near.min()),
                   "max_abs_preact_flipped": float(near.max()),
                   "max_preact_diff_agreeing": float(agree.max()),
                   "params_err_after": err}
            record["steps"].append(rec)
            print(f"[client_map_gap] step {s + 1}: before it {n_flip} of "
                  f"{flip.numel()} ReLU masks differ (|pre-activation| "
                  f"among them {rec['min_abs_preact_flipped']:.3e} to "
                  f"{rec['max_abs_preact_flipped']:.3e}; the agreeing masks' "
                  f"pre-activations differ by <= "
                  f"{rec['max_preact_diff_agreeing']:.3e}); params after it "
                  f"differ by {err:.3e} [{smi}]", flush=True)
    # the engine as phase 18 (a) runs it: its default vmapped map and its
    # clients one by one, from the same weights
    apis = {mode: _engine(torch, fedml_tpu_torch, dict(
        cfg, sp_client_mode=mode, device=opts.device), ds, n_out)
        for mode in ("vmap", "scan")}
    init = apis["scan"].state.global_params
    apis["vmap"].reset_params({n: v.clone() for n, v in init.items()})
    record["engine_rounds"] = []
    for r in range(opts.rounds):
        for api in apis.values():
            api.train_one_round(r)
        err = params_err(apis["vmap"].state.global_params,
                         apis["scan"].state.global_params)
        record["engine_rounds"].append(err)
        print(f"[client_map_gap] the sp engine, vmap vs scan: params after "
              f"round {r + 1} differ by {err:.3e} [{smi}]", flush=True)
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    with open(os.path.join(root, "chiprun_out", "client_map_gap.json"),
              "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
