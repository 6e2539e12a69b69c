#!/usr/bin/env python3
"""The port's mesh engine on N ranks of one host, held against the sp
engine on rank 0: one rank per card over NCCL, or over gloo with
``--device cpu``.

    python3 -m torch.distributed.run --nproc_per_node 4 \\
        tools/torch_mesh_ranks.py [--device cpu] [--out chiprun_out/mesh4.json]

Each rank runs, through the port's public classes:

- ``MeshFedAvgAPI`` on ``tests/test_update_sharding.py``'s ``lr`` config
  (16 clients, 8 a round, 3 rounds) for FedAvg, FedOpt (server Adam at
  ``server_lr`` 0.03, as in the CPU parity tests), SCAFFOLD, FedDyn,
  FedNova and Mime under both merge layouts: params,
  losses, and the gathered server state against the sp engine's run on
  rank 0 (the JAX tests' limits, atol 2e-5 + rtol 1e-4: the merge sums in
  another order across ranks); and at collective_precision bf16 and int8
  (scatter and replicated, FedAvg and SCAFFOLD) the losses against the
  fp32 mesh run within the JAX package's own quantized limits (bf16 2e-3,
  int8 1e-2, ``tests/test_collective_precision.py``);
- ``round_block`` 2 on the mesh (SCAFFOLD, scatter) ≡ its unfused rounds
  (on the card: the merge's NCCL calls inside the CUDA graph);
- ``MeshHierarchicalAPI`` (one group a rank) against the sp
  hierarchical engine, and ``MeshDecentralizedAPI`` (ring gossip, ghost
  rows by send/recv) against the sp engine's dense ``W x``;
- ``FedLLMAPI(mesh=make_mesh())`` (tiny f32 Llama, a cohort that does not
  divide over the ranks) against the single-device round, to the LoRA
  parity limit 1e-4 (``tests/test_torch_fedllm.py``: Adam turns the
  merge's summation order into adapter differences proportional to lr;
  4 gloo ranks read 1.1e-6 after 2 rounds);
- FedAvg on the FEMNIST CNN at ``chip_smoke.py``'s widths (100 clients,
  10 a round) under both layouts, seconds a round beside the sp engine's
  on one card: the lr checks above time a host-bound round, this one a
  round whose clients fill the card.  Round 0's loss is held to the sp
  engine's within ``CNN_LOSS_TOL``, and the params are reported, not
  held: each rank runs its clients at another vmap width (3 against 10),
  and 30 local steps of ReLU and max-pool amplify any last-bit
  difference, the merge's summation order included.  As a control the
  sp engine also runs round 0 with its clients one after another (a
  client map of width 1), which reads what the width alone does on the
  device (``--cnn-only`` runs this section alone);
- the teardown: every graph released, then ``core.mesh.shutdown_world``
  on every rank, which must return within ``--teardown-limit`` seconds.

``--teardown-check keep|release`` runs only ``round_block`` 2 on the mesh
(a CUDA graph that captured the merge's NCCL collectives) and the
teardown, with the block's graphs kept alive or released first: NCCL's
destroy waits for every graph that holds its communicator, so ``keep``
is expected to hang and is stopped at the limit (exit code 3).

Each check prints a line; rank 0 writes the numbers (seconds a round
beside the sp engine's included) to ``--out`` and exits non-zero if any
check failed.  The first line names the card and its power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

ALGS = ["FedAvg", "FedOpt", "SCAFFOLD", "FedDyn", "FedNova", "Mime"]
ATOL, RTOL = 2e-5, 1e-4
QUANT_LOSS_TOL = {"bf16": 2e-3, "int8": 1e-2}
#: round 0's loss on the FEMNIST CNN, mesh against sp: far below the
#: spread of two cohorts' losses, far above f32 noise
CNN_LOSS_TOL = 1e-3


def lr_cfg(**over):
    cfg = dict(dataset="synthetic", num_classes=10, input_shape=(28, 28, 1),
               train_size=1024, test_size=256, model="lr",
               client_num_in_total=16, client_num_per_round=8, comm_round=3,
               epochs=1, batch_size=16, learning_rate=0.1, random_seed=7,
               frequency_of_the_test=10 ** 9, partition_method="homo")
    cfg.update(over)
    if cfg.get("federated_optimizer") == "FedOpt":
        # server Adam's normalised step turns f32 summation-order noise
        # into steps of order server_lr (the CPU parity tests' setting)
        cfg.setdefault("server_lr", 0.03)
    return cfg


#: chip_smoke.py's SP_FEMNIST_CNN
FEMNIST_CNN = dict(dataset="femnist", model="cnn", client_num_in_total=100,
                   client_num_per_round=10, partition_method="hetero",
                   partition_alpha=0.5, batch_size=20, learning_rate=0.06,
                   comm_round=3, epochs=1, random_seed=0,
                   frequency_of_the_test=10 ** 9)


def teardown(rank, limit):
    """``shutdown_world`` on this rank, stopped with exit code 3 when it
    has not returned within ``limit`` seconds; returns its seconds."""
    from fedml_tpu_torch.core.mesh import shutdown_world

    def stuck():
        print(f"[rank {rank}] shutdown_world did not return within "
              f"{limit:.0f} s", flush=True)
        os._exit(3)

    timer = threading.Timer(limit, stuck)
    timer.daemon = True
    timer.start()
    t0 = time.time()
    shutdown_world()
    timer.cancel()
    return time.time() - t0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default="chiprun_out/mesh_ranks.json")
    ap.add_argument("--teardown-check", choices=("keep", "release"),
                    help="run only round_block on the mesh and the "
                         "teardown, the graphs kept or released first")
    ap.add_argument("--teardown-limit", type=float, default=60.0)
    ap.add_argument("--cnn-only", action="store_true",
                    help="run only the FEMNIST CNN section")
    opts = ap.parse_args()

    import numpy as np
    import torch
    import torch.distributed as dist
    import fedml_tpu_torch
    from fedml_tpu_torch import data, device as device_mod, model
    from fedml_tpu_torch.core.mesh import make_mesh
    from fedml_tpu_torch.llm.fedllm import FedLLMAPI
    from fedml_tpu_torch.simulation.mesh.decentralized_mesh import \
        MeshDecentralizedAPI
    from fedml_tpu_torch.simulation.mesh.engine import MeshFedAvgAPI
    from fedml_tpu_torch.simulation.mesh.hierarchical_mesh import \
        MeshHierarchicalAPI
    from fedml_tpu_torch.simulation.sp.decentralized import \
        DecentralizedFedAPI
    from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI
    from fedml_tpu_torch.simulation.sp.hierarchical_fl import \
        HierarchicalFedAvgAPI

    dev = device_mod.get_device(None, opts.device)
    mesh = make_mesh(device=dev)
    rank, world = mesh.rank, mesh.size
    if opts.device == "cuda" and world > torch.cuda.device_count():
        raise SystemExit(f"{world} ranks and {torch.cuda.device_count()} "
                         "cards: one card a rank")
    smi = "cpu"
    if opts.device == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[rank]
    out = {"world": world, "backend": str(dist.get_backend()),
           "card": smi, "checks": {}}
    bad = []

    def say(msg):
        if rank == 0:
            print(f"[mesh{world}] {msg}", flush=True)

    def build(cls, cfg, **kw):
        args = fedml_tpu_torch.load_arguments().update(**cfg)
        ds, od = data.load(args)
        return cls(args, dev, ds, model.create(args, od), **kw)

    def rounds(api, n):
        losses, secs = [], []
        for r in range(n):
            if opts.device == "cuda":
                torch.cuda.synchronize()
            t0 = time.time()
            losses.append(float(api.train_one_round(r)["train_loss"]))
            if opts.device == "cuda":
                torch.cuda.synchronize()
            secs.append(time.time() - t0)
        return losses, secs

    def err(a, b):
        """(max |a - b|, whether every element is within ATOL + RTOL·|b|)
        over the leaves of ``b``."""
        d = {k: torch.abs(a[k].cpu() - b[k].cpu()) for k in b}
        return (max(float(v.max()) for v in d.values()),
                all(bool((v <= ATOL + RTOL * torch.abs(b[k].cpu())).all())
                    for k, v in d.items()))

    def check(name, value, ok, extra=None):
        out["checks"][name] = dict(extra or {}, value=value, ok=bool(ok))
        say(f"{name}: {value:.3e} {'ok' if ok else 'FAILED'} [{smi}]")
        if not ok:
            bad.append(name)

    def finish():
        """Write the results, tear the group down, exit 1 on a failed
        check."""
        out["ok"] = not bad
        if rank == 0:
            os.makedirs(os.path.dirname(opts.out) or ".", exist_ok=True)
            with open(opts.out, "w") as fh:
                json.dump(out, fh, indent=1)
        out["teardown_s"] = teardown(rank, opts.teardown_limit)
        say(f"shutdown_world returned in {out['teardown_s']:.2f} s")
        if rank == 0:
            with open(opts.out, "w") as fh:
                json.dump(out, fh, indent=1)
            print(json.dumps({"ok": out["ok"], "failed": bad}), flush=True)
        if bad:
            sys.exit(1)

    def femnist_cnn():
        """FedAvg on the FEMNIST CNN: seconds a round where the clients
        fill the card."""
        args = fedml_tpu_torch.load_arguments().update(**FEMNIST_CNN)
        ds, od = data.load(args)
        cnn = model.create(args, od)
        sp = FedAvgAPI(args, dev, ds, cnn)
        sp_losses, sp_secs = rounds(sp, 3)
        # control: the sp engine with its clients one after another (a
        # client map of width 1, the mesh's is 3 a rank): what the width
        # alone does to round 0's loss on this device
        scan = FedAvgAPI(args, dev, ds, cnn, client_mode="scan")
        width_gap = abs(float(scan.train_one_round(0)["train_loss"])
                        - sp_losses[0])
        say(f"FEMNIST CNN round 0 loss, sp clients one by one vs vmapped: "
            f"{width_gap:.3e} (control) [{smi}]")
        out["checks"]["femnist_width_control"] = {"value": width_gap}
        del scan
        for lay in ("replicated", "scatter"):
            api = MeshFedAvgAPI(fedml_tpu_torch.load_arguments().update(
                update_sharding=lay, **FEMNIST_CNN), dev, ds, cnn)
            losses, secs = rounds(api, 3)
            api._stager.close()
            le = abs(losses[0] - sp_losses[0])
            pe = err(api.state.global_params, sp.state.global_params)[0]
            finite = all(np.isfinite(losses))
            check(f"FEMNIST CNN FedAvg/{lay}: round 0 loss vs sp", le,
                  le <= CNN_LOSS_TOL and finite,
                  {"losses": losses, "sp_losses": sp_losses,
                   "params_vs_sp_after_3_rounds": pe,
                   "s_per_round": secs[1:], "sp_s_per_round": sp_secs[1:]})
            say(f"FEMNIST CNN FedAvg/{lay}: {secs[1]:.4f} {secs[2]:.4f} s a "
                f"round, sp alone {sp_secs[1]:.4f} {sp_secs[2]:.4f}; "
                f"params vs sp after 3 rounds {pe:.2e} (reported) [{smi}]")
            del api
        del sp

    if opts.teardown_check:
        api = build(MeshFedAvgAPI, lr_cfg(
            federated_optimizer="SCAFFOLD", update_sharding="scatter",
            comm_round=2, round_block=2))
        api._train_fused()
        api._stager.close()
        captured = api._block_fn.captures
        if opts.teardown_check == "release":
            api._block_fn.release()
        say(f"round_block 2: {captured} graph(s) captured, "
            f"{opts.teardown_check} them; tearing down [{smi}]")
        secs = teardown(rank, opts.teardown_limit)
        say(f"shutdown_world returned in {secs:.2f} s")
        if rank == 0:
            print(json.dumps({"ok": True, "teardown_check":
                              opts.teardown_check, "graphs": captured,
                              "teardown_s": secs}), flush=True)
        return

    if opts.cnn_only:
        femnist_cnn()
        finish()
        return

    # the FedAvg family against the sp engine on rank 0
    for alg in ALGS:
        cfg = lr_cfg(federated_optimizer=alg)
        sp = build(FedAvgAPI, cfg)
        sp_losses, sp_secs = rounds(sp, 3)
        for lay in ("replicated", "scatter"):
            api = build(MeshFedAvgAPI, dict(cfg, update_sharding=lay))
            losses, secs = rounds(api, 3)
            api._stager.close()
            e, ok = err(api.state.global_params, sp.state.global_params)
            le = float(np.max(np.abs(np.subtract(losses, sp_losses))))
            check(f"{alg}/{lay} vs sp", max(e, le), ok and le <= ATOL,
                  {"s_per_round": secs[1:], "sp_s_per_round": sp_secs[1:]})
    # quantized collectives against the fp32 mesh
    for alg in ("FedAvg", "SCAFFOLD"):
        for lay in ("replicated", "scatter"):
            ref = None
            for prec in ("fp32", "bf16", "int8"):
                api = build(MeshFedAvgAPI, lr_cfg(
                    federated_optimizer=alg, update_sharding=lay,
                    collective_precision=prec, comm_round=4))
                losses, secs = rounds(api, 4)
                api._stager.close()
                if prec == "fp32":
                    ref = losses
                    continue
                e = float(np.max(np.abs(np.subtract(losses, ref))))
                check(f"{alg}/{lay}/{prec} losses vs fp32", e,
                      e <= QUANT_LOSS_TOL[prec], {"s_per_round": secs[1:]})
    # round_block on the mesh
    cfg = lr_cfg(federated_optimizer="SCAFFOLD", update_sharding="scatter",
                 comm_round=4)
    u = build(MeshFedAvgAPI, cfg)
    rounds(u, 4)
    f = build(MeshFedAvgAPI, dict(cfg, round_block=2))
    f._train_fused()
    u._stager.close()
    f._stager.close()
    us, fs = u.full_state(), f.full_state()
    e = max(err(fs.global_params, us.global_params)[0],
            float(torch.max(torch.abs(fs.c_server - us.c_server))))
    check("round_block 2 vs unfused (SCAFFOLD, scatter)", e, e <= 1e-6,
          {"graphs_captured": f._block_fn.captures})
    f._block_fn.release()
    del u, f, us, fs
    # the hierarchical mesh: one group a rank
    hcfg = dict(dataset="synthetic", num_classes=4, input_shape=(10,),
                train_size=640, test_size=96, model="lr",
                client_num_in_total=16, client_num_per_round=12,
                comm_round=3, epochs=1, batch_size=8, learning_rate=0.2,
                group_num=world, group_comm_round=2, random_seed=7,
                frequency_of_the_test=100)
    sp = build(HierarchicalFedAvgAPI, hcfg)
    rounds(sp, 3)
    api = build(MeshHierarchicalAPI, hcfg)
    rounds(api, 3)
    check("hierarchical vs sp",
          *err(api.state.global_params, sp.state.global_params))
    # the ring gossip against the dense W x
    rcfg = dict(hcfg, client_num_in_total=2 * world, comm_round=3,
                topology="symmetric", topology_neighbors=2,
                federated_optimizer="dsgd")
    if 2 * world >= 3:
        sp = build(DecentralizedFedAPI, rcfg)
        rounds(sp, 3)
        api = build(MeshDecentralizedAPI, rcfg)
        rounds(api, 3)
        check("ring gossip vs dense W x", *err(api.full_params(),
                                                sp.params))
    # FedLLMAPI over the client axis, a cohort that does not divide
    lcfg = dict(model="tiny_llama", dataset="shakespeare", seq_len=32,
                client_num_in_total=8, client_num_per_round=world + 1,
                comm_round=2, batch_size=2, learning_rate=1e-3,
                random_seed=9, llm_max_local_steps=2, lora_rank=4,
                partition_method="homo", train_size=64, test_size=4)
    args = fedml_tpu_torch.load_arguments().update(**lcfg)
    ds, _ = data.load(args)
    one = FedLLMAPI(args, ds, device=dev)
    many = FedLLMAPI(args, ds, device=dev, mesh=mesh)
    many.global_lora = {k: v.clone() for k, v in one.global_lora.items()}
    for r in range(2):
        one.train_one_round(r)
        many.train_one_round(r)
    e = err(many.global_lora, one.global_lora)[0]
    check("FedLLMAPI(mesh) vs single device", e, e <= 1e-4)
    del one, many

    femnist_cnn()

    finish()


if __name__ == "__main__":
    main()
