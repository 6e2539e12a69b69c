#!/usr/bin/env python3
"""Where the FEMNIST CNN's card and CPU runs part in ``chip_smoke.py``
phase 19 (a): one silo's round-0 local pass (silo 1's client of the
federation, its dropout keep-masks drawn on the host from the silo's
(round, client) generator) from the same weights on the card and on the
CPU, step by step, twice: with the masks, and with every mask kept.

Before each step, each run's forward on that step's batch at its own
params (``chip_smoke.forward_signs``): how many ReLU signs (after Conv_0,
Conv_1, Dense_0) and max-pool winners (after each conv) differ between
the two runs, and the smallest ``|pre-activation|`` among the differing
ReLUs; after the step, the two runs' largest params difference.  Writes
``chiprun_out/cross_silo_gap.json``.

    python3 tools/torch_cross_silo_gap.py [--device cuda]
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    opts = ap.parse_args()

    import torch
    import torch.nn.functional as F

    import chip_smoke
    import fedml_tpu_torch
    from fedml_tpu_torch import data, model
    from fedml_tpu_torch.core import rng as rng_util
    from fedml_tpu_torch.device import get_device
    from fedml_tpu_torch.ml.trainer.local_trainer import (LocalTrainer,
                                                          ServerCtx)

    args = chip_smoke.xs_args(fedml_tpu_torch, chip_smoke.XS_FEMNIST, 1,
                              "gap")
    dev = get_device(args, opts.device)
    ds, n_out = data.load(args)
    m = model.create(args, n_out)
    tr = LocalTrainer(m, args)
    seed, bs = int(args.random_seed), int(args.batch_size)
    init = m.init(rng_util.purpose_key(rng_util.root_key(seed), "init"))
    client = int(rng_util.sample_clients(seed, 0, args.client_num_in_total,
                                         2)[0])
    xb, yb = ds.client_batches(client, bs, seed, 0, 1)
    masks = m.dropout_masks(rng_util.client_key(rng_util.root_key(seed), 0,
                                                client), (len(xb), bs))
    smi = chip_smoke.nvidia_smi() if dev.type == "cuda" else "cpu"
    out = {"card": smi, "client": client, "steps": len(xb), "modes": {}}
    for mode, drop in (("dropout", masks),
                       ("masks_kept", tuple(torch.ones_like(mk)
                                            for mk in masks))):
        runs = {}
        for d in (dev, torch.device("cpu")):
            p = {k: v.to(d) for k, v in init.items()}
            zero = torch.zeros((), device=d)
            runs[d.type] = {"carry": (p, tr.tx.init(p), None, None, zero,
                                      zero), "ctx": ServerCtx(p)}
        rows = []
        for s in range(len(xb)):
            signs = {}
            for name, r in runs.items():
                d = r["carry"][0]["Conv_0.bias"].device
                x = torch.as_tensor(xb[s], device=d)
                keep = tuple(mk[s].to(d) for mk in drop)
                with torch.no_grad():
                    signs[name] = chip_smoke.forward_signs(
                        torch, F, r["carry"][0], x, keep)
            (za, pa), (zb, pb) = signs[dev.type], signs["cpu"]
            row = {"step": s + 1}
            for k in za:
                a, b = za[k].cpu(), zb[k]
                flip = (a > 0) != (b > 0)
                row[k] = int(flip.sum())
                if row[k]:
                    row[k + "_min_abs"] = float(torch.minimum(
                        a.abs(), b.abs())[flip].min())
            for k in pa:
                row[k] = int((pa[k].cpu() != pb[k]).sum())
            for name, r in runs.items():
                d = r["carry"][0]["Conv_0.bias"].device
                r["carry"] = tr.train_step(
                    r["carry"], torch.as_tensor(xb[s], device=d),
                    torch.as_tensor(yb[s], device=d),
                    torch.ones((), device=d),
                    tuple(mk[s].to(d) for mk in drop), r["ctx"])
            a, b = runs[dev.type]["carry"][0], runs["cpu"]["carry"][0]
            row["params_gap"] = max((a[k].cpu() - b[k]).abs().max().item()
                                    for k in b)
            rows.append(row)
            print(mode, row, flush=True)
        out["modes"][mode] = rows
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "cross_silo_gap.json"),
              "w") as fh:
        json.dump(out, fh, indent=1)


if __name__ == "__main__":
    main()
