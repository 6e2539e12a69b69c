#!/usr/bin/env python3
"""Where a round of the PyTorch port's sp simulation spends its time on
the card: ``chip_smoke.py`` phase 5's configurations (a) ``lr`` at
``bench.py``'s shape and (b) the FEMNIST CNN, for each algorithm of
``--federated-optimizer``, each one warm round, then its host staging
(cohort sampling and the index tensor, host clock) and rounds under
``torch.profiler``.  Prints each round's wall time, the device's busy and
idle share, device time by kernel group, for SCAFFOLD/FedDyn the device
time of a round's client-table gather and scatter (CUDA events), and the top
kernels; writes the same as JSON to ``chiprun_out/sp_profile.json``.

    python3 tools/torch_sp_profile.py [--rounds N]
        [--configs lr_bench,femnist_cnn] [--federated-optimizer FedAvg,...]
"""

import argparse
import json
import os
import subprocess
import sys
import time

GROUPS = (("matmul (cuBLAS)", ("gemm", "cutlass", "sm90_xmma", "nvjet")),
          ("convolution (cuDNN)", ("conv", "cudnn", "implicit", "wgrad",
                                   "dgrad", "fprop")),
          ("pooling", ("pool",)),
          ("gather/index", ("index", "gather", "scatter")),
          ("elementwise/reduce", ("elementwise", "reduce", "vectorized",
                                  "unrolled", "softmax", "copy", "fill",
                                  "where", "cat")))


def profile(torch, api, rounds):
    api.train_one_round(0)
    torch.cuda.synchronize()
    t0 = time.time()
    for r in range(1, rounds + 1):
        api._stage_round_arrays(r)
    stage_s = (time.time() - t0) / rounds
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.time()
        for r in range(1, rounds + 1):
            api.train_one_round(r)
        torch.cuda.synchronize()
        wall = (time.time() - t0) / rounds
    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key] = {"us": dev_us / rounds,
                               "count": ev.count / rounds}
    busy = sum(k["us"] for k in kernels.values()) / 1e6
    groups = {name: 0.0 for name, _ in GROUPS}
    groups["other"] = 0.0
    for key, rec in kernels.items():
        low = key.lower()
        name = next((n for n, pats in GROUPS
                     if any(p in low for p in pats)), "other")
        groups[name] += rec["us"] / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1]["us"])[:12]
    rec = {"wall_s": wall, "busy_s": busy, "staging_s": stage_s,
           "launches": sum(k["count"] for k in kernels.values()),
           "groups_s": groups,
           "top": [{"kernel": k, **v} for k, v in top]}
    if api.client_table is not None:
        # one round's table gather and scatter, alone, on its cohorts
        cohorts = [api._client_sampling(r) for r in range(1, rounds + 1)]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for c in cohorts:
            api._scatter_c(c, api._gather_c(c))
        end.record()
        end.synchronize()
        rec["table_gather_scatter_s"] = start.elapsed_time(end) / 1e3 / rounds
    return rec


def report(name, rec, rounds, smi):
    wall, busy = rec["wall_s"], rec["busy_s"]
    print(f"{name} [{smi}]: {wall:.4f} s a round (mean of "
          f"{rounds}), host staging {rec['staging_s']:.4f} s of "
          f"it, {rec['launches']:.0f} kernel launches; device busy "
          f"{busy:.4f} s ({100 * busy / wall:.1f}%), idle "
          f"{100 * (1 - busy / wall):.1f}%")
    if "table_gather_scatter_s" in rec:
        print(f"  client table gather + scatter "
              f"{1e3 * rec['table_gather_scatter_s']:.3f} ms a round")
    for g, sec in sorted(rec["groups_s"].items(), key=lambda kv: -kv[1]):
        print(f"  {g:24s} {1e3 * sec:9.3f} ms  {100 * sec / wall:5.1f}% "
              "of wall")
    for k in rec["top"]:
        print(f"  {k['us'] / 1e3:9.3f} ms  x{k['count']:<7.0f} "
              f"{k['kernel'][:90]}")



def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3,
                    help="profiled rounds per configuration")
    ap.add_argument("--configs", default="lr_bench,femnist_cnn",
                    help="comma-separated: lr_bench, femnist_cnn")
    ap.add_argument("--federated-optimizer", default="FedAvg",
                    help="comma-separated algorithms, each profiled on "
                         "each configuration")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import fedml_tpu_torch
    from chip_smoke import SP_FEMNIST_CNN, SP_LR_BENCH, build_sp, sp_args

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    configs = {"lr_bench": SP_LR_BENCH, "femnist_cnn": SP_FEMNIST_CNN}
    out = {"card": smi}
    for alg in opts.federated_optimizer.split(","):
        for cname in opts.configs.split(","):
            name = f"{cname}/{alg}"
            api = build_sp(sp_args(fedml_tpu_torch, federated_optimizer=alg,
                                   **configs[cname]))
            rec = out[name] = profile(torch, api, opts.rounds)
            del api
            report(name, rec, opts.rounds, smi)
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    with open(os.path.join(root, "chiprun_out", "sp_profile.json"), "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
