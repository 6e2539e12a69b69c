#!/usr/bin/env python3
"""Where a federated LoRA round of the PyTorch port spends its time on the
card: the ``chip_smoke.py`` slice (Llama-2-7B width, seq 1024, 4 clients ×
2 steps, batch 2), one warm-up round, then one round under
``torch.profiler``.  Prints the round's wall time, the device's busy and
idle share, and device time by kernel group, by kernel (the top 15) and
by flash-attention kernel (each of K1, K2 and K3); writes the
same as JSON to ``chiprun_out/round_profile.json``.

    python3 tools/torch_round_profile.py [--layers N]
"""

import argparse
import json
import os
import subprocess
import sys
import time

GROUPS = (("flash attention (K1-K3)", ("flash_fwd", "flash_bwd")),
          ("matmul (cuBLAS)", ("gemm", "cutlass", "sm90_xmma", "nvjet")),
          ("elementwise/reduce", ("elementwise", "reduce", "vectorized",
                                  "unrolled", "softmax", "index", "cat",
                                  "copy", "fill")))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32)
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from fedml_tpu_torch.llm.configurations import (
        build_fedllm, llama2_7b_round_arguments)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    api = build_fedllm(llama2_7b_round_arguments(opts.layers), device="cuda")
    api.train_one_round(0)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.time()
        m = api.train_one_round(1)
        torch.cuda.synchronize()
        wall = time.time() - t0
    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key] = {"us": dev_us, "count": ev.count}
    busy = sum(k["us"] for k in kernels.values()) / 1e6
    groups = {name: 0.0 for name, _ in GROUPS}
    groups["other"] = 0.0
    for key, rec in kernels.items():
        low = key.lower()
        for name, pats in GROUPS:
            if any(p in low for p in pats):
                groups[name] += rec["us"] / 1e6
                break
        else:
            groups["other"] += rec["us"] / 1e6
    by_time = sorted(kernels.items(), key=lambda kv: -kv[1]["us"])
    top = by_time[:15]
    flash = [(k, rec) for k, rec in by_time
             if any(p in k.lower() for p in GROUPS[0][1])]
    print(f"card: {smi}; depth {opts.layers}; round 1: {wall:.3f} s wall, "
          f"{m['steps']} client steps, loss {m['train_loss']:.4f}")
    print(f"device busy {busy:.3f} s ({100 * busy / wall:.1f}% of wall), "
          f"idle {100 * (1 - busy / wall):.1f}%")
    for name, sec in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {name:28s} {sec:8.3f} s  {100 * sec / wall:5.1f}% of wall")
    for title, rows in (("top kernels", top), ("flash attention", flash)):
        print(f"{title}:")
        for key, rec in rows:
            print(f"  {rec['us'] / 1e3:10.2f} ms  x{rec['count']:<6d} "
                  f"{key[:90]}")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "round_profile.json"), "w") as f:
        json.dump({"card": smi, "layers": opts.layers, "wall_s": wall,
                   "busy_s": busy, "groups_s": groups,
                   "top": [{"kernel": k, **v} for k, v in top],
                   "flash": [{"kernel": k, **v} for k, v in flash]}, f,
                  indent=1)


if __name__ == "__main__":
    main()
