#!/usr/bin/env python3
"""What the tensor-parallel code path costs at a model factor of 1 on one
card: the ``chip_smoke.py`` slice (Llama-2-7B width, seq 1024, 4 clients
× 2 steps, batch 2) built without a mesh and with ``make_mesh2d("1,1")``
(the same weights; the collectives run on a model group of one rank),
their rounds timed in turns (plain, TP, TP, plain), then one round of each
under ``torch.profiler``: wall time, device busy time, and the
collectives' host calls and host time.  Writes the numbers to
``chiprun_out/tp_overhead.json``.

    python3 tools/torch_tp_overhead.py [--layers N]
"""

import argparse
import json
import os
import subprocess
import sys
import time


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32)
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from fedml_tpu_torch.core.mesh import make_mesh2d, shutdown_world
    from fedml_tpu_torch.llm.configurations import (
        build_fedllm, llama2_7b_round_arguments)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    mesh = make_mesh2d("1,1")
    apis = {name: build_fedllm(llama2_7b_round_arguments(opts.layers),
                               device="cuda", mesh=m)
            for name, m in (("plain", None), ("tp", mesh))}

    def one_round(api, r):
        torch.cuda.synchronize()
        t0 = time.time()
        api.train_one_round(r)
        torch.cuda.synchronize()
        return time.time() - t0

    for api in apis.values():                 # warm-up
        one_round(api, 0)
    turns = {"plain": [], "tp": []}
    for name in ("plain", "tp", "tp", "plain"):
        turns[name].append(one_round(apis[name], 1))
    out = {"card": smi, "layers": opts.layers, "s_per_round": turns}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for name, api in apis.items():
        with torch.profiler.profile(activities=acts) as prof:
            wall = one_round(api, 1)
        busy, comm_calls, comm_host_us, comm_dev_us = 0.0, 0, 0.0, 0.0
        for ev in prof.key_averages():
            dev = getattr(ev, "self_device_time_total", 0) or 0
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                busy += dev
                if "nccl" in ev.key.lower():
                    comm_dev_us += dev
            elif "allreduce" in ev.key.lower().replace("_", ""):
                comm_calls += ev.count
                comm_host_us += ev.cpu_time_total
        out[name] = {"wall_s": wall, "device_busy_s": busy / 1e6,
                     "collective_calls": comm_calls,
                     "collective_host_s": comm_host_us / 1e6,
                     "nccl_device_s": comm_dev_us / 1e6}
        print(f"[tp_overhead] {name}: round {wall:.3f} s, device busy "
              f"{busy / 1e6:.3f} s, {comm_calls} all-reduce calls taking "
              f"{comm_host_us / 1e6:.3f} s of host time and "
              f"{comm_dev_us / 1e6:.4f} s of device time [{smi}]",
              flush=True)
    print(f"[tp_overhead] rounds in turns (plain, tp, tp, plain): plain "
          f"{turns['plain']}, tp {turns['tp']} s [{smi}]", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/tp_overhead.json", "w") as fh:
        json.dump(out, fh, indent=1)
    del apis
    shutdown_world()


if __name__ == "__main__":
    main()
