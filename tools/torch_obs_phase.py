#!/usr/bin/env python3
"""``chip_smoke.py`` phase 21 alone (the obs plane: (a) the fused FEMNIST
CNN with ``trace``/``health``/``metrics_port`` on beside off, (b) the
label-flip runs on sp, fused and FedBuff, card vs CPU, (c) the
``trace_device`` probe on the text model with K1–K3 counted, (d) the
probe's event timer against ``graph_ms``), after building the kernels,
with the card's name and power limit; writes the phase's record to
``chiprun_out/obs_phase.json``.

    python3 tools/torch_obs_phase.py [--keep-going]

``--keep-going`` prints a failed check and goes on to the next, then
exits 1: one call reads every check.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keep-going", action="store_true",
                    help="report every failed check, exit 1 at the end")
    opts = ap.parse_args()
    import torch

    import chip_smoke
    import fedml_tpu_torch
    from fedml_tpu_torch.ops import attention as att
    from fedml_tpu_torch.ops import cuda_build

    failed = []
    if opts.keep_going:
        def note(msg):
            print(f"chip_smoke: CHECK FAILED: {msg}", flush=True)
            failed.append(msg)
        chip_smoke.fail = note
    if not torch.cuda.is_available():
        sys.exit("phase 21 needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = chip_smoke.nvidia_smi()
    t0 = time.time()
    cuda_build.build()
    print(f"kernels built in {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    rec = chip_smoke.obs_phase(torch, fedml_tpu_torch, att, smi)
    rec["wall_s"] = time.time() - t0
    rec["card"] = smi
    rec["failed"] = failed
    print(f"phase 21 in {rec['wall_s']:.1f} s [{smi}]", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "obs_phase.json"),
              "w") as fh:
        json.dump(rec, fh, indent=1, default=str)
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
