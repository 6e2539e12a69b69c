#!/usr/bin/env python3
"""``chip_smoke.py`` phase 23 alone: the trust stack's second half on the
card — (c) SecAgg and LightSecAgg over 3 text silos at full width, (a)
CKKS FedAvg of their params with the ring on the card (one silo's
ciphertext held bitwise against the phase's CPU process, the card's draws
carried), (b) exact MR-Shapley contribution of 4 text silos, one
attacked, with GTG and LOO on the same list, (b-small) the narrow text
model's contribution run card vs CPU.  Builds the kernels, prints the
card's name and power limit, and writes the phase's record to
``chiprun_out/trust2_phase.json``.

    python3 tools/torch_trust2_phase.py [--keep-going]

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
    import chip_smoke

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keep-going", action="store_true",
                    help="report every failed check, exit 1 at the end")
    opts = ap.parse_args()
    import torch

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
        sys.exit("phase 23 needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = chip_smoke.nvidia_smi()
    child = chip_smoke.cpu_process_start(23, "trust2_cpu_reference")
    t0 = time.time()
    cuda_build.build()
    print(f"kernels built in {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    rec = chip_smoke.trust2_phase(torch, fedml_tpu_torch, att, smi, child)
    rec["wall_s"] = time.time() - t0
    rec["card"] = smi
    rec["failed"] = failed
    print(f"phase 23 in {rec['wall_s']:.1f} s [{smi}]", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "trust2_phase.json"),
              "w") as fh:
        json.dump(rec, fh, indent=1, default=str)
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
