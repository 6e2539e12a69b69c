#!/usr/bin/env python3
"""``chip_smoke.py`` phase 22 alone: (a) serving's obs hooks on phase
14's engine (the Llama-2-7B-width model, built here at ``--serve-layers``
depth), hooks on beside off; (b) the text model at full width as 5 silos
through the attack + krum + global DP hook pipeline, K1–K3 counted
against the same run without the trust stack; (b-small) the narrow text
federation card vs CPU with the CPU's noise draws carried; (c) every
defense on the card against the CPU.  The CPU references come from the
phase's CPU process, started first.  Builds the kernels, prints the
card's name and power limit, and writes the phase's record to
``chiprun_out/trust_phase.json``.

    python3 tools/torch_trust_phase.py [--serve-layers N] [--keep-going]

``--keep-going`` prints a failed check and goes on to the next, then
exits 1: one call reads every check.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import chip_smoke

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--serve-layers", type=int,
                    default=chip_smoke.SERVE_LAYERS,
                    help="(a)'s model depth (widths are never cut)")
    ap.add_argument("--keep-going", action="store_true",
                    help="report every failed check, exit 1 at the end")
    opts = ap.parse_args()
    import torch

    import fedml_tpu_torch
    from fedml_tpu_torch.llm import model as lm
    from fedml_tpu_torch.ops import attention as att
    from fedml_tpu_torch.ops import cuda_build

    failed = []
    if opts.keep_going:
        def note(msg):
            print(f"chip_smoke: CHECK FAILED: {msg}", flush=True)
            failed.append(msg)
        chip_smoke.fail = note
    if not torch.cuda.is_available():
        sys.exit("phase 22 needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = chip_smoke.nvidia_smi()
    child = chip_smoke.cpu_process_start(22, "trust_cpu_reference")
    t0 = time.time()
    cuda_build.build()
    print(f"kernels built in {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(lm.LLAMA2_7B, n_layers=opts.serve_layers,
                              lora_rank=chip_smoke.SERVE_LORA_RANK,
                              attn_impl="blockwise")
    with torch.device(dev):
        model = lm.LlamaLM(cfg)
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
    serve = chip_smoke.serving_obs_phase(torch, fedml_tpu_torch, smi,
                                         {"model": model})
    del model
    torch.cuda.empty_cache()
    rec = chip_smoke.trust_phase(torch, fedml_tpu_torch, att, smi, child,
                                 serve)
    rec["wall_s"] = time.time() - t0
    rec["card"] = smi
    rec["failed"] = failed
    print(f"phase 22 in {rec['wall_s']:.1f} s [{smi}]", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "trust_phase.json"),
              "w") as fh:
        json.dump(rec, fh, indent=1, default=str)
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
