#!/usr/bin/env python3
"""``chip_smoke.py`` phase 19 alone (the cross-silo federation: (a) the
FEMNIST CNN on the card, each silo's first pass traced card vs CPU step by
step, (a') ``cnn_web`` and ``lr`` card vs CPU and ``lr`` vs the sp engine,
(b) the text transformer clean and under chaos, reliable delivery and
chunking with K1–K3 counted, (c) three processes over MQTT, started
first and run beside (a)–(b)), after building the kernels, with the
card's name and power limit; writes the phase's record to
``chiprun_out/cross_silo_phase.json``.

    python3 tools/torch_cross_silo_phase.py
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import torch

    import chip_smoke
    import fedml_tpu_torch
    from fedml_tpu_torch.ops import attention as att
    from fedml_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        chip_smoke.fail("phase 19 needs a CUDA device")
    smi = chip_smoke.nvidia_smi()
    t0 = time.time()
    cuda_build.build()
    print(f"kernels built in {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    rec = chip_smoke.cross_silo_phase(torch, fedml_tpu_torch, att, smi)
    rec["wall_s"] = time.time() - t0
    rec["card"] = smi
    print(f"phase 19 in {rec['wall_s']:.1f} s [{smi}]", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "cross_silo_phase.json"),
              "w") as fh:
        json.dump(rec, fh, indent=1, default=str)


if __name__ == "__main__":
    main()
