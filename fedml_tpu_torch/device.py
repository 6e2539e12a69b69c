"""Device choice and f32 math policy (port of ``fedml_tpu.device``).

``get_device(args, device=None)`` returns the card unless the caller asks
for the CPU (``device="cpu"``, or ``args.device = "cpu"``): ``cuda:0`` for
a lone process, ``cuda:{LOCAL_RANK}`` for a rank of a process group
(``torchrun`` and ``simulation/mesh/launch.py`` set ``LOCAL_RANK``), so
the ranks of one host never share a card.  There is no fallback: with no
CUDA device the card path raises, so a run never lands on the CPU without
being asked.

It also sets the f32 math policy on the card: matmuls and convolutions run
in full f32.  PyTorch runs convolutions in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True), which would make the card's
CNN rounds drift from the CPU's by far more than f32 rounding.  And cuDNN
picks only deterministic convolution algorithms: its default
weight-gradient algorithms sum with atomics in a varying order, and a
CNN's ReLU and max-pool amplify that rounding chaotically, so two runs of
one seed drifted apart by ~3e-2 in 9 FEMNIST rounds on one H100
(``chip_smoke.py`` phase 7 (e)).  With it a seed gives the same run, and a
round replayed as a CUDA graph the eager round's numbers.
"""

from __future__ import annotations

import logging
import os

import torch

log = logging.getLogger(__name__)


def card_index() -> int:
    """The card this process runs on: ``LOCAL_RANK`` inside a process
    group, else 0."""
    return int(os.environ.get("LOCAL_RANK", "0") or 0)


def card_device() -> torch.device:
    return torch.device("cuda", card_index())


def get_device(args, device=None) -> torch.device:
    want = str(device or getattr(args, "device", None) or "cuda").lower()
    if want == "cpu":
        return torch.device("cpu")
    if not want.startswith("cuda"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {want!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run on the CPU")
    # process-wide: full f32 for cuBLAS and cuDNN, reproducible cuDNN sums
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dev = torch.device(want) if ":" in want else card_device()
    log.info("device %s (%s); f32 matmuls and convolutions in full f32, "
             "deterministic cuDNN", dev, torch.cuda.get_device_name(dev))
    return dev
