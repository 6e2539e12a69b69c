"""fedml_tpu_torch — the PyTorch/CUDA port of ``fedml_tpu`` for one NVIDIA
H100.

Same module layout and names as the JAX package, so each module's
counterpart is found at the same path.  The ported slice is the federated
LoRA round of a Llama model (``llm/fedllm.py::FedLLMAPI``) with its
hand-written Hopper flash-attention kernels (``csrc/``, bound in
``ops/attention.py``).  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import logging
import random
from typing import Optional

import numpy as np

__version__ = "0.1.0"

from .arguments import Arguments, load_arguments  # noqa: E402


def init(args: Optional[Arguments] = None,
         should_init_logs: bool = True) -> Arguments:
    """Load default args if none are given and seed the host RNGs.  Device
    randomness uses explicit seeded generators (core/rng.py)."""
    import torch

    if args is None:
        args = load_arguments()
    seed = int(getattr(args, "random_seed", 0))
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if should_init_logs:
        logging.basicConfig(
            level=logging.INFO,
            format="[fedml_tpu_torch] %(asctime)s %(levelname)s %(name)s: "
                   "%(message)s")
    return args


from . import data  # noqa: E402

__all__ = ["init", "Arguments", "load_arguments", "data", "__version__"]
