"""fedml_tpu_torch — the PyTorch/CUDA port of ``fedml_tpu`` for one NVIDIA
H100.

Same module layout and names as the JAX package, so each module's
counterpart is found at the same path.  Ported so far:

- the single-process simulation, ``run_simulation(backend="sp",
  args=...)``: ``FedAvgAPI`` and the algorithm zoo on the sp model zoo,
  the hierarchical, async and decentralized engines, and FedNAS, FedSeg,
  FedGKT and FedGAN (``simulation/sp/``);
- the mesh engine, ``run_simulation(backend="mesh")`` ("MPI" and
  "NCCL" too): clients sharded over the ranks of a ``torch.distributed``
  process group, NCCL on the card and gloo on the CPU (``simulation/
  mesh/``), a world of 1 unless the caller starts more ranks; the 2-D
  ``client × model`` and 3-D ``client × stage × model`` (pipeline)
  layouts, and the client-state plane;
- split learning, vertical FL, TurboAggregate and the centralized
  trainer, built as classes (``simulation/sp/{split_nn,vertical_fl,
  turboaggregate}.py``, ``simulation/centralized_trainer.py``);
- the federated LoRA round of a Llama model (``llm/fedllm.py::FedLLMAPI``)
  with its hand-written Hopper flash-attention kernels (``csrc/``, bound in
  ``ops/attention.py``);
- serving (``serving/``): KV-cached ``generate`` (dense, int8 or paged
  cache) with the prefix caches, the continuous-batching engine with
  chunked prefill, the multi-tenant adapter bank and the OpenAI-compatible
  server;
- cross-silo federation, ``run_cross_silo_server(args=...)`` and
  ``run_cross_silo_client(args=...)`` (or ``FedMLRunner`` with
  ``training_type="cross_silo"`` and ``role`` ``"server"``/``"client"``):
  one server and N silos exchanging messages over the ``local``,
  ``filestore`` or ``MQTT_S3`` backend, with chaos injection, reliable
  delivery and chunked frames stacked on it (``cross_silo/``,
  ``core/distributed/``), each silo training through ``LocalTrainer``
  (the text transformer's attention through the kernels).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
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
    """Load default args if none are given, check them
    (``arguments.validate_args``: the flags that cannot run together
    raise ``ValueError`` here), seed the host RNGs and, for a cross-silo
    run, normalise ``client_id_list`` (``[1 .. client_num_in_total]`` when
    empty).  Device randomness
    uses explicit seeded generators (core/rng.py)."""
    import torch

    from .arguments import validate_args

    if args is None:
        args = load_arguments()
    validate_args(args)
    seed = int(getattr(args, "random_seed", 0))
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if should_init_logs:
        logging.basicConfig(
            level=logging.INFO,
            format="[fedml_tpu_torch] %(asctime)s %(levelname)s %(name)s: "
                   "%(message)s")
    if str(getattr(args, "training_type", "simulation")) == "cross_silo":
        _update_client_id_list(args)
    return args


def run_simulation(backend: str = "sp", args: Optional[Arguments] = None,
                   client_trainer=None, server_aggregator=None,
                   device: Optional[str] = None):
    """Load the dataset and model that ``args`` names and run the simulation
    ``backend`` (port of ``fedml_tpu.run_simulation``): ``"sp"``, or
    ``"mesh"`` / ``"MPI"`` / ``"NCCL"`` for the mesh engine over the
    process group (made as a world of 1 when the caller has none).  Runs
    on the card unless ``device="cpu"`` (or ``args.device``) asks for the
    CPU.  Returns what the engine's ``train()`` returns: the
    final global params for FedAvg and the zoo, a dict with the history
    for FedNAS, FedSeg, FedGKT and FedGAN."""
    if args is None:
        args = init()
    args.training_type = "simulation"
    args.backend = backend
    from . import data as data_mod
    from . import device as device_mod
    from . import model as model_mod
    from .runner import FedMLRunner

    dev = device_mod.get_device(args, device)
    dataset, output_dim = data_mod.load(args)
    model = model_mod.create(args, output_dim)
    return FedMLRunner(args, dev, dataset, model, client_trainer,
                       server_aggregator).run()


def _update_client_id_list(args):
    """Normalise ``client_id_list`` for a cross-silo run so the server
    knows its expected client set (as ``fedml_tpu.init`` does)."""
    n = int(getattr(args, "client_num_in_total", 0) or 0)
    cur = getattr(args, "client_id_list", None)
    if not cur or cur in ("[]", "None"):
        args.client_id_list = list(range(1, n + 1))
    elif isinstance(cur, str):
        import json
        try:
            args.client_id_list = json.loads(cur)
        except json.JSONDecodeError:
            args.client_id_list = list(range(1, n + 1))


def _run_cross_silo(role: str, args=None, client_trainer=None,
                    server_aggregator=None, device=None):
    if args is None:
        args = init(load_arguments().update(training_type="cross_silo"))
    args.training_type = "cross_silo"
    args.role = role
    args.scenario = getattr(args, "scenario", "horizontal") or "horizontal"
    from . import data as data_mod
    from . import device as device_mod
    from . import model as model_mod
    from .runner import FedMLRunner

    dev = device_mod.get_device(args, device)
    dataset, output_dim = data_mod.load(args)
    model = model_mod.create(args, output_dim)
    return FedMLRunner(args, dev, dataset, model, client_trainer,
                       server_aggregator).run()


def run_cross_silo_server(args: Optional[Arguments] = None,
                          server_aggregator=None,
                          device: Optional[str] = None):
    """Run this process's cross-silo server (rank 0) until the last round
    (port of ``fedml_tpu.run_cross_silo_server``); returns the final
    global params.  On the card unless ``device="cpu"`` (or
    ``args.device``) asks for the CPU."""
    return _run_cross_silo("server", args, None, server_aggregator, device)


def run_cross_silo_client(args: Optional[Arguments] = None,
                          client_trainer=None,
                          device: Optional[str] = None):
    """Run this process's cross-silo client (silo ``args.rank``) until the
    server's finish (port of ``fedml_tpu.run_cross_silo_client``)."""
    return _run_cross_silo("client", args, client_trainer, None, device)


from . import data  # noqa: E402

__all__ = ["init", "run_simulation", "run_cross_silo_server",
           "run_cross_silo_client", "Arguments", "load_arguments", "data",
           "__version__"]
