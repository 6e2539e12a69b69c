"""Configuration namespace (port of ``fedml_tpu.arguments``): one flat
namespace so code reads ``args.learning_rate`` etc.  Only the defaults the
ported slices read are filled in, with the JAX package's values; YAML and
command-line loading are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict


class Arguments:
    """Flat namespace of run settings."""

    def update(self, **kwargs):
        self.__dict__.update(kwargs)
        return self

    def get(self, key: str, default=None):
        return getattr(self, key, default)

    def __contains__(self, key):
        return hasattr(self, key)

    def __repr__(self):
        keys = ", ".join(sorted(self.__dict__))
        return f"Arguments({keys})"


_DEFAULTS: Dict[str, Any] = dict(
    # common_args
    training_type="simulation",
    random_seed=0,
    scenario="horizontal",
    # data_args.  data_cache_dir is empty: the JAX package's default points
    # under the user's home, and the port reads nothing outside the paths
    # it is given (an absent cache means the synthetic fallback either way)
    dataset="synthetic_mnist",
    data_cache_dir="",
    partition_method="hetero",
    partition_alpha=0.5,
    synthetic_noise=0.35,
    # model_args
    model="lr",
    # train_args
    federated_optimizer="FedAvg",
    client_num_in_total=1000,
    client_num_per_round=10,
    comm_round=200,
    epochs=1,
    batch_size=10,
    client_optimizer="sgd",
    learning_rate=0.03,
    momentum=0.0,
    weight_decay=0.001,
    clip_grad_norm=0.0,
    server_lr=1.0,
    # mixing weight of the async FedAvg engine (the JAX package's default;
    # its class default is 0.6)
    async_alpha=0.5,
    # validation_args
    frequency_of_the_test=5,
    # comm_args (run_id, rank and role are the JAX package's command-line
    # defaults; client_id_list "[]" is normalised by init() for cross-silo)
    backend="sp",
    run_id="0",
    rank=0,
    role="client",
    client_id_list="[]",
    # sp engine: clients batched by torch.func.vmap ("vmap") or one after
    # another ("scan"); the training set lives on the device once and rounds
    # ship index tensors (device_data)
    sp_client_mode="vmap",
    device_data=True,
    # the mesh engine (backend "mesh"): the client axis spans the process
    # group (-1); mesh_shape "c,m" is the 2-D layout, "c,s,m" the 3-D
    # pipeline layout (mesh_stage the knob); a data factor above 1, and a
    # seq factor on the simulation engine, are refused by name.
    # update_sharding: replicated | scatter | auto (scatter above one
    # shard); async_staging builds the next round's cohort on a worker
    # thread, staging_depth rounds ahead
    mesh_client=-1,
    mesh_stage=1,
    mesh_data=1,
    mesh_model=1,
    mesh_seq=1,
    mesh_shape=None,
    # microbatches per local SGD step on the 3-D pipeline layout: the batch
    # splits into this many equal microbatches flowing through the stage
    # ring (bubble fraction (s-1)/(microbatches+s-1)); must divide
    # batch_size
    microbatches=1,
    update_sharding="auto",
    async_staging=True,
    staging_depth=1,
    # quantized collectives: fp32 | bf16 | int8 | auto (bf16 above one
    # shard); quant_block is the int8 quantizer's per-scale chunk
    collective_precision="fp32",
    quant_block=256,
    # the obs plane (obs/): trace turns the global tracer on (trace_path:
    # the Chrome trace written at the end of train()); trace_device runs
    # the measured device-phase probe (obs/devicetime.py) once before the
    # rounds, trace_profile_dir wraps it in a torch.profiler capture
    trace=False,
    trace_path=None,
    trace_device=False,
    trace_profile_dir=None,
    # fedmon: health computes the per-client health lanes on the device
    # and runs the host anomaly/drift monitor over them; metrics_port
    # serves /metrics, /healthz and /debug/health on loopback (0 = an
    # ephemeral port); health_slo_path names the SLO rule YAML;
    # health_z / health_ewm_alpha / health_min_obs tune the detector
    # (0 = its default)
    health=False,
    health_slo_path=None,
    metrics_port=None,
    health_z=0.0,
    health_ewm_alpha=0.0,
    health_min_obs=0,
    # two-tier silo -> server aggregation (store/hierarchy.py): num_silos
    # > 1 selects HierarchicalSiloAPI; silo_slow_rank / silo_slow_s hold
    # one silo's round open (straggler injection in run_silo_federation)
    num_silos=0,
    silo_slow_rank=0,
    silo_slow_s=0.0,
    # worker-pool size of the multi-process buffered-async driver
    # (simulation/async_driver.py::run_async_federation)
    async_workers=0,
    # fedwire (core/wire.py): wire_precision off | fp32 | bf16 | int8 for
    # silo partials, async worker updates and state syncs; wire_block the
    # int8 scale chunk (0 = quant_block); wire_chunk_bytes > 0 streams
    # large messages as bounded frames; wire_overlap moves a partial's
    # encode and upload to a writer thread.  checkpoint_codec orbax |
    # wire: "wire" writes round checkpoints as wire-fp32 msgpack files
    # (the port's default format stands where the JAX package's orbax
    # does)
    wire_precision="off",
    wire_block=0,
    wire_chunk_bytes=0,
    wire_overlap=False,
    checkpoint_codec="orbax",
)


def load_arguments() -> Arguments:
    """Arguments holding the defaults."""
    return Arguments().update(**_DEFAULTS)


def validate_args(args) -> Arguments:
    """The JAX package's ``validate_args`` for what the port runs: the
    pipeline layout's gate (``simulation/mesh/pipeline.py``) and the
    fedwire flags.  Raises ``ValueError`` naming the flag; returns
    ``args``."""
    from .simulation.mesh.pipeline import validate_pipeline_args
    validate_pipeline_args(args)
    wp = str(getattr(args, "wire_precision", "off") or "off").lower()
    if wp not in ("off", "fp32", "bf16", "int8"):
        raise ValueError(
            f"unknown wire_precision {wp!r} — expected off | fp32 | bf16 "
            "| int8")
    cc = str(getattr(args, "checkpoint_codec", "orbax") or "orbax").lower()
    if cc not in ("orbax", "wire"):
        raise ValueError(
            f"unknown checkpoint_codec {cc!r} — expected orbax | wire")
    return args
