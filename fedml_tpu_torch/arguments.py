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
    # comm_args
    backend="sp",
    # sp engine: clients batched by torch.func.vmap ("vmap") or one after
    # another ("scan"); the training set lives on the device once and rounds
    # ship index tensors (device_data)
    sp_client_mode="vmap",
    device_data=True,
)


def load_arguments() -> Arguments:
    """Arguments holding the defaults."""
    return Arguments().update(**_DEFAULTS)
