"""Configuration namespace (port of ``fedml_tpu.arguments``): one flat
namespace so code reads ``args.learning_rate`` etc.  Only the defaults the
ported slice reads are filled in; YAML and command-line loading are not
ported yet.
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
    # data_args (no data_cache_dir: the port generates its LM data)
    dataset="shakespeare",
    partition_method="hetero",
    partition_alpha=0.5,
    # model_args
    model="tiny_llama",
    # train_args
    federated_optimizer="FedAvg",
    client_num_in_total=1000,
    client_num_per_round=10,
    comm_round=200,
    epochs=1,
    batch_size=10,
    learning_rate=0.03,
    # validation_args
    frequency_of_the_test=5,
    # comm_args
    backend="sp",
)


def load_arguments() -> Arguments:
    """Arguments holding the defaults."""
    return Arguments().update(**_DEFAULTS)
