"""Defense zoo factory (port of ``fedml_tpu.core.security.defense``).

Every defense runs on the stacked ``(C, D)`` client matrix on the device of
the updates (``common.py``); none launches a kernel of its own."""

from __future__ import annotations

_REGISTRY = {}


def register(name):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls
    return deco


def registered_names():
    """Every registered defense name, sorted."""
    _load()
    return sorted(_REGISTRY)


def _load():
    # each module registers its defenses on import
    from . import clipping, outlier, reweighting  # noqa: F401
    from . import robust_aggregation, soteria_defense  # noqa: F401


def create_defender(defense_type: str, args):
    t = defense_type.strip().lower()
    _load()
    if t not in _REGISTRY:
        raise ValueError(f"unknown defense_type {defense_type!r}; have "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[t](args)
