"""Parity with reference ``core/alg_frame/params.py`` — an attribute bag used
to pass named tensors between hooks (e.g. SCAFFOLD control variates ride
alongside model params)."""

from __future__ import annotations


class Params:
    """Reference: ``python/fedml/core/alg_frame/params.py:8``."""

    KEY_MODEL_PARAMS = "model_params"

    def __init__(self, **kwargs):
        self.__dict__.update(kwargs)

    def add(self, name: str, value):
        setattr(self, name, value)
        return self

    def get(self, name: str, default=None):
        return getattr(self, name, default)

    def keys(self):
        return list(self.__dict__.keys())

    def __contains__(self, name):
        return name in self.__dict__

    def __getitem__(self, name):
        return self.__dict__[name]

    def __setitem__(self, name, value):
        self.__dict__[name] = value
