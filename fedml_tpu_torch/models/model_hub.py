"""Model factory (port of ``fedml_tpu.models.model_hub.create``) for the
models of the sp FedAvg path: ``lr``, ``mlp``, ``cnn``, ``cnn_web`` and
``cnn_cifar``.  Returns a :class:`TorchModel` whose module lives on the
``meta`` device (shapes only; parameters are passed at apply time)."""

from __future__ import annotations

import math
from typing import Tuple

import torch

from .base import TorchModel
from .cnn import CNNCifar, CNNDropOut, CNNWeb
from .linear import MLP, LogisticRegression

_IMG28 = (28, 28, 1)
_IMG32 = (32, 32, 3)
PORTED = ("lr", "logistic_regression", "mlp", "cnn", "cnn_web", "cnn_cifar")


def _img_shape(args) -> Tuple[int, ...]:
    explicit = getattr(args, "input_shape", None)
    if explicit:
        return tuple(explicit)
    ds = str(getattr(args, "dataset", "")).lower()
    if "cifar" in ds or "cinic" in ds:
        return _IMG32
    return _IMG28


def create(args, output_dim: int = 10) -> TorchModel:
    name = str(getattr(args, "model", "lr")).lower()
    ds = str(getattr(args, "dataset", "")).lower()
    if name not in PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (the port creates "
            f"{', '.join(PORTED)})")
    if name in ("lr", "logistic_regression") and (
            getattr(args, "task_type", "") == "tag_prediction"
            or ds == "stackoverflow_lr"):
        raise NotImplementedError(
            "lr for tag prediction (BCE over multi-hot tags) is not ported "
            "yet")
    shape = _IMG32 if name == "cnn_cifar" else _img_shape(args)
    with torch.device("meta"):
        if name in ("lr", "logistic_regression"):
            return TorchModel(LogisticRegression(math.prod(shape),
                                                 output_dim), shape)
        if name == "mlp":
            return TorchModel(MLP(math.prod(shape), 128, output_dim), shape)
        if name == "cnn":
            # the FEMNIST CNN has 62 outputs; digit datasets use 10
            only_digits = "femnist" not in ds and "emnist" not in ds
            out = output_dim if output_dim else (10 if only_digits else 62)
            return TorchModel(CNNDropOut(shape, out, only_digits), shape,
                              has_dropout=True)
        if name == "cnn_web":
            return TorchModel(CNNWeb(shape, output_dim), shape)
        return TorchModel(CNNCifar(shape, output_dim), shape)
