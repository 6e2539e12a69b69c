"""Model factory (port of ``fedml_tpu.models.model_hub.create``) for the
models of the sp FedAvg path: ``lr`` (classification, or tag prediction on
``stackoverflow_lr``), ``mlp``, the CNNs (``cnn``, ``cnn_web``,
``cnn_cifar``), the GroupNorm ResNets (``resnet18_gn`` and its alias
``resnet18``, the width variants ``resnet18_gn_w<k>``,
``resnet20``/``resnet20_mnn``, ``resnet56``), the GroupNorm VGGs (``vgg``,
``vgg11``, ``vgg13``, ``vgg16``, ``vgg19``), ``mobilenet``/``mobilenet_v3``,
``efficientnet``, the GCN (``gcn``, ``graph``, ``fedgraphnn``), the LSTM
language models (``rnn``/``rnn_fedavg``/``rnn_shakespeare`` and
``rnn_stackoverflow``/``rnn_nwp``, task ``"lm"``), the FedNLP text
transformer (``text_transformer``, ``transformer_cls``, ``distilbert``,
``bert``), the DARTS supernet of FedNAS (``darts``, ``darts_search``) and
the segmentation UNet of FedSeg (``unet``, ``unet_small``, ``deeplab``,
task ``"segmentation"``), the layer-stacked ``pipe_mlp`` of the pipeline
layout (``model_dim`` 64, ``model_layers`` 4 by default) and the causal LM (``transformer``, ``gpt``,
``llama``, ``tiny_llama``: ``llm/model.py::build_causal_lm``, task
``"lm"``).  Returns a :class:`TorchModel` whose module lives
on the ``meta`` device (shapes only; parameters are passed at apply time).
Every other name of the JAX hub raises ``NotImplementedError`` naming
itself; an unknown ``vgg*`` name raises ``ValueError`` as in the JAX hub."""

from __future__ import annotations

import math
from typing import Tuple

import torch

from .base import TorchModel
from .cnn import CNNCifar, CNNDropOut, CNNWeb
from .darts import DARTSNetwork
from .efficientnet import EfficientNetLite
from .gcn import GCNPacked
from .linear import MLP, LogisticRegression
from .mobilenet import MobileNetV3Small
from .resnet import resnet18_gn, resnet20, resnet56
from .rnn import RNNOriginalFedAvg, RNNStackOverflow
from .text_transformer import TextTransformerClassifier
from .unet import UNetSmall
from .vgg import vgg

_IMG28 = (28, 28, 1)
_IMG32 = (32, 32, 3)
TEXT_NAMES = ("distilbert", "bert", "transformer_cls", "text_transformer")
RNN_NAMES = ("rnn", "rnn_fedavg", "rnn_shakespeare")
RNN_NWP_NAMES = ("rnn_stackoverflow", "rnn_nwp")
VGG_DEPTHS = {"vgg": 11, "vgg11": 11, "vgg13": 13, "vgg16": 16, "vgg19": 19}
DARTS_NAMES = ("darts", "darts_search")
UNET_NAMES = ("unet", "unet_small", "deeplab")
CAUSAL_LM_NAMES = ("transformer", "gpt", "llama", "tiny_llama")
PORTED = ("lr", "logistic_regression", "mlp", "cnn", "cnn_web", "cnn_cifar",
          "resnet18", "resnet18_gn", "resnet18_gn_w<k>", "resnet56",
          "resnet20", "resnet20_mnn", "mobilenet", "mobilenet_v3",
          "efficientnet", "gcn", "graph", "fedgraphnn", "pipe_mlp") + tuple(
              VGG_DEPTHS) + RNN_NAMES + RNN_NWP_NAMES + TEXT_NAMES + \
    DARTS_NAMES + UNET_NAMES + CAUSAL_LM_NAMES


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
    if name.startswith("vgg") and name not in VGG_DEPTHS:
        raise ValueError(f"unknown model {name!r}; vgg variants: "
                         f"{sorted(VGG_DEPTHS)}")
    if name not in PORTED and not name.startswith("resnet18_gn_w"):
        raise NotImplementedError(
            f"model {name!r} is not ported yet (the port creates "
            f"{', '.join(PORTED)})")
    if name == "pipe_mlp":
        from .pipe_mlp import pipe_mlp
        return pipe_mlp(hidden=int(getattr(args, "model_dim", 64) or 64),
                        depth=int(getattr(args, "model_layers", 4) or 4),
                        output_dim=output_dim, input_shape=_img_shape(args))
    if name in CAUSAL_LM_NAMES:
        from ..llm.model import build_causal_lm
        return build_causal_lm(args, output_dim)
    if name in TEXT_NAMES:
        seq_len = int(getattr(args, "seq_len", 128))
        with torch.device("meta"):
            m = TextTransformerClassifier(
                vocab_size=int(getattr(args, "vocab_size", 30000)),
                num_classes=output_dim,
                dim=int(getattr(args, "model_dim", 256)),
                n_layers=int(getattr(args, "model_layers", 4)),
                n_heads=int(getattr(args, "model_heads", 8)),
                ffn_dim=int(getattr(args, "model_ffn_dim", 512)),
                max_len=max(seq_len, 16))
        return TorchModel(m, (seq_len,), input_dtype=torch.int32)
    if name in RNN_NAMES + RNN_NWP_NAMES:
        fedavg = name in RNN_NAMES
        seq = int(getattr(args, "seq_len", 80 if fedavg else 20))
        with torch.device("meta"):
            m = (RNNOriginalFedAvg(output_dim or 90) if fedavg
                 else RNNStackOverflow(output_dim or 10004))
        return TorchModel(m, (seq,), task="lm", input_dtype=torch.int32)
    if name in ("gcn", "graph", "fedgraphnn"):
        # input: the (N, N + F + 1) dense pack [Â | node feats | mask]
        n_nodes = int(getattr(args, "max_nodes", 32))
        feat = int(getattr(args, "node_feature_dim", 16))
        with torch.device("meta"):
            m = GCNPacked(output_dim, n_nodes, feat,
                          hidden=int(getattr(args, "model_dim", 64)),
                          n_layers=int(getattr(args, "model_layers", 2)))
        return TorchModel(m, (n_nodes, n_nodes + feat + 1))
    if name.startswith("resnet") or name in ("mobilenet", "mobilenet_v3",
                                             "efficientnet"):
        with torch.device("meta"):
            if name.startswith("resnet18"):
                # resnet18_gn_w<k>: the 2-2-2-2 architecture at width k
                m = resnet18_gn(output_dim, int(name.split("_w", 1)[1])
                                if "_gn_w" in name else 64)
            elif name == "resnet56":
                m = resnet56(output_dim)
            elif name.startswith("resnet"):
                m = resnet20(output_dim)
            elif name == "efficientnet":
                m = EfficientNetLite(output_dim)
            else:
                m = MobileNetV3Small(output_dim)
        return TorchModel(m, _IMG32)
    shape = _IMG32 if name == "cnn_cifar" else _img_shape(args)
    with torch.device("meta"):
        if name in DARTS_NAMES:
            return TorchModel(DARTSNetwork(output_dim,
                                           in_channels=shape[-1]), shape)
        if name in UNET_NAMES:
            return TorchModel(UNetSmall(output_dim, in_channels=shape[-1]),
                              shape, task="segmentation")
        if name in ("lr", "logistic_regression"):
            # multi-label tag prediction (BCE over multi-hot tags): the data
            # loader sets task_type; the dataset name covers a model built
            # before the data
            tagpred = (getattr(args, "task_type", "") == "tag_prediction"
                       or ds == "stackoverflow_lr")
            return TorchModel(LogisticRegression(math.prod(shape),
                                                 output_dim), shape,
                              task="tag_prediction" if tagpred
                              else "classification")
        if name in VGG_DEPTHS:
            channels = shape[-1] if len(shape) == 3 else 1
            return TorchModel(vgg(VGG_DEPTHS[name], output_dim, channels),
                              shape)
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
