"""Shared helpers of the port's parity tests of the other sp engines
(``test_torch_fednas_fedseg.py``, ``test_torch_fedgkt_fedgan.py``): run
an engine through ``fedml_tpu.run_simulation`` and through the port's, on
the CPU, from the JAX engine's initial weights (carried across by
``models/convert.py``), and the small datasets of
``tests/test_model_zoo_ext.py``."""

import jax
import numpy as np
import pytest

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.arguments import load_arguments as j_arguments
from fedml_tpu.data.federated_dataset import \
    FederatedDataset as JFederatedDataset
from fedml_tpu.models.base import FlaxModel

from fedml_tpu_torch.arguments import load_arguments as t_arguments
from fedml_tpu_torch.data.federated_dataset import \
    FederatedDataset as TFederatedDataset


#: the JAX engines' initial weights, by attribute
_START = ("params", "g_params", "d_params", "_init_e", "_init_h", "s_params")


def _jit_flax_init(mp):
    """flax's eager init of a conv net dispatches op by op (~20 s for the
    UNet); the same draws come out of one jitted call."""
    init = FlaxModel.init
    mp.setattr(FlaxModel, "init",
               lambda self, rng: jax.jit(lambda r: init(self, r))(rng))


def run_both(cfg, j_cls, t_cls, carry):
    """``run_simulation(backend="sp")`` of both packages on ``cfg`` (the
    port's on the CPU): ``(jax result, port result, jax engine, port
    engine)``.  ``carry(start, tapi)`` runs right after the port engine is
    built, ``start`` holding the JAX engine's initial weights by attribute
    (``params``, ``g_params``, ...)."""
    built = {}
    with pytest.MonkeyPatch.context() as mp:
        _jit_flax_init(mp)
        j_init, t_init = j_cls.__init__, t_cls.__init__

        def j_spy(self, *a, **kw):
            j_init(self, *a, **kw)
            built["j"] = self
            built["start"] = {k: jax.device_get(v)
                              for k, v in vars(self).items() if k in _START}

        def t_spy(self, *a, **kw):
            t_init(self, *a, **kw)
            built["t"] = self
            carry(built["start"], self)

        mp.setattr(j_cls, "__init__", j_spy)
        mp.setattr(t_cls, "__init__", t_spy)
        jout = fedml_tpu.run_simulation(backend="sp",
                                        args=j_arguments().update(**cfg))
        tout = fedml_tpu_torch.run_simulation(
            backend="sp", args=t_arguments().update(**cfg), device="cpu")
    return jout, tout, built["j"], built["t"]


def history_close(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert abs(g[k] - w[k]) <= tol, (k, g, w)


def datasets(kind, **kw):
    """``tests/test_model_zoo_ext.py``'s ``_seg_dataset``/``_img_dataset``
    as both packages' FederatedDataset."""
    if kind == "seg":
        n, hw, n_clients, n_classes, seed = (kw.get("n", 64), 16, 4, 3, 0)
        rng = np.random.default_rng(seed)
        y = rng.integers(0, n_classes, size=(n, hw, hw))
        x = (y[..., None] / n_classes + 0.1 * rng.standard_normal(
            (n, hw, hw, 1))).astype(np.float32)
        idxs = {c: np.arange(c, n, n_clients) for c in range(n_clients)}
        fields = dict(train_x=x[: n - 16], train_y=y[: n - 16],
                      test_x=x[n - 16:], test_y=y[n - 16:],
                      client_idxs={c: v[v < n - 16] for c, v in idxs.items()},
                      num_classes=n_classes)
    else:
        n, hw = kw.get("n", 96), kw.get("hw", 8)
        n_clients, n_classes = kw.get("n_clients", 4), 3
        rng = np.random.default_rng(0)
        y = rng.integers(0, n_classes, size=(n,))
        x = (y[:, None, None, None] * 0.5 + 0.1 * rng.standard_normal(
            (n, hw, hw, 1))).astype(np.float32)
        fields = dict(train_x=x[: n - 32], train_y=y[: n - 32],
                      test_x=x[n - 32:], test_y=y[n - 32:],
                      client_idxs={c: np.arange(c, n - 32, n_clients)
                                   for c in range(n_clients)},
                      num_classes=n_classes)
    return JFederatedDataset(**fields), TFederatedDataset(**fields)
