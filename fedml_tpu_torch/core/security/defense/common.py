"""Shared defense machinery (port of
``fedml_tpu.core.security.defense.common``).

The client list is stacked once into a ``(C, D)`` f32 matrix on the
device of the updates (f64 when the params are float64: a float64 run is
the rounding witness of the f32 one), so pairwise distances, medians and
norms are one tensor operation each.

A row is the JAX package's row element for element: the leaves go in the
JAX package's leaf order (its flax paths' ``tree_flatten`` order), each in
flax's layout (a ``Dense`` kernel ``(in, out)``).  The port's params keep
PyTorch's names and layouts, so the order comes from the model:
:func:`use_layout` registers a model's
:meth:`~fedml_tpu_torch.models.base.TorchModel.flat_layout` (the
aggregators and trainers of the hook pipeline do it when they are built),
and a params dict with exactly that model's names flattens through it.
Any other dict (a hand-built ``{"w": ...}``) flattens its keys sorted, as
``tree_flatten`` orders a flat dict.  :func:`unstack_to_list` and
:func:`tree_unflatten_1d` give back each leaf in the port's layout and
dtype.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, FrozenSet, List, Sequence, Tuple

import torch

from ... import noise
from ...flatmodel import FlatSpec, _canon_shape, _from_canon, _to_canon
from ...tree import weighted_average

_LAYOUTS: Dict[FrozenSet[str], Tuple[Tuple[str, str], ...]] = {}
_LOCK = threading.Lock()


def use_layout(model_or_layout) -> None:
    """Register the JAX leaf order of a model's params (a ``TorchModel``,
    or its ``flat_layout()`` pairs); a model without one is skipped."""
    layout = model_or_layout
    if hasattr(model_or_layout, "flat_layout"):
        layout = model_or_layout.flat_layout()
    elif not isinstance(model_or_layout, (list, tuple)):
        return
    layout = tuple((str(n), str(k)) for n, k in layout)
    with _LOCK:
        _LAYOUTS[frozenset(n for n, _ in layout)] = layout


def layout_of(tree) -> Tuple[Tuple[str, str], ...]:
    """``(name, kind)`` of every leaf of ``tree`` in the JAX leaf order."""
    with _LOCK:
        layout = _LAYOUTS.get(frozenset(tree))
    if layout is not None:
        return layout
    return tuple((k, "param") for k in sorted(tree))


def tree_flatten_1d(tree) -> torch.Tensor:
    """``tree`` as one f32 vector (f64 for a float64 tree) in the JAX leaf
    order and layout."""
    dtype = torch.float64 if all(v.dtype == torch.float64
                                 for v in tree.values()) else torch.float32
    return torch.cat([_to_canon(tree[n], k).reshape(-1).to(dtype)
                      for n, k in layout_of(tree)])


def tree_unflatten_1d(vec: torch.Tensor, like) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`tree_flatten_1d` against ``like``'s shapes and
    dtypes, in ``like``'s key order."""
    out = FlatSpec.of(like, 1, layout_of(like)).unflatten(vec)
    return {k: out[k] for k in like}


def leaf_noise(source, tree, kind: str = "normal", dtypes: bool = False
               ) -> Dict[str, torch.Tensor]:
    """One :func:`~fedml_tpu_torch.core.noise.draw` per leaf of ``tree``
    in the JAX leaf order, each of the leaf's flax shape (f32, or the
    leaf's dtype when ``dtypes``), given back in the port's layout under
    the leaf's name, in ``tree``'s key order."""
    out = {}
    for name, kind_ in layout_of(tree):
        leaf = tree[name]
        z = noise.draw(source, _canon_shape(tuple(leaf.shape), kind_),
                       leaf.device, kind=kind,
                       dtype=leaf.dtype if dtypes else torch.float32)
        out[name] = _from_canon(z, kind_)
    return {k: out[k] for k in tree}


def stack_clients(raw_list: List[Tuple[float, Any]]):
    """``(C, D)`` matrix, ``(C,)`` weights (both f32, or f64 for float64
    params, on the updates' device) and the template params."""
    template = raw_list[0][1]
    vecs = torch.stack([tree_flatten_1d(p) for _, p in raw_list])
    w = torch.tensor([float(n) for n, _ in raw_list], dtype=vecs.dtype,
                     device=vecs.device)
    return vecs, w, template


def unstack_to_list(vecs, w, template) -> List[Tuple[float, Any]]:
    weights = w.tolist()
    return [(float(weights[i]), tree_unflatten_1d(vecs[i], template))
            for i in range(vecs.shape[0])]


def pairwise_sq_dists(vecs: torch.Tensor) -> torch.Tensor:
    """``(C, C)`` squared euclidean distances: one product."""
    sq = torch.sum(vecs * vecs, dim=1)
    return sq[:, None] + sq[None, :] - 2.0 * (vecs @ vecs.T)


def median(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """numpy's median along ``dim``: the mean of the two middle values for
    an even count (``torch.median`` takes the lower one)."""
    n = x.shape[dim]
    s = torch.sort(x, dim=dim).values
    hi = s.narrow(dim, n // 2, 1).squeeze(dim)
    if n % 2:
        return hi
    lo = s.narrow(dim, n // 2 - 1, 1).squeeze(dim)
    return (lo + hi) * 0.5


def merge_list(raw_list: List[Tuple[float, Any]]):
    return weighted_average([p for _, p in raw_list],
                            [n for n, _ in raw_list])


def kept(raw_list: Sequence, keep: torch.Tensor) -> List:
    """The entries of ``raw_list`` whose ``keep`` flag is set (one host
    read of the flags)."""
    flags = keep.tolist()
    return [raw_list[i] for i in range(len(raw_list)) if flags[i]]


class BaseDefense:
    """Defense plugin base; subclasses implement any of the three phases
    (``defend_before_aggregation`` / ``defend_on_aggregation`` /
    ``defend_after_aggregation``)."""

    def __init__(self, args):
        self.args = args

    def run(self, raw_list, base_agg=None, extra=None):
        if hasattr(self, "defend_before_aggregation"):
            raw_list = self.defend_before_aggregation(raw_list, extra)
        if hasattr(self, "defend_on_aggregation"):
            return self.defend_on_aggregation(raw_list, base_agg, extra)
        out = (base_agg or merge_list)(raw_list)
        if hasattr(self, "defend_after_aggregation"):
            out = self.defend_after_aggregation(out)
        return out
