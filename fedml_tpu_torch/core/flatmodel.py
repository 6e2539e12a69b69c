"""FlatModel — the flatten-concat-pad view of a params dict (port of
``fedml_tpu.core.flatmodel``).

``FlatSpec`` fixes one flat f32 layout of a ``{name: tensor}`` dict: leaf
order, per-leaf offsets, the pad multiple the shard count demands, and the
flatten / unflatten / chunk operations.  The scatter merge chunks it over
the client shards, the quantized collectives block-scale it, and the
server state keeps its flat fields (``master_flat``, the EF rows, the
shard-resident optimizer state) in it.

The JAX package flattens a flax tree: leaves in ``tree_flatten`` order
(nested dict keys sorted), each in flax's layout (a ``Dense`` kernel ``(in,
out)``, a ``Conv`` kernel HWIO).  The port's models keep PyTorch's layouts
(``Linear`` ``(out, in)``, ``Conv2d`` OIHW).  Given the model's ``layout``
(:meth:`~fedml_tpu_torch.models.base.TorchModel.flat_layout`: each name
with its kind, in flax's leaf order), a spec flattens each leaf in flax's
layout, so the flat vector is bitwise the JAX package's: the int8
quantizer's blocks hold the same elements, and a shard's chunk the same
parameters.  Without a layout, leaves go in dict order as stored.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch

TensorDict = dict


def _to_canon(t: torch.Tensor, kind: str) -> torch.Tensor:
    """A leaf in the port's layout → flax's (``models/convert.py``)."""
    if kind == "dense":
        return t.t()
    if kind == "conv":
        return t.permute(2, 3, 1, 0)
    if kind == "conv_transpose":
        return torch.flip(t.permute(2, 3, 0, 1), dims=(0, 1))
    return t


def _from_canon(t: torch.Tensor, kind: str) -> torch.Tensor:
    """Inverse of :func:`_to_canon`."""
    if kind == "dense":
        return t.t()
    if kind == "conv":
        return t.permute(3, 2, 0, 1)
    if kind == "conv_transpose":
        return torch.flip(t, dims=(0, 1)).permute(2, 3, 0, 1)
    return t


def _canon_shape(shape, kind: str) -> Tuple[int, ...]:
    if kind == "dense":
        return (shape[1], shape[0])
    if kind == "conv":
        return (shape[2], shape[3], shape[1], shape[0])
    if kind == "conv_transpose":
        return (shape[2], shape[3], shape[0], shape[1])
    return tuple(shape)


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Static description of a params dict's flat view (hashable, holds no
    tensors)."""

    names: Tuple[str, ...]
    kinds: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    n_params: int          # real elements (pre-padding)
    multiple: int          # flat length pads to a multiple of this
    padded_size: int

    @classmethod
    def of(cls, tree: TensorDict, multiple: int = 1,
           layout: Optional[Sequence[Tuple[str, str]]] = None
           ) -> "FlatSpec":
        """The spec of ``tree``; ``layout`` gives ``(name, kind)`` pairs in
        the flat order (every name of ``tree`` once)."""
        if layout is None:
            layout = [(k, "param") for k in tree]
        names = tuple(n for n, _ in layout)
        if sorted(names) != sorted(tree):
            raise ValueError("the layout does not name the params' leaves")
        kinds = tuple(k for _, k in layout)
        shapes = tuple(tuple(tree[n].shape) for n in names)
        n = sum(int(math.prod(s)) for s in shapes)
        multiple = max(int(multiple), 1)
        return cls(names=names, kinds=kinds, shapes=shapes,
                   dtypes=tuple(tree[k].dtype for k in names), n_params=n,
                   multiple=multiple, padded_size=-(-n // multiple) * multiple)

    # -- vec <-> tree ------------------------------------------------------
    def flatten(self, tree: TensorDict) -> torch.Tensor:
        """One padded f32 vector in the spec's leaf order and layout."""
        parts = [_to_canon(tree[n], k).reshape(-1).to(torch.float32)
                 for n, k in zip(self.names, self.kinds)]
        pad = self.padded_size - self.n_params
        if pad:
            parts.append(torch.zeros(pad, dtype=torch.float32,
                                     device=parts[0].device))
        return torch.cat(parts)

    def unflatten(self, vec: torch.Tensor) -> TensorDict:
        """Inverse of :meth:`flatten`; the padding is dropped, leaves get
        their shapes and dtypes back."""
        out, off = {}, 0
        for n, k, shape, dtype in zip(self.names, self.kinds, self.shapes,
                                      self.dtypes):
            size = int(math.prod(shape))
            leaf = vec[off:off + size].reshape(_canon_shape(shape, k))
            out[n] = _from_canon(leaf, k).to(dtype).contiguous()
            off += size
        return out

    # -- shard chunks ------------------------------------------------------
    @property
    def chunk_size(self) -> int:
        return self.padded_size // self.multiple

    def chunk(self, vec: torch.Tensor, index: int,
              n_chunks: int) -> torch.Tensor:
        """Chunk ``index`` of ``vec`` split into ``n_chunks`` equal
        blocks."""
        size = vec.shape[0] // n_chunks
        return vec[index * size:(index + 1) * size]

    def zeros(self, device=None) -> torch.Tensor:
        return torch.zeros(self.padded_size, dtype=torch.float32,
                           device=device)

