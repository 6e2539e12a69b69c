"""fedwire — the quantized wire codec of the distributed tier (port of
``fedml_tpu.core.wire``).

One flatten → quantize → frame pipeline shared by the silo → server
partials, the async workers' updates, the coordinator's state syncs, the
wire-format checkpoint (``core/checkpoint.py``) and the WAL's state
digest, so quantization lands exactly once.

Layout: a nested state dict's array leaves are walked in sorted-path
order; float leaves with at least ``block`` elements concatenate into ONE
f32 vector, carried at the configured precision:

- ``fp32``: the raw f32 vector (bitwise round trip; also the checkpoint
  and WAL format);
- ``bf16``: the round-to-nearest-even 16-bit payload (``bf16_round_np``);
- ``int8``: per-``block`` absmax symmetric int8 and f32 scales
  (``blockscale_quantize_np``), with error feedback.

Small, scalar and integer leaves (denominators, step counts, round ids:
the partial algebra's exact bookkeeping) ride raw in the ``raw`` sidecar;
``lists``/``empties``/``nones`` record the structural facts a state dict
carries.  The payload is a plain dict of msgpack-able values: on a tree of
numpy arrays under the JAX package's names, ``message.encode_tree`` of a
payload is byte for byte ``flax.serialization.msgpack_serialize`` of the
JAX codec's.

What the port adds: its params are flat ``{name: tensor}`` dicts in
PyTorch's layout (``Linear`` ``(out, in)``, ``Conv2d`` OIHW), where the
JAX package walks a flax tree in flax's layout.  Walked as they are, an
int8 block would hold other elements and get other scales.  A codec given
the model's :class:`ParamLayout` puts every params-shaped dict it meets
(its keys the model's parameter names; leading axes allowed, as in a
per-client table) into flax's names and layout before the walk, so the
quantized vector (``f``/``h``/``q``/``s``) is bitwise the JAX codec's for
the same values, and turns the flax-shaped subtrees of a decoded payload
back into the model's names, order and layout.

Error feedback: :class:`WireLink` keeps one host f32 residual per link;
each encode quantizes ``value + ef`` and keeps ``(value + ef) −
dequantized``.  EF advances once per ENCODE, never per transmit attempt,
so chunk retransmissions and duplicate deliveries cannot double-count it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..models.convert import _to_flax, _to_port
from ..obs import get_tracer
from .compression.blockscale import (DEFAULT_BLOCK, bf16_expand_np,
                                     bf16_round_np,
                                     blockscale_dequantize_np,
                                     blockscale_quantize_np,
                                     collective_payload_nbytes)
from .flatmodel import _canon_shape
from .tree import flatten, unflatten

#: accepted ``args.wire_precision`` values; "off" keeps the plain
#: state-dict message format
WIRE_PRECISIONS = ("fp32", "bf16", "int8")

#: payload format version
_WIRE_V = 1


def wire_precision(args) -> str:
    p = str(getattr(args, "wire_precision", "") or "off").lower()
    if p == "off":
        return "off"
    if p not in WIRE_PRECISIONS:
        raise ValueError(
            f"unknown wire_precision {p!r} — expected one of "
            f"{('off',) + WIRE_PRECISIONS}")
    return p


def wire_block(args) -> int:
    return int(getattr(args, "wire_block", 0) or 0) \
        or int(getattr(args, "quant_block", 0) or 0) or DEFAULT_BLOCK


# -- the model's flax layout --------------------------------------------------

def _host(x) -> np.ndarray:
    """A leaf on the host as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass(frozen=True)
class ParamLayout:
    """A model's parameters as the JAX package names and lays them out:
    ``names`` in the model's parameter order, each with its kind
    (:func:`~fedml_tpu_torch.models.base.param_kinds`), flax path and
    shape."""

    names: Tuple[str, ...]
    kinds: Tuple[str, ...]
    paths: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]

    @classmethod
    def of(cls, model) -> "ParamLayout":
        from ..models.base import param_kinds
        kinds = param_kinds(model.module)
        names = tuple(n for n, _ in model.module.named_parameters())
        return cls(names, tuple(kinds[n][0] for n in names),
                   tuple(kinds[n][1] for n in names),
                   tuple(tuple(model.module.get_parameter(n).shape)
                         for n in names))

    def _lead(self, tree: Mapping, shapes) -> Optional[int]:
        """The leading axes every leaf of ``tree`` adds to ``shapes``
        (one count for all), or None if it is not that shape."""
        lead = None
        for leaf, shape in zip(tree, shapes):
            s = tuple(getattr(leaf, "shape", ()))
            k = len(s) - len(shape)
            if k < 0 or s[k:] != tuple(shape) or (lead is not None
                                                  and k != lead):
                return None
            lead = k
        return lead

    def port_lead(self, d: Mapping) -> Optional[int]:
        """``d``'s leading axes if it is a params-shaped dict in the
        port's names and layout, else None."""
        if len(d) != len(self.names) or set(d) != set(self.names):
            return None
        return self._lead([d[n] for n in self.names], self.shapes)

    def to_flax(self, d: Mapping, lead: int) -> dict:
        """A params-shaped dict → the nested flax tree of host arrays."""
        root: dict = {}
        for name, kind, path in zip(self.names, self.kinds, self.paths):
            a = np.ascontiguousarray(_to_flax(_host(d[name]), kind, lead))
            node = root
            parts = path.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = a
        return root

    def from_flax(self, d: Mapping) -> Optional[dict]:
        """A decoded flax-shaped subtree (a nested dict holding exactly the
        model's flax paths) → the params dict in the model's order, names
        and layout (host arrays); None if ``d`` is not one."""
        flat = flatten(d)
        if set(flat) != set(self.paths):
            return None
        fshapes = [_canon_shape(s, k) for s, k in zip(self.shapes,
                                                       self.kinds)]
        lead = self._lead([flat[p] for p in self.paths], fshapes)
        if lead is None:
            return None
        return {name: np.ascontiguousarray(_to_port(flat[path], kind, lead))
                for name, kind, path in zip(self.names, self.kinds,
                                            self.paths)}


def to_flax_tree(tree: Any, layout: Optional[ParamLayout]) -> Any:
    """``tree`` with every params-shaped dict in flax's names and layout
    (host arrays); without a layout, the tree unchanged."""
    if layout is None:
        return tree
    if isinstance(tree, dict):
        lead = layout.port_lead(tree)
        if lead is not None:
            return layout.to_flax(tree, lead)
        return {k: to_flax_tree(v, layout) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_flax_tree(v, layout) for v in tree]
    return tree


def from_flax_tree(tree: Any, layout: Optional[ParamLayout]) -> Any:
    """Inverse of :func:`to_flax_tree` on a decoded tree."""
    if layout is None:
        return tree
    if isinstance(tree, dict):
        port = layout.from_flax(tree)
        if port is not None:
            return port
        return {k: from_flax_tree(v, layout) for k, v in tree.items()}
    if isinstance(tree, list):
        return [from_flax_tree(v, layout) for v in tree]
    return tree


# -- state-dict walking -------------------------------------------------------

def _walk(sd: Any, path: str, out: List[Tuple[str, Any]],
          lists: List[str], empties: List[str], nones: List[str]):
    """Flatten a nested state dict into sorted ``(path, array)`` pairs,
    the leaf order both ends derive independently.  Lists and tuples,
    empty dicts and ``None`` leaves are recorded (``lists``/``empties``/
    ``nones``), not flattened away."""
    if isinstance(sd, dict):
        if not sd:
            empties.append(path)
            return
        for k in sorted(sd, key=str):
            _walk(sd[k], f"{path}/{k}" if path else str(k),
                  out, lists, empties, nones)
        return
    if isinstance(sd, (list, tuple)):
        lists.append(path)
        for i, v in enumerate(sd):
            _walk(v, f"{path}/{i}" if path else str(i),
                  out, lists, empties, nones)
        return
    if sd is None:
        nones.append(path)
        return
    out.append((path, _host(sd)))


def _unwalk(pairs: Dict[str, Any], lists=(), empties=(), nones=()) -> Any:
    """Rebuild the nested structure from ``path → array`` plus the
    recorded list, empty-dict and None nodes."""
    root: Dict[str, Any] = {}

    def _set(path: str, value):
        node = root
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    for path in empties:
        if path:
            _set(path, {})
    for path in nones:
        _set(path, None)
    for path, arr in pairs.items():
        _set(path, arr)
    # list nodes were built as {"0": ..., "1": ...}; convert deepest
    # first so inner lists exist before their parents are converted
    for path in sorted(lists, key=lambda p: -p.count("/")):
        if not path:
            continue
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node[p]
        d = node.get(parts[-1], {})
        node[parts[-1]] = [d[str(i)] for i in range(len(d))]
    if "" in lists:
        return [root[str(i)] for i in range(len(root))]
    if "" in empties:
        return {}
    return root


def _quantizable(arr: np.ndarray, block: int) -> bool:
    return arr.dtype.kind == "f" and arr.size >= block


class WireCodec:
    """Encode and decode nested state dicts at a wire precision.

    Payloads are self-describing (paths, shapes and dtypes ride along), so
    a receiver needs no template.  ``layout`` (the model's
    :class:`ParamLayout`) maps params-shaped dicts to flax's names and
    layout on encode and back on :meth:`decode`."""

    def __init__(self, precision: str = "fp32", block: int = DEFAULT_BLOCK,
                 layout: Optional[ParamLayout] = None):
        if precision not in WIRE_PRECISIONS:
            raise ValueError(
                f"unknown wire precision {precision!r} — expected one of "
                f"{WIRE_PRECISIONS}")
        self.precision = precision
        self.block = int(block) or DEFAULT_BLOCK
        self.layout = layout

    # -- encode -----------------------------------------------------------
    def encode(self, sd: Any, ef: Optional[np.ndarray] = None):
        """State dict → ``(payload, new_ef)``.

        ``ef`` is the link's error-feedback residual over the quantized
        flat vector (None on first use; fp32 and bf16 keep it None: bf16
        re-rounds from f32 each time, so its error is white, not
        accumulating)."""
        pairs: List[Tuple[str, Any]] = []
        lists: List[str] = []
        empties: List[str] = []
        nones: List[str] = []
        _walk(to_flax_tree(sd, self.layout), "", pairs, lists, empties,
              nones)
        quant = [bool(_quantizable(a, self.block)) for _, a in pairs]
        payload: Dict[str, Any] = {
            "v": _WIRE_V, "prec": self.precision, "block": self.block,
            "paths": [p for p, _ in pairs],
            "shapes": [list(a.shape) for _, a in pairs],
            "dtypes": [str(a.dtype) for _, a in pairs],
            "quant": [int(q) for q in quant],
            "lists": lists, "empties": empties, "nones": nones,
            "raw": {str(i): a for i, (_, a) in enumerate(pairs)
                    if not quant[i]},
        }
        n = int(sum(a.size for (_, a), q in zip(pairs, quant) if q))
        payload["n"] = n
        new_ef = ef
        if n:
            vec = np.concatenate(
                [a.reshape(-1).astype(np.float32)
                 for (_, a), q in zip(pairs, quant) if q])
            if self.precision == "fp32":
                payload["f"] = vec
            elif self.precision == "bf16":
                payload["h"] = bf16_round_np(vec)
            else:   # int8 with error feedback
                v = vec if ef is None else vec + np.asarray(ef, np.float32)
                q8, scales = blockscale_quantize_np(v, bits=8,
                                                    block=self.block)
                payload["q"], payload["s"] = q8, scales
                new_ef = v - blockscale_dequantize_np(q8, scales, n)
        tr = get_tracer()
        if tr.enabled:
            tr.add_bytes("wire.bytes", payload_nbytes(payload))
            tr.add_bytes("wire.modeled_bytes",
                         self.modeled_nbytes(n, payload["raw"]))
            if new_ef is not None:
                tr.counter("wire.ef_norm", float(np.linalg.norm(new_ef)))
        return payload, new_ef

    # -- decode -----------------------------------------------------------
    @staticmethod
    def decode(payload: Dict[str, Any],
               layout: Optional[ParamLayout] = None) -> Any:
        """Payload → nested state dict (host arrays in their dtypes); with
        ``layout`` the flax-shaped subtrees come back as the model's
        params dicts."""
        prec = str(payload["prec"])
        n = int(payload["n"])
        if n == 0:
            vec = np.zeros((0,), np.float32)
        elif prec == "fp32":
            vec = np.asarray(payload["f"], np.float32).reshape(-1)[:n]
        elif prec == "bf16":
            vec = bf16_expand_np(payload["h"])[:n]
        elif prec == "int8":
            vec = blockscale_dequantize_np(payload["q"], payload["s"], n)
        else:
            raise ValueError(f"unknown wire precision {prec!r}")
        raw = payload.get("raw") or {}
        out: Dict[str, Any] = {}
        off = 0
        for i, (path, shape, dtype, q) in enumerate(zip(
                payload["paths"], payload["shapes"], payload["dtypes"],
                payload["quant"])):
            shape = tuple(int(s) for s in shape)
            if int(q):
                size = int(np.prod(shape)) if shape else 1
                out[str(path)] = vec[off:off + size].reshape(shape).astype(
                    np.dtype(str(dtype)))
                off += size
            else:
                out[str(path)] = np.asarray(raw[str(i)]).reshape(
                    shape).astype(np.dtype(str(dtype)))
        tree = _unwalk(out,
                       [str(p) for p in (payload.get("lists") or [])],
                       [str(p) for p in (payload.get("empties") or [])],
                       [str(p) for p in (payload.get("nones") or [])])
        return from_flax_tree(tree, layout)

    # -- byte model -------------------------------------------------------
    def modeled_nbytes(self, n_quant: int, raw: Dict[str, Any]) -> int:
        """Modeled wire bytes of one payload: the quantized vector at
        :func:`collective_payload_nbytes` (padding and scales included)
        plus the raw sidecar leaves; framing is not modeled."""
        b = collective_payload_nbytes(n_quant, self.precision, self.block) \
            if n_quant else 0
        return int(b + sum(np.asarray(a).nbytes for a in raw.values()))


def payload_nbytes(payload: Dict[str, Any]) -> int:
    """Actual array bytes of an encoded payload (framing excluded)."""
    b = sum(np.asarray(payload[k]).nbytes for k in ("f", "h", "q", "s")
            if k in payload)
    return int(b + sum(np.asarray(a).nbytes for a in
                       (payload.get("raw") or {}).values()))


def is_wire_payload(obj: Any) -> bool:
    return isinstance(obj, dict) and obj.get("v") == _WIRE_V \
        and "prec" in obj and "paths" in obj


class WireLink:
    """Per-link error-feedback state over one :class:`WireCodec`.

    ``link`` keys one logical edge and payload kind (``"partial"`` on a
    silo, ``"state:3"`` on the async server).  The hierarchy's state sync
    is a broadcast, every silo receiving the same bytes, so it uses ONE
    link for the whole fan-out."""

    def __init__(self, codec: WireCodec):
        self.codec = codec
        self._ef: Dict[str, Optional[np.ndarray]] = {}

    def encode(self, sd: Any, link: str = "") -> Dict[str, Any]:
        payload, ef = self.codec.encode(sd, self._ef.get(link))
        self._ef[link] = ef
        return payload

    def decode(self, payload: Dict[str, Any]) -> Any:
        return WireCodec.decode(payload, self.codec.layout)

    def ef(self, link: str = "") -> Optional[np.ndarray]:
        return self._ef.get(link)


def codec_from_args(args, layout: Optional[ParamLayout] = None
                    ) -> Optional[WireCodec]:
    """The run's wire codec (over the model's ``layout``), or None when
    ``wire_precision`` is off."""
    p = wire_precision(args)
    if p == "off":
        return None
    return WireCodec(p, wire_block(args), layout)


def maybe_decode(obj: Any, layout: Optional[ParamLayout] = None) -> Any:
    """Decode ``obj`` if it is a wire payload, else return it unchanged:
    one receiver accepts both plain state-dict params and fedwire
    payloads."""
    if is_wire_payload(obj):
        return WireCodec.decode(obj, layout)
    return obj


# -- the port's trees on the wire ---------------------------------------------

def state_tree(state) -> dict:
    """A ``ServerState`` as the JAX package's ``to_state_dict`` lays it
    out: every field by name (``None`` kept), the round counter a 0-d
    int32, a ``{"mu/name": ...}`` optimizer state nested on its ``/``."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, Mapping):
            v = unflatten(v)
        elif f.name == "round_idx":
            v = np.asarray(int(v), np.int32)
        out[f.name] = v
    return out


def tensor_tree(tree: Any, device, order=None) -> Any:
    """A received tree on ``device``: host arrays copied into tensors,
    tensors moved, nested dicts walked.  ``order`` (the model's parameter
    names) puts every params dict back in the model's order: the dict
    order is the summation order of a global norm (gradient clipping)."""
    if isinstance(tree, dict):
        if order is not None and len(tree) == len(order) and \
                set(tree) == set(order):
            tree = {k: tree[k] for k in order}
        return {k: tensor_tree(v, device, order) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tensor_tree(v, device, order) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.tensor(np.asarray(tree), device=device)
    return tree


def state_from_tree(tree: Mapping, like):
    """Inverse of :func:`state_tree` against ``like`` (a state of the same
    kind): each tensor on ``like``'s device and in its dtype, its dicts in
    ``like``'s key order."""
    from .checkpoint import state_from_flat, state_to_flat
    flat = flatten(tree)
    return state_from_flat(
        {k: tensor_tree(flat[k], v.device).to(v.dtype)
         for k, v in state_to_flat(like).items()}, like)


__all__ = [
    "WIRE_PRECISIONS", "ParamLayout", "WireCodec", "WireLink",
    "codec_from_args", "from_flax_tree", "is_wire_payload", "maybe_decode", "payload_nbytes", "state_from_tree",
    "state_tree", "tensor_tree", "to_flax_tree", "wire_block",
    "wire_precision",
]
