"""Step-level checkpoint/resume (port of
``fedml_tpu.core.checkpoint.RoundCheckpointer``, in the port's own format).

A checkpoint is one file per step, ``step_<n>.pt``: ``torch.save`` of
``{"step": n, "state": {name: tensor}, "client_state": {name: tensor} or
None}``, written to a temporary file and renamed into place, the oldest
pruned past ``max_to_keep``.  State is a flat dict of tensors (the trainer's
``{"train/...", "opt/..."}``, or a federated ``ServerState`` through
:func:`state_to_flat`); a dense per-client table travels the same way as
``client_state``.  A sparse client store
(:class:`~fedml_tpu_torch.store.ClientStateStore`) is saved beside the step
as ``store_<n>.npz``, its written rows only (the JAX package's sidecar
layout), and restored into the caller's store in place.  An orbax
checkpoint of the JAX package is not read.

:class:`WireCheckpointer` (``checkpoint_codec="wire"``) writes each step as
ONE wire-fp32 payload of ``core/wire.py``'s codec, msgpack'd to
``wire_<n>.msgpack``: the checkpoint bytes are wire bytes, so a state sync
after resume and the WAL's ``state_digest`` verify against one encoding.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

TensorDict = Dict[str, torch.Tensor]


def _is_store(client_state) -> bool:
    """A sparse client store, duck-typed so this module does not import
    the store package."""
    return (hasattr(client_state, "to_checkpoint")
            and hasattr(client_state, "load_checkpoint"))


def _check_flat(what: str, tree) -> None:
    if tree is None:
        return
    if not isinstance(tree, Mapping) or not all(
            isinstance(k, str) and isinstance(v, torch.Tensor)
            for k, v in tree.items()):
        raise NotImplementedError(
            f"{what}: a checkpoint of {type(tree).__name__} is not "
            "implemented: the port checkpoints flat {name: tensor} dicts "
            "and a client store (store/clientstore.py)")


def state_to_flat(state) -> TensorDict:
    """A federated ``ServerState`` (or any dataclass of tensors and
    ``{name: tensor}`` dicts) as one flat dict: ``field`` or
    ``field/name``, the host round counter as a 0-d int64 tensor."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if v is None:
            continue
        if isinstance(v, torch.Tensor):
            out[f.name] = v
        elif isinstance(v, Mapping):
            out.update({f"{f.name}/{k}": t for k, t in v.items()})
        else:
            out[f.name] = torch.tensor(int(v), dtype=torch.int64)
    return out


def state_from_flat(flat: Mapping, like):
    """Inverse of :func:`state_to_flat` against the structure of ``like``
    (a state of the same kind): a restored state."""
    changes = {}
    for f in dataclasses.fields(like):
        v = getattr(like, f.name)
        if v is None:
            continue
        if isinstance(v, torch.Tensor):
            changes[f.name] = flat[f.name]
        elif isinstance(v, Mapping):
            changes[f.name] = {k: flat[f"{f.name}/{k}"] for k in v}
        else:
            changes[f.name] = int(flat[f.name])
    return dataclasses.replace(like, **changes)


class RoundCheckpointer:
    #: a step's file is ``<PREFIX><n><SUFFIX>`` in the directory
    PREFIX, SUFFIX = "step_", ".pt"

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = int(max_to_keep)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory,
                            f"{self.PREFIX}{int(step)}{self.SUFFIX}")

    def steps(self):
        out = []
        for p in glob.glob(os.path.join(self.directory,
                                        f"{self.PREFIX}*{self.SUFFIX}")):
            try:
                out.append(int(os.path.basename(p)[
                    len(self.PREFIX):-len(self.SUFFIX)]))
            except ValueError:
                continue
        return sorted(out)

    def _store_path(self, step: int) -> str:
        return os.path.join(self.directory, f"store_{int(step)}.npz")

    def save(self, round_idx: int, state: TensorDict,
             client_state=None) -> None:
        """Write ``state`` (and ``client_state``: a flat dict, or a client
        store saved sparse as the step's sidecar) as step ``round_idx``,
        moved to the CPU; then prune the oldest steps and their
        sidecars."""
        store = client_state if _is_store(client_state) else None
        if store is not None:
            client_state = None
            np.savez(self._store_path(round_idx), **store.to_checkpoint())
        _check_flat("state", state)
        _check_flat("client_state", client_state)
        path = self._path(round_idx)
        tmp = path + ".tmp"
        self._write(tmp, round_idx, state, client_state)
        os.replace(tmp, path)
        steps = self.steps()
        for step in steps[:max(len(steps) - self.max_to_keep, 0)]:
            os.remove(self._path(step))
        keep = set(self.steps())
        for p in glob.glob(os.path.join(self.directory, "store_*.npz")):
            try:
                step = int(os.path.basename(p)[len("store_"):-len(".npz")])
            except ValueError:
                continue
            if step not in keep:
                os.remove(p)

    def _write(self, path: str, step: int, state, client_state) -> None:
        host = lambda tree: None if tree is None else {
            k: v.detach().cpu() for k, v in tree.items()}
        torch.save({"step": int(step), "state": host(state),
                    "client_state": host(client_state)}, path)

    def latest_round(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _load(self, step: int) -> dict:
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)

    def restore(self, round_idx: Optional[int] = None,
                template: Optional[Any] = None):
        """``(state, client_state)`` of step ``round_idx`` (the latest by
        default), or ``None`` if there is none.  With ``template`` (a pair
        of flat dicts, the second may be ``None``) each tensor comes back on
        its template's device and in its dtype, and the names must match.
        A client store as the second template is loaded in place, from the
        step's sidecar (or, for a step saved with a dense table, from that
        table), and returned."""
        step = round_idx if round_idx is not None else self.latest_round()
        if step is None:
            return None
        blob = self._load(step)
        state, client = blob["state"], blob["client_state"]
        if template is not None and _is_store(template[1]):
            store = template[1]
            sidecar = self._store_path(step)
            if os.path.exists(sidecar):
                with np.load(sidecar) as z:
                    store.load_checkpoint({k: z[k] for k in z.files})
            elif client:
                store.load_dense(client)
            return _like(state, template[0], "state"), store
        if template is not None:
            state = _like(state, template[0], "state")
            if template[1] is not None and client is not None:
                client = _like(client, template[1], "client_state")
        return state, client if client is not None else {}

    def restore_state(self, round_idx: Optional[int] = None):
        """Only the saved state dict (on the CPU), or ``None``."""
        step = round_idx if round_idx is not None else self.latest_round()
        return None if step is None else self._load(step)["state"]

    def close(self) -> None:
        pass


class WireCheckpointer(RoundCheckpointer):
    """Round checkpoints in the fedwire format (port of
    ``fedml_tpu.core.checkpoint.WireCheckpointer``): each step is one
    wire-fp32 payload (:class:`~fedml_tpu_torch.core.wire.WireCodec`,
    bitwise at fp32) of ``{"state": ..., "client_table": ...}``, the flat
    dicts nested on their ``/``, msgpack'd to ``wire_<n>.msgpack`` with an
    atomic temporary-file rename, beside the same sparse-store ``.npz``
    sidecar; the same surface as :class:`RoundCheckpointer`, so the
    engines select it by args alone.  ``layout`` (the model's
    :class:`~fedml_tpu_torch.core.wire.ParamLayout`) writes params-shaped
    dicts in flax's names and layout, as the JAX package's file holds
    them."""

    PREFIX, SUFFIX = "wire_", ".msgpack"

    def __init__(self, directory: str, max_to_keep: int = 3, layout=None):
        super().__init__(directory, max_to_keep)
        self.layout = layout

    def _write(self, path: str, step: int, state, client_state) -> None:
        from .distributed.communication.message import encode_tree
        from .tree import unflatten
        from .wire import WireCodec
        comp = {"state": unflatten(state)}
        if client_state is not None:
            comp["client_table"] = dict(client_state)
        payload, _ = WireCodec("fp32", layout=self.layout).encode(comp)
        with open(path, "wb") as fh:
            fh.write(encode_tree(payload))
            fh.flush()
            os.fsync(fh.fileno())

    def _load(self, step: int) -> dict:
        from .distributed.communication.message import decode_tree
        from .tree import flatten
        from .wire import WireCodec
        with open(self._path(step), "rb") as fh:
            comp = WireCodec.decode(decode_tree(fh.read()), self.layout)
        # a None field (a state the JAX package wrote) is not in the
        # port's flat form
        host = lambda tree: {
            k: v if isinstance(v, torch.Tensor) else
            torch.from_numpy(np.array(v)) for k, v in flatten(tree).items()
            if v is not None}
        client = comp.get("client_table")
        return {"step": int(step), "state": host(comp["state"]),
                "client_state": None if client is None else host(client)}


def _like(saved: TensorDict, template: TensorDict, what: str) -> TensorDict:
    if set(saved) != set(template):
        missing = sorted(set(template) ^ set(saved))[:5]
        raise ValueError(f"{what}: checkpoint and template differ in "
                         f"{missing}")
    out = {}
    for k, t in template.items():
        if tuple(saved[k].shape) != tuple(t.shape):
            raise ValueError(f"{what}/{k}: saved shape {tuple(saved[k].shape)}"
                             f" vs template {tuple(t.shape)}")
        out[k] = saved[k].to(device=t.device, dtype=t.dtype)
    return out
