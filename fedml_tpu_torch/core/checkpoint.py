"""Step-level checkpoint/resume (port of
``fedml_tpu.core.checkpoint.RoundCheckpointer``, in the port's own format).

A checkpoint is one file per step, ``step_<n>.pt``: ``torch.save`` of
``{"step": n, "state": {name: tensor}, "client_state": {name: tensor} or
None}``, written to a temporary file and renamed into place, the oldest
pruned past ``max_to_keep``.  State is a flat dict of tensors (the trainer's
``{"train/...", "opt/..."}``); a dense per-client table travels the same way
as ``client_state``.  An orbax checkpoint of the JAX package is not read,
and the client-store sidecars wait for the client-state plane.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, Mapping, Optional

import torch

TensorDict = Dict[str, torch.Tensor]


def _check_flat(what: str, tree) -> None:
    if tree is None:
        return
    if not isinstance(tree, Mapping) or not all(
            isinstance(k, str) and isinstance(v, torch.Tensor)
            for k, v in tree.items()):
        raise NotImplementedError(
            f"{what}: the port checkpoints flat {{name: tensor}} dicts only "
            "(client stores wait for the client-state plane)")


class RoundCheckpointer:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = int(max_to_keep)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.pt")

    def steps(self):
        out = []
        for p in glob.glob(os.path.join(self.directory, "step_*.pt")):
            try:
                out.append(int(os.path.basename(p)[len("step_"):-len(".pt")]))
            except ValueError:
                continue
        return sorted(out)

    def save(self, round_idx: int, state: TensorDict,
             client_state: Optional[TensorDict] = None) -> None:
        """Write ``state`` (and ``client_state``) as step ``round_idx``,
        moved to the CPU; then prune the oldest steps."""
        _check_flat("state", state)
        _check_flat("client_state", client_state)
        host = lambda tree: None if tree is None else {
            k: v.detach().cpu() for k, v in tree.items()}
        path = self._path(round_idx)
        tmp = path + ".tmp"
        torch.save({"step": int(round_idx), "state": host(state),
                    "client_state": host(client_state)}, tmp)
        os.replace(tmp, path)
        steps = self.steps()
        for step in steps[:max(len(steps) - self.max_to_keep, 0)]:
            os.remove(self._path(step))

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
        its template's device and in its dtype, and the names must match."""
        step = round_idx if round_idx is not None else self.latest_round()
        if step is None:
            return None
        blob = self._load(step)
        state, client = blob["state"], blob["client_state"]
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
