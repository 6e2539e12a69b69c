"""Runtime auditor: counts the port's "compiles", explicit host↔device
transfers and, on the card, host synchronisations inside a scope (the
counterpart of ``fedml_tpu.analysis.runtime.JaxRuntimeAudit``).

The JAX auditor counts XLA backend compiles and ``jax.device_put``/
``device_get`` calls.  The port's round functions are Python closures and
its compiled programs are the CUDA graphs a fused block captures, so
``compilations`` here counts round-function builds plus graph captures,
and the transfers are the explicit copies at the port's own transfer
points; both arrive through :mod:`fedml_tpu_torch.obs.torchhooks`, the
hub the tracer subscribes to as well.

On the card the auditor also sets ``torch.cuda.set_sync_debug_mode
("warn")`` for the scope and counts the warnings it raises (every
operation that synchronises the host with the device: a ``.item()``, a
``.cpu()``, a blocking copy).  That is the zero-extra-sync contract of the
obs plane measured, where the JAX package could only reason about it:
a traced run's ``syncs`` equal an untraced run's.

Usage::

    with TorchRuntimeAudit() as audit:
        api.train_one_round(2)
    assert audit.compilations == 0
"""

from __future__ import annotations

import os
import threading
import traceback
import warnings
from typing import List, Optional

import torch

from ..obs import torchhooks


class TorchRuntimeAudit:
    """Counts builds, graph captures, explicit transfers and (on the card,
    ``sync_debug``) synchronising operations within a ``with`` scope.

    Attributes: ``builds``, ``captures``, ``compilations`` (their sum),
    ``device_puts`` / ``device_gets`` (explicit copy calls) with
    ``put_bytes`` / ``get_bytes``, ``syncs`` (sync-debug warnings; None
    when not watched) and ``sync_sites`` (the line of the caller's own
    code that made each).
    ``sync_debug`` defaults to watching whenever CUDA is available."""

    def __init__(self, sync_debug: Optional[bool] = None):
        self.builds = 0
        self.captures = 0
        self.built: List[str] = []
        self.device_puts = 0
        self.device_gets = 0
        self.put_bytes = 0
        self.get_bytes = 0
        self.sync_debug = (torch.cuda.is_available() if sync_debug is None
                           else bool(sync_debug))
        self.syncs: Optional[int] = None
        self.sync_sites: List[str] = []
        self._lock = threading.Lock()
        self._prev_mode = None
        self._warn_ctx = None

    @property
    def compilations(self) -> int:
        return self.builds + self.captures

    def _on_event(self, kind: str, value: float, name: str) -> None:
        with self._lock:
            if kind == torchhooks.BUILD:
                self.builds += 1
                self.built.append(name)
            elif kind == torchhooks.CAPTURE:
                self.captures += 1
                self.built.append(f"capture:{name}")
            elif kind == torchhooks.PUT:
                self.device_puts += 1
                self.put_bytes += int(value)
            elif kind == torchhooks.GET:
                self.device_gets += 1
                self.get_bytes += int(value)

    def _on_warning(self, message, category, filename, lineno, file=None,
                    line=None) -> None:
        """Each sync-debug warning's site: the innermost frame of the
        caller's own code (outside torch and the warnings machinery)."""
        if "synchroniz" not in str(message):
            return
        frames = traceback.extract_stack()[:-1]
        mine = [f for f in frames if os.sep + "torch" + os.sep not in
                f.filename and not f.filename.endswith("warnings.py")]
        f = mine[-1] if mine else frames[-1]
        with self._lock:
            self.sync_sites.append(f"{os.path.relpath(f.filename)}:"
                                   f"{f.lineno}")

    def __enter__(self) -> "TorchRuntimeAudit":
        torchhooks.subscribe(self._on_event)
        if self.sync_debug:
            self._prev_mode = torch.cuda.get_sync_debug_mode()
            # switching the mode may itself synchronise (the first time in
            # a process): that is the audit's, not the scope's
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                torch.cuda.set_sync_debug_mode("warn")
            self._warn_ctx = warnings.catch_warnings()
            self._warn_ctx.__enter__()
            warnings.simplefilter("always")
            warnings.showwarning = self._on_warning
        return self

    def __exit__(self, *exc) -> None:
        torchhooks.unsubscribe(self._on_event)
        if self.sync_debug:
            self._warn_ctx.__exit__(*exc)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                torch.cuda.set_sync_debug_mode(self._prev_mode)
            self.syncs = len(self.sync_sites)
        return None
