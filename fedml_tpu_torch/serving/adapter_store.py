"""AdapterStore: the host (and disk) backing store of the serving adapter
cache (port of ``fedml_tpu.serving.adapter_store``).

In the cache mode the adapter bank (``serving/adapters.py``) is an N-row
cache in front of this store: every registered adapter's flat LoRA dict
is one row of a :class:`~fedml_tpu_torch.store.ClientStateStore` (the
sparse hash-paged host table, with an optional LRU ``.npz`` spill past
``max_resident_pages``), and the registry pages rows in on a miss.  The
registered count is bounded by host memory and disk, not device memory.

Thread-safety: the name-to-row-id map and the store carry their own locks;
``put``/``get`` may be called from registration threads and the registry's
fetch worker at once.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Mapping, Optional

import numpy as np

from ..store.clientstore import ClientStateStore, host_rows


class AdapterStore:
    """Named flat LoRA rows over a :class:`ClientStateStore`.

    ``model`` gives the row template (``LlamaLM.lora_shapes()``, f32; no
    weights are made); ``registered`` bounds the id space (ids go to names
    in registration order and are never reused).  ``spill_dir`` and
    ``max_resident_pages`` bound host memory by spilling cold pages."""

    def __init__(self, model, registered: int = 16384,
                 page_size: int = 64, max_resident_pages: int = 0,
                 spill_dir: Optional[str] = None):
        shapes = model.lora_shapes()
        if not shapes:
            raise ValueError("model has no LoRA adapters (lora_rank=0?): "
                             "nothing to store")
        template = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
        self._store = ClientStateStore(
            template, registered=int(registered), page_size=page_size,
            max_resident_pages=max_resident_pages, spill_dir=spill_dir)
        self._ids: Dict[str, int] = {}
        self._next = 0
        self._lock = threading.RLock()

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._ids

    def names(self) -> List[str]:
        with self._lock:
            return list(self._ids)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ids)

    def put(self, name: str, tree: Mapping) -> None:
        """Write (or overwrite) ``name``'s row: host copies only."""
        with self._lock:
            rid = self._ids.get(name)
            if rid is None:
                if self._next >= self._store.registered:
                    raise RuntimeError(
                        f"adapter store full ({self._store.registered} "
                        "ids): raise `registered`")
                rid = self._next
                self._next += 1
                self._ids[name] = rid
        rows = {k: v[None] for k, v in host_rows(tree).items()}
        self._store.scatter(np.array([rid], np.int64), rows)

    def get(self, name: str) -> Dict[str, np.ndarray]:
        """``name``'s row (``KeyError`` for unknown names).  May read the
        disk spill: a latency-sensitive thread goes through the registry's
        fetcher instead."""
        with self._lock:
            rid = self._ids[name]
        rows = self._store.gather(np.array([rid], np.int64))
        return {k: v[0] for k, v in rows.items()}

    def remove(self, name: str) -> None:
        """Drop the name's routing (the row stays; ids are not reused)."""
        with self._lock:
            self._ids.pop(name, None)

    def stats(self) -> Dict[str, int]:
        s = dict(self._store.stats())
        with self._lock:
            s["registered_names"] = len(self._ids)
        s["row_nbytes"] = self._store.row_nbytes
        return s
