"""Multi-tenant LoRA serving: the adapter bank and its registry (port of
``fedml_tpu.serving.adapters``, bank mode).

N adapters live stacked on a leading adapter axis next to ONE shared base:
the bank is a flat dict ``{path: (capacity, ...)}`` on the model's device,
one entry per adapter leaf (``layer_0/attention/wq/A`` ``(capacity, in,
r)``, ...).  The engine's batched step gathers ``bank[slot_adapter_ids]``
and the :class:`~fedml_tpu_torch.llm.model.LoRADense` layers apply the rows
as grouped (slot-batched) products.  Capacity is fixed, membership is data.

Concurrency (the registry is shared between request threads and the
engine's thread):

- Row writes happen under ``self.lock``; the engine gathers the bank under
  the same lock, so a step never reads a half-written row.
- Rows referenced by in-flight requests are **pinned**.  Re-registering a
  pinned name is copy-on-write: the name moves to a fresh row, the old row
  becomes a *zombie* that frees when its pins drain, so an in-flight stream
  finishes on the weights it started with.  Evicting a pinned name likewise
  only unroutes it.
- Row 0 is the reserved **zero adapter** (A = B = 0, the exact base model):
  requests without an adapter ride the same gathered step.

Cache mode (``store=``, an :class:`~fedml_tpu_torch.serving.adapter_store
.AdapterStore`): the bank is an N-row cache in front of the host/disk
store.  ``register`` writes through to the store and only unroutes a stale
resident copy; rows page in on the first ``acquire``.  A miss starts an
asynchronous store read (:class:`~fedml_tpu_torch.store.pager
.AsyncRowFetcher`) and raises :class:`AdapterMissError`; the engine parks
the request and retries once the fetch lands.  Residents evict
least-recently-used among the unpinned (their bytes live on in the store),
pinned rows never evict, and there is no ``BankFullError``: the registered
count is bounded by the store.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Mapping, Optional

import torch


class BankFullError(RuntimeError):
    """Every non-reserved bank row is registered or still pinned by an
    in-flight request: evict something (or wait for a drain) first."""


class AdapterMissError(RuntimeError):
    """Cache-mode ``acquire`` miss: the adapter is in the store but not in
    the bank (or every row is pinned).  A page-in is already running:
    park the request and retry when it lands."""

    def __init__(self, name: str):
        super().__init__(f"adapter {name!r} not bank-resident: page-in in "
                         "flight, requeue the request")
        self.name = name


class _Row:
    __slots__ = ("name", "pins", "zombie", "token")

    def __init__(self):
        self.name: Optional[str] = None
        self.pins = 0
        self.zombie = False
        # identity token, new per registration: the prefix caches compare
        # it by ``is``, so KV computed under one adapter version never
        # serves another
        self.token: object = object()


class AdapterRegistry:
    """Name → bank-row routing over a stacked LoRA bank on the model's
    device.  ``capacity`` counts bank rows including the reserved zero row.
    All public methods are thread-safe."""

    def __init__(self, model, capacity: int = 8, dtype=torch.float32,
                 store=None):
        if getattr(getattr(model, "cfg", None), "lora_rank", 0) <= 0:
            raise ValueError("AdapterRegistry requires a lora_rank>0 model "
                             "config (LoRADense layers)")
        capacity = int(capacity)
        if capacity < 2:
            raise ValueError(f"capacity={capacity}: need >= 2 (row 0 is the "
                             "reserved zero adapter)")
        self.capacity = capacity
        self.store = store
        dev = next(model.parameters()).device
        self._row_struct = dict(model.lora_shapes())
        self.bank: Dict[str, torch.Tensor] = {
            k: torch.zeros((capacity,) + tuple(shape), dtype=dtype,
                           device=dev)
            for k, shape in self._row_struct.items()}
        self.lock = threading.RLock()
        self._names: Dict[str, int] = {}
        self._rows = [_Row() for _ in range(capacity)]
        self._free: List[int] = list(range(1, capacity))
        self.stats = {"registered": 0, "evicted": 0, "copy_on_write": 0,
                      "rows_reclaimed": 0, "cache_hits": 0,
                      "cache_misses": 0, "cache_evictions": 0}
        # cache mode: per-name version (a page-in of an older version is
        # dropped), LRU clock per resident row, fetched rows waiting for a
        # free row
        self._ver: Dict[str, int] = {}
        self._lru: Dict[int, int] = {}
        self._lru_clock = 0
        self._pending_install: Dict[str, tuple] = {}
        self._fetcher = None
        self.on_fetch_done = None    # the engine's wake-up hook
        if store is not None:
            from ..store.pager import AsyncRowFetcher
            self._fetcher = AsyncRowFetcher(on_done=self._fetch_done)

    def _fetch_done(self, name: str) -> None:
        cb = self.on_fetch_done
        if cb is not None:
            cb(name)

    def close(self) -> None:
        if self._fetcher is not None:
            self._fetcher.close()

    # -- routing -----------------------------------------------------------
    def names(self) -> List[str]:
        with self.lock:
            if self.store is not None:
                return sorted(set(self._names) | set(self.store.names()))
            return sorted(self._names)

    def __contains__(self, name: str) -> bool:
        with self.lock:
            if self.store is not None and name in self.store:
                return True
            return name in self._names

    def _touch(self, row: int) -> None:
        self._lru_clock += 1
        self._lru[row] = self._lru_clock

    def _install_row(self, name: str, tree) -> Optional[int]:
        """Write a fetched row into the bank (lock held): a free row if
        any, else the least recently used unpinned resident's.  None when
        every row is pinned (the caller parks again)."""
        if self._free:
            row = self._free.pop()
        else:
            cands = [(self._lru.get(i, 0), i)
                     for i, r in enumerate(self._rows)
                     if i and r.name is not None and r.pins == 0
                     and not r.zombie]
            if not cands:
                return None
            _, row = min(cands)
            del self._names[self._rows[row].name]
            self._rows[row].name = None
            self.stats["cache_evictions"] += 1
        self._write_row(row, tree)
        r = self._rows[row]
        r.name = name
        r.zombie = False
        r.token = object()
        self._names[name] = row
        self._touch(row)
        return row

    def acquire(self, name: Optional[str]):
        """Resolve ``name`` to ``(row, token)`` and pin the row for one
        request (``None`` → the zero row, never pinned).  ``KeyError`` for
        unknown names.  Cache mode: a resident name pins and touches its
        row; a store-only name starts an asynchronous page-in and raises
        :class:`AdapterMissError` (requeue and retry)."""
        with self.lock:
            if name is None:
                return 0, self._rows[0].token
            row = self._names.get(name)
            if row is not None:
                self._rows[row].pins += 1
                if self.store is not None:
                    self._touch(row)
                    self.stats["cache_hits"] += 1
                return row, self._rows[row].token
            if self.store is None:
                raise KeyError(
                    f"unknown adapter {name!r}; have {sorted(self._names)}")
            # a landed page-in installs now, if its version is current
            pending = self._pending_install.pop(name, None)
            if pending is None:
                ok, val = self._fetcher.take(name)
                if ok:
                    pending = val
            if pending is not None:
                ver, tree = pending
                if ver == self._ver.get(name):
                    row = self._install_row(name, tree)
                    if row is not None:
                        self._rows[row].pins += 1
                        self.stats["cache_hits"] += 1
                        return row, self._rows[row].token
                    self._pending_install[name] = pending
                    raise AdapterMissError(name)
            if name not in self.store:
                raise KeyError(
                    f"unknown adapter {name!r}; have {self.names()}")
            ver = self._ver.get(name)
            store = self.store
            if self._fetcher.request(name, lambda: (ver, store.get(name))):
                self.stats["cache_misses"] += 1
            raise AdapterMissError(name)

    def release(self, row: int) -> None:
        """Drop one pin; a zombie row whose pins drain returns to the free
        list."""
        if row == 0:
            return
        with self.lock:
            r = self._rows[row]
            r.pins = max(r.pins - 1, 0)
            if r.zombie and r.pins == 0:
                r.zombie = False
                self._free.append(row)
                self.stats["rows_reclaimed"] += 1

    def lora_for_row(self, row: int) -> Dict[str, torch.Tensor]:
        """One row as a flat adapter dict (views into the bank; a pinned
        row is never rewritten)."""
        with self.lock:
            return {k: b[row] for k, b in self.bank.items()}

    def gather(self, rows) -> Dict[str, torch.Tensor]:
        """``bank[rows]`` for a ``(b,)`` index tensor: the grouped adapters
        of a batched step (copies, taken under the lock)."""
        with self.lock:
            return {k: b[rows] for k, b in self.bank.items()}

    # -- membership --------------------------------------------------------
    def _check_tree(self, lora_tree: Mapping) -> None:
        if set(lora_tree) != set(self._row_struct):
            raise ValueError(
                "lora tree does not match the bank's row structure "
                "(model lora config mismatch): got "
                f"{sorted(lora_tree)[:4]}..., want "
                f"{sorted(self._row_struct)[:4]}...")
        for k, want in self._row_struct.items():
            if tuple(lora_tree[k].shape) != tuple(want):
                raise ValueError(
                    f"lora leaf {k} shape mismatch vs the bank row: got "
                    f"{tuple(lora_tree[k].shape)}, want {tuple(want)} "
                    "(model lora_rank/config mismatch)")

    def _write_row(self, row: int, lora_tree: Mapping) -> None:
        for k, b in self.bank.items():
            b[row] = torch.as_tensor(lora_tree[k]).to(b.device, b.dtype)

    def register(self, name: str, lora_tree: Mapping) -> int:
        """Write ``lora_tree`` (a flat adapter dict) into a bank row and
        route ``name`` to it.  An unpinned name is rewritten in place, a
        pinned one moves to a fresh row (copy-on-write).  Raises
        :class:`BankFullError` when no row is free.

        Cache mode writes through to the store: a stale resident copy is
        unrouted (a zombie while pinned) and the new version pages in on
        the first ``acquire``.  Returns -1 (no resident row yet)."""
        name = str(name)
        self._check_tree(lora_tree)
        if self.store is not None:
            with self.lock:
                self._ver[name] = self._ver.get(name, 0) + 1
                self.store.put(name, lora_tree)
                self._pending_install.pop(name, None)
                row = self._names.pop(name, None)
                if row is not None:
                    r = self._rows[row]
                    r.name = None
                    if r.pins > 0:
                        r.zombie = True
                        self.stats["copy_on_write"] += 1
                    else:
                        self._free.append(row)
                self.stats["registered"] += 1
                return -1
        with self.lock:
            row = self._names.get(name)
            if row is not None and self._rows[row].pins > 0:
                # copy-on-write: the old row keeps serving its readers
                self._rows[row].zombie = True
                self._rows[row].name = None
                self.stats["copy_on_write"] += 1
                row = None
            if row is None:
                if not self._free:
                    raise BankFullError(
                        f"adapter bank full ({self.capacity - 1} rows; "
                        f"registered={sorted(self._names)}, zombies="
                        f"{sum(r.zombie for r in self._rows)}) — evict an "
                        "adapter or wait for in-flight requests to drain")
                row = self._free.pop()
            self._write_row(row, lora_tree)
            r = self._rows[row]
            r.name = name
            r.zombie = False
            r.token = object()
            self._names[name] = row
            self.stats["registered"] += 1
            return row

    def evict(self, name: str) -> None:
        """Unroute ``name``.  New requests for it fail; a row still pinned
        by in-flight requests survives as a zombie until they drain.  Cache
        mode also drops the store's copy (and any page-in of it)."""
        name = str(name)
        with self.lock:
            row = self._names.pop(name, None)
            if self.store is not None:
                if row is None and name not in self.store:
                    raise KeyError(f"unknown adapter {name!r}")
                self.store.remove(name)
                self._ver[name] = self._ver.get(name, 0) + 1
                self._pending_install.pop(name, None)
                self.stats["evicted"] += 1
                if row is None:
                    return
            elif row is None:
                raise KeyError(f"unknown adapter {name!r}")
            else:
                self.stats["evicted"] += 1
            r = self._rows[row]
            r.name = None
            if r.pins > 0:
                r.zombie = True
            else:
                self._free.append(row)

    # -- federated handoff -------------------------------------------------
    def register_from_checkpoint(self, name: str, directory: str,
                                 round_idx: Optional[int] = None,
                                 member: Optional[int] = None) -> int:
        """Register an adapter straight out of a checkpoint of the port's
        own format (``core/checkpoint.py::RoundCheckpointer``, a flat
        ``{name: tensor}`` state; orbax checkpoints of the JAX package are
        not read).  The state is the bare flat adapter dict or one whose
        adapter entries carry a ``lora/`` prefix; ``member`` picks one
        experiment of a population-stacked state
        (:func:`fedml_tpu_torch.core.federated.population_member`)."""
        from ..core.checkpoint import RoundCheckpointer
        state = RoundCheckpointer(directory).restore_state(round_idx)
        if state is None:
            raise FileNotFoundError(
                f"no checkpoint round in {directory!r}")
        prefixed = {k[len("lora/"):]: v for k, v in state.items()
                    if k.startswith("lora/")}
        tree = prefixed or state
        if member is not None:
            from ..core.federated import population_member
            tree = population_member(tree, int(member))
        return self.register(name, tree)


__all__ = ["AdapterMissError", "AdapterRegistry", "BankFullError"]
