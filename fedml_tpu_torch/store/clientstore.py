"""ClientStateStore: host-side sparse, hash-paged per-client state (copy
of ``fedml_tpu.store.clientstore`` over the port's flat dicts).

Layout: a hash map assigns each client id a dense SLOT on first write
(``{client_id -> slot}``); slot ``s`` lives in page ``s // page_size`` at
row ``s % page_size``, and a page is a list of per-leaf numpy arrays shaped
``(page_size,) + row_shape``, one per name of the row template in sorted
order.  Slots are assigned in touch order, so pages pack densely however
sparsely the ids scatter over the registered range (2k random ids out of
10^6 occupy 8 pages of 256, not 2k), and a client never written reads as a
zero row without allocating anything.  Host memory therefore scales with
the written id set, not the registered population.  An optional LRU cap
(``max_resident_pages``) spills cold pages to ``spill_dir`` as ``.npz``
files and reloads them on demand.

Thread-safety: one re-entrant lock around every page and slot-map
mutation: the pager's worker pages in for round r+1 while the caller
gathers round r and the write-back thread applies round r-1
(``store/pager.py`` orders the value reads; the lock protects the maps).

Counters (``stats()``): page hits, misses, spills, loads and the bytes
paged in; when the global fedtrace tracer is enabled the store also emits
``store.page_in_bytes`` counters and ``store.page_in`` spans, which
``tools/fedtrace.py summarize`` reads.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from ..obs import get_tracer

from ..core import tree as tree_util


def host_rows(tree: Mapping) -> Dict[str, np.ndarray]:
    """A flat dict of tensors or arrays as host numpy arrays."""
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in tree.items()}


class ClientStateStore:
    """Sparse hash-paged host store of per-client state rows.

    ``row_template`` is ONE client's state, a flat ``{name: array or
    tensor}`` dict (shapes and dtypes; values ignored); ``registered`` is
    the id space.  ``gather``/``scatter`` have the dense table's
    out-of-range semantics (reads fill zero, writes drop), so the cohort
    stack is interchangeable with ``core.tree.cohort_gather``'s."""

    def __init__(self, row_template: Mapping, registered: int,
                 page_size: int = 256, max_resident_pages: int = 0,
                 spill_dir: Optional[str] = None):
        tpl = host_rows(row_template)
        self._names = sorted(tpl)
        self._leaves = [tpl[k] for k in self._names]
        self.registered = int(registered)
        self.page_size = max(int(page_size), 1)
        self.max_resident_pages = int(max_resident_pages or 0)
        self.spill_dir = spill_dir
        if self.max_resident_pages and not spill_dir:
            raise ValueError(
                "max_resident_pages needs a spill_dir: evicting a page "
                "without spill would drop client state")
        # client id -> dense slot, assigned on first WRITE (a gather of a
        # never-written id is a zero row and allocates nothing)
        self._slot: Dict[int, int] = {}
        # page id -> per-leaf (page_size, ...) arrays in LRU order (most
        # recently touched last)
        self._pages: "OrderedDict[int, List[np.ndarray]]" = OrderedDict()
        self._spilled: set = set()
        self._lock = threading.RLock()
        self.row_nbytes = sum(l.size * l.dtype.itemsize for l in self._leaves)
        self._stats = {"page_hits": 0, "page_misses": 0, "spills": 0,
                       "loads": 0, "page_in_bytes": 0}

    # -- templates ---------------------------------------------------------
    @property
    def row_template(self) -> Dict[str, np.ndarray]:
        return dict(zip(self._names, self._leaves))

    def _zeros_page(self) -> List[np.ndarray]:
        return [np.zeros((self.page_size,) + tuple(l.shape), l.dtype)
                for l in self._leaves]

    def _slots_of(self, ids, create: bool) -> np.ndarray:
        """Client ids -> dense slots; unknown or out-of-range ids map to -1
        (the zero-fill / drop sentinel of ``core.tree.page_groups``) unless
        ``create`` allocates them in touch order."""
        ids = np.asarray(ids, np.int64).ravel()
        out = np.full(len(ids), -1, np.int64)
        slot = self._slot
        for i, c in enumerate(ids.tolist()):
            if c < 0 or c >= self.registered:
                continue
            s = slot.get(c)
            if s is None and create:
                s = len(slot)
                slot[c] = s
            if s is not None:
                out[i] = s
        return out

    # -- paging ------------------------------------------------------------
    def _spill_path(self, pid: int) -> str:
        return os.path.join(self.spill_dir, f"page_{pid}.npz")

    def _page(self, pid: int) -> List[np.ndarray]:
        """The page's leaf arrays, made (zeros) or reloaded from spill as
        needed; touches the LRU order and the hit/miss counters."""
        with self._lock:
            page = self._pages.get(pid)
            if page is not None:
                self._pages.move_to_end(pid)
                self._stats["page_hits"] += 1
                return page
            self._stats["page_misses"] += 1
            if pid in self._spilled:
                with np.load(self._spill_path(pid)) as z:
                    page = [np.ascontiguousarray(z[f"leaf_{i}"])
                            for i in range(len(self._leaves))]
                self._spilled.discard(pid)
                self._stats["loads"] += 1
            else:
                page = self._zeros_page()
            self._stats["page_in_bytes"] += self.page_size * self.row_nbytes
            tr = get_tracer()
            if tr.enabled:
                tr.add_bytes("store.page_in_bytes",
                             self.page_size * self.row_nbytes)
            self._pages[pid] = page
            self._evict_over_cap()
            return page

    def _evict_over_cap(self):
        if not self.max_resident_pages:
            return
        while len(self._pages) > self.max_resident_pages:
            pid, page = self._pages.popitem(last=False)  # the LRU head
            os.makedirs(self.spill_dir, exist_ok=True)
            np.savez(self._spill_path(pid),
                     **{f"leaf_{i}": l for i, l in enumerate(page)})
            self._spilled.add(pid)
            self._stats["spills"] += 1

    def page_in(self, ids) -> int:
        """Make every page holding an already-written row of ``ids``
        resident (the pager runs this on its worker thread, so disk loads
        overlap device compute).  Returns the pages touched."""
        with self._lock:
            slots = self._slots_of(ids, create=False)
            slots = slots[slots >= 0]
            pids = np.unique(slots // self.page_size)
        tr = get_tracer()
        if tr.enabled:
            with tr.span("store.page_in", cat="staging",
                         pages=int(len(pids))):
                for pid in pids:
                    self._page(int(pid))
        else:
            for pid in pids:
                self._page(int(pid))
        return len(pids)

    # -- the cohort ops ----------------------------------------------------
    def gather(self, ids) -> Dict[str, np.ndarray]:
        """Cohort-stacked numpy rows for ``ids`` (never-written and
        out-of-range ids read zero without allocating)."""
        with self._lock:
            slots = self._slots_of(ids, create=False)
            return tree_util.rows_gather_np(
                self._page, slots, self.row_template, len(self._slot),
                self.page_size)

    def scatter(self, ids, new_rows: Mapping):
        """Write cohort-stacked rows back (numpy arrays or host tensors),
        allocating slots for first-seen ids; out-of-range ids drop."""
        new_rows = host_rows(new_rows)
        with self._lock:
            slots = self._slots_of(ids, create=True)
            tree_util.rows_scatter_np(self._page, slots, new_rows,
                                      len(self._slot), self.page_size)

    # -- accounting --------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        with self._lock:
            s = dict(self._stats)
            s["resident_pages"] = len(self._pages)
            s["spilled_pages"] = len(self._spilled)
            s["touched_rows"] = len(self._slot)
            s["resident_bytes"] = \
                len(self._pages) * self.page_size * self.row_nbytes
            total = s["page_hits"] + s["page_misses"]
            s["page_hit_rate"] = s["page_hits"] / total if total else 0.0
        return s

    def dense_nbytes(self) -> int:
        """What the dense table this store replaces would allocate."""
        return tree_util.client_table_nbytes(self.row_template,
                                             self.registered)

    # -- checkpoint / migration -------------------------------------------
    def to_checkpoint(self) -> Dict[str, np.ndarray]:
        """Flat npz-able payload: the written rows (ids and per-leaf
        stacked arrays, ``leaf_i`` in sorted-name order), sparse on disk as
        in memory."""
        with self._lock:
            ids = np.array(sorted(self._slot), np.int64)
            rows = self.gather(ids)
        payload = {"ids": ids,
                   "registered": np.asarray(self.registered, np.int64)}
        for i, name in enumerate(self._names):
            payload[f"leaf_{i}"] = rows[name]
        return payload

    def load_checkpoint(self, payload: Mapping):
        ids = np.asarray(payload["ids"], np.int64)
        self.scatter(ids, {name: payload[f"leaf_{i}"]
                           for i, name in enumerate(self._names)})

    def load_dense(self, table: Mapping):
        """Migrate a dense per-client table (a flat dict with a leading row
        axis) into the store: a dense checkpoint restores into a
        store-backed run unchanged."""
        table = host_rows(table)
        rows = next(iter(table.values())).shape[0]
        if rows > self.registered:
            raise ValueError(
                f"dense table has {rows} rows but the store registers "
                f"{self.registered} clients")
        self.scatter(np.arange(rows, dtype=np.int64), table)
