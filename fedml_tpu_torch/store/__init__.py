"""The client-state plane (port of ``fedml_tpu.store``'s store and pager).

A dense per-client state table (``core/tree.py``) holds ``registered ×
|row|`` on the device whether or not a client was ever sampled.  With
``args.client_store`` the sp engines keep per-client algorithm state
(SCAFFOLD control variates, FedDyn residuals) in a host-side sparse store
instead: rows live in fixed-size pages keyed by client id, pages are made
on first touch, an LRU cap spills cold pages to disk, and only the active
cohort's rows reach the device.  Page-in runs on the cohort stager's
worker thread and write-back is asynchronous; the round sees the same
cohort-stacked rows the dense table gave it.

``hierarchy.py`` holds the two-tier silo aggregation (``num_silos > 1``):
the in-process :class:`HierarchicalSiloAPI` and the multi-rank
``run_silo_federation``.
"""

from .clientstore import ClientStateStore
from .hierarchy import HierarchicalSiloAPI, run_silo_federation
from .pager import AsyncRowFetcher, CohortStatePager


__all__ = ["AsyncRowFetcher", "ClientStateStore", "CohortStatePager",
           "HierarchicalSiloAPI", "run_silo_federation"]
