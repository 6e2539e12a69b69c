"""Helpers over flat ``{path: tensor}`` dicts — the port's stand-in for the
JAX package's pytree utilities (``fedml_tpu.core.tree``), limited to what
the ported rounds use, and the dense per-client state table (SCAFFOLD
c_i / FedDyn ∇̂_i) with its cohort gather and scatter."""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch

TensorDict = Dict[str, torch.Tensor]


def tree_map(fn: Callable, tree: TensorDict, *rest: TensorDict) -> TensorDict:
    return {k: fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def tree_zeros_like(tree: TensorDict) -> TensorDict:
    return tree_map(torch.zeros_like, tree)


def tree_add(a: TensorDict, b: TensorDict) -> TensorDict:
    return tree_map(torch.add, a, b)


def tree_sub(a: TensorDict, b: TensorDict) -> TensorDict:
    return tree_map(torch.sub, a, b)


def tree_scale(tree: TensorDict, s) -> TensorDict:
    return tree_map(lambda x: x * s, tree)


def tree_axpy(a, x: TensorDict, y: TensorDict) -> TensorDict:
    """``a*x + y`` per leaf."""
    return tree_map(lambda xi, yi: a * xi + yi, x, y)


def tree_dot(a: TensorDict, b: TensorDict) -> torch.Tensor:
    """f32 sum over leaves of each leaf pair's dot product."""
    return sum(torch.sum(x.to(torch.float32) * b[k].to(torch.float32))
               for k, x in a.items())


def tree_sq_norm(tree: TensorDict) -> torch.Tensor:
    return tree_dot(tree, tree)


def tree_stack(trees) -> TensorDict:
    """Stack identically-keyed dicts along a new leading axis."""
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def stacked_weighted_average(stacked: TensorDict, weights) -> TensorDict:
    """Weighted average over the leading (client) axis of a stacked dict:
    the weights are normalised, then one f32 ``tensordot`` per leaf."""
    w = torch.as_tensor(weights, dtype=torch.float32)
    w = w / torch.sum(w)
    return tree_map(lambda leaf: torch.tensordot(
        w, leaf.to(torch.float32), dims=1).to(leaf.dtype), stacked)


def weighted_average(trees, weights) -> TensorDict:
    """Weighted FedAvg merge of a list of identically-keyed dicts (the
    JAX package's ``weighted_average``): stacked, then
    :func:`stacked_weighted_average` with the weights on the leaves'
    device."""
    dev = next(iter(trees[0].values())).device
    return stacked_weighted_average(
        tree_stack(trees),
        torch.as_tensor(weights, dtype=torch.float32, device=dev))


def flatten(tree: Mapping, prefix: str = "") -> dict:
    """Nested dict → ``{"a/b/c": leaf}``."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten(v, path + "/"))
        else:
            out[path] = v
    return out


def unflatten(flat: Mapping) -> dict:
    """Inverse of :func:`flatten`."""
    out: dict = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


# -- dense per-client state table (SCAFFOLD c_i / FedDyn residuals) ----------
# Every leaf gains a leading (num_clients,) row axis and lives on the device;
# a round gathers its cohort's rows and scatters the updated rows back.
# Cohort ids are host integers.  A torch index out of range raises (CPU) or
# device-asserts (CUDA) instead of filling or dropping as XLA does, so the
# in-range positions are picked on the host; ids are never clamped, since a
# clamped sentinel would read and overwrite the last real client's row.

def client_table_init(params: TensorDict, rows: int) -> TensorDict:
    """Zero table of per-client state: one row per client, shaped like
    ``params`` per row."""
    return tree_map(lambda p: torch.zeros((rows,) + tuple(p.shape),
                                          dtype=p.dtype, device=p.device),
                    params)


def _in_range(table: TensorDict, cohort, axis: int = 0):
    """(positions in the cohort, their ids) of the ids that name a row,
    as index tensors on the table's device."""
    ids = np.asarray(cohort, dtype=np.int64).reshape(-1)
    rows = next(iter(table.values())).shape[axis]
    pos = np.nonzero((ids >= 0) & (ids < rows))[0]
    dev = next(iter(table.values())).device
    return (torch.as_tensor(pos, device=dev),
            torch.as_tensor(ids[pos], device=dev))


def cohort_gather(table: TensorDict, cohort, axis: int = 0) -> TensorDict:
    """Rows ``cohort`` of the table stacked on a cohort axis in place of
    the row axis ``axis`` (1 for a population's member-stacked table); an
    out-of-range id (the padded-cohort sentinel) reads as a zero row."""
    pos, ids = _in_range(table, cohort, axis)
    n = len(np.asarray(cohort).reshape(-1))

    def gather(t):
        shape = list(t.shape)
        shape[axis] = n
        return torch.zeros(shape, dtype=t.dtype, device=t.device).index_copy_(
            axis, pos, t.index_select(axis, ids))

    return tree_map(gather, table)


def cohort_scatter(table: TensorDict, cohort, new_rows: TensorDict,
                   axis: int = 0) -> TensorDict:
    """The table with the cohort's rows replaced by ``new_rows``; an
    out-of-range id is dropped."""
    pos, ids = _in_range(table, cohort, axis)
    return tree_map(lambda t, n: t.index_copy(
        axis, ids, n.index_select(axis, pos).to(t.dtype)), table, new_rows)


def client_table_nbytes(row: Mapping, rows: int) -> int:
    """Bytes a dense ``rows``-client state table of rows shaped like
    ``row`` (numpy arrays) would take: the number the sparse store
    (``store/clientstore.py``) exists not to allocate."""
    return rows * sum(np.asarray(x).nbytes for x in row.values())


# -- sparse host-side row ops (store/) ---------------------------------------
# The paged client-state store keeps rows as numpy pages on the host, keyed
# by client id.  These are the numpy twins of cohort_gather/cohort_scatter
# with the same out-of-range semantics (reads fill zero, writes drop), over
# flat ``{name: array}`` rows whose leaves go in sorted name order.

def page_groups(ids, page_size: int, n_rows: int):
    """Group the in-range entries of ``ids`` by page: yields ``(page_id,
    in_page_rows, cohort_positions)``, so a paged gather or scatter touches
    each page once.  Ids outside ``[0, n_rows)`` are skipped."""
    ids = np.asarray(ids, np.int64)
    pos_all = np.nonzero((ids >= 0) & (ids < n_rows))[0]
    pids = ids[pos_all] // page_size
    for pid in np.unique(pids):
        pos = pos_all[pids == pid]
        yield int(pid), ids[pos] - int(pid) * page_size, pos


def rows_gather_np(pages_get, ids, template: Mapping, n_rows: int,
                   page_size: int) -> Dict[str, np.ndarray]:
    """Rows ``ids`` of a paged host store stacked on a leading cohort axis.
    ``pages_get(page_id)`` returns the page's per-leaf ``(page_size, ...)``
    list (sorted-name order); ``template`` fixes the row shapes and
    dtypes.  Out-of-range ids read as zero rows."""
    ids = np.asarray(ids, np.int64)
    names = sorted(template)
    out = [np.zeros((len(ids),) + tuple(np.shape(template[k])),
                    np.asarray(template[k]).dtype) for k in names]
    for pid, rows, pos in page_groups(ids, page_size, n_rows):
        page = pages_get(pid)
        for leaf_out, leaf_page in zip(out, page):
            leaf_out[pos] = leaf_page[rows]
    return dict(zip(names, out))


def rows_scatter_np(pages_get, ids, new_rows: Mapping, n_rows: int,
                    page_size: int) -> None:
    """Write cohort-stacked ``new_rows`` into the paged host store; ids
    outside ``[0, n_rows)`` drop."""
    leaves = [new_rows[k] for k in sorted(new_rows)]
    for pid, rows, pos in page_groups(ids, page_size, n_rows):
        page = pages_get(pid)
        for leaf_page, leaf_new in zip(page, leaves):
            leaf_page[rows] = np.asarray(leaf_new)[pos].astype(
                leaf_page.dtype)


def host_copy_tree(tree: Any):
    """Start copying a tree's card tensors to pinned host memory on the
    current stream: ``(host_tree, event)``, the event recorded after the
    copies (None when nothing lives on the card).  A writer thread waits
    on the event before it reads the copies, so it never sees a tensor a
    later launch overwrites."""
    pending = []

    def copy(x):
        if isinstance(x, dict):
            return {k: copy(v) for k, v in x.items()}
        if isinstance(x, torch.Tensor):
            x = x.detach()
            if x.is_cuda:
                h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                h.copy_(x, non_blocking=True)
                pending.append(h)
                return h
            return x.clone()
        if isinstance(x, np.ndarray):
            return np.array(x)
        return x

    out = copy(tree)
    event = None
    if pending:
        event = torch.cuda.Event()
        event.record()
    return out, event
