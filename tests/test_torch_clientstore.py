"""The port's client-state plane (``store/``, the sp engine's
``client_store`` / ``registered_clients`` / ``data_paging``, the adapter
cache mode) against the JAX package's, on the CPU, numpy-seeded:

- the store's gather, scatter, page-in, LRU spill and reload, stats and
  checkpoint payload bitwise the JAX store's on the same operations (a
  host numpy copy);
- the pager's asynchronous write-back ordered before every gather, and
  the row fetcher's dedup and error hand-off;
- a ``client_store`` run bitwise the dense-table run in the port
  (SCAFFOLD and FedDyn, and a fused block), and within the sp parity
  tolerance of ``tests/torch_sp_parity.py`` of the JAX store-backed run;
- ``registered_clients`` 10^6 stays sparse (the JAX sampling, touched rows
  only);
- ``data_paging`` bitwise the unpaged run;
- the adapter cache mode with fewer rows than adapters gives the
  bank-resident engine's streams, with misses and evictions counted;
- what stays unported is refused by name.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.simulation.sp.fedavg_api import FedAvgAPI as JFedAvgAPI
from fedml_tpu.store.clientstore import ClientStateStore as JStore
from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI as TFedAvgAPI
from fedml_tpu_torch.store import (AsyncRowFetcher, ClientStateStore,
                                   CohortStatePager)

from .torch_sp_parity import (TOL, base_args, build, port, port_tree,
                              tiny, tree_close)


def _template():
    return {"w": np.zeros((3, 2), np.float32), "b": np.zeros((2,),
                                                             np.float32)}


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


@pytest.mark.parametrize("cap", [0, 2])
def test_store_ops_are_bitwise_the_jax_store(tmp_path, cap):
    """The same random scatter / gather / page-in sequence (sentinel ids
    included) through both stores: every gather, the stats and the
    checkpoint payload equal, with and without the LRU spill."""
    rng = np.random.default_rng(0)
    n = 40
    kw = dict(registered=n, page_size=3, max_resident_pages=cap)
    jst = JStore(_template(), spill_dir=str(tmp_path / "j") if cap else None,
                 **kw)
    tst = ClientStateStore(_template(),
                           spill_dir=str(tmp_path / "t") if cap else None,
                           **kw)
    for step in range(6):
        cohort = np.concatenate([rng.choice(n, 6, replace=False), [n, -1]])
        new = {k: rng.normal(size=(len(cohort),) + v.shape).astype(v.dtype)
               for k, v in _template().items()}
        jst.scatter(cohort, new)
        tst.scatter(cohort, {k: torch.from_numpy(v) for k, v in new.items()})
        probe = rng.integers(-2, n + 2, 9)
        assert jst.page_in(probe) == tst.page_in(probe)
        _same(tst.gather(probe), jst.gather(probe))
    _same(tst.gather(np.arange(n)), jst.gather(np.arange(n)))
    jstats, tstats = jst.stats(), tst.stats()
    assert tstats == jstats
    if cap:
        assert tstats["spills"] > 0 and tstats["loads"] > 0
    _same(tst.to_checkpoint(), jst.to_checkpoint())
    assert tst.dense_nbytes() == jst.dense_nbytes()
    # never-written ids read zero without allocating a page
    fresh = ClientStateStore(_template(), registered=10 ** 6)
    assert float(np.abs(fresh.gather([5, 999_999])["w"]).max()) == 0
    assert fresh.stats()["resident_pages"] == 0
    with pytest.raises(ValueError, match="spill_dir"):
        ClientStateStore(_template(), 8, max_resident_pages=1)
    other = ClientStateStore(_template(), registered=n, page_size=5)
    other.load_checkpoint(tst.to_checkpoint())
    _same(other.gather(np.arange(n)), tst.gather(np.arange(n)))


def test_pager_orders_write_backs_before_gathers():
    store = ClientStateStore(_template(), registered=16, page_size=4)
    cohorts = {r: np.array([r % 16, (3 * r + 1) % 16]) for r in range(8)}
    pager = CohortStatePager(store, lambda r: cohorts[r], limit=8)
    ref = ClientStateStore(_template(), registered=16, page_size=4)
    try:
        for r in range(8):
            rows = pager.gather(r, cohorts[r], prefetch=r + 1)
            _same(rows, ref.gather(cohorts[r]))
            new = {k: torch.as_tensor(v + r + 1.0) for k, v in rows.items()}
            pager.write_back(r, cohorts[r], new)
            ref.scatter(cohorts[r], new)
            # the caller's tensors may change after the call: the staged
            # copy is what lands
            for v in new.values():
                v.zero_()
        pager.drain_writebacks()
        _same(store.gather(np.arange(16)), ref.gather(np.arange(16)))
        assert pager.stats()["stager_hits"] > 0
    finally:
        pager.close()

    done = threading.Event()
    fetcher = AsyncRowFetcher(on_done=lambda k: done.set())
    try:
        assert fetcher.request("a", lambda: 7)
        assert done.wait(10)
        assert not fetcher.request("a", lambda: 8)   # ready, not refetched
        assert fetcher.take("a") == (True, 7)
        assert fetcher.take("a") == (False, None)
        done.clear()
        fetcher.request("bad", lambda: 1 / 0)
        assert done.wait(10)
        with pytest.raises(ZeroDivisionError):
            fetcher.take("bad")
    finally:
        fetcher.close()


def _store_rows(api, ids):
    return api._store.gather(ids)


@pytest.mark.parametrize("opt,block", [("SCAFFOLD", 1), ("FedDyn", 1),
                                       ("SCAFFOLD", 2)])
def test_store_run_is_bitwise_the_dense_run(opt, block):
    over = dict(federated_optimizer=opt, round_block=block, comm_round=5,
                client_num_per_round=8)
    dense = port(TFedAvgAPI, base_args(**over))
    sparse = port(TFedAvgAPI, base_args(client_store=True, store_page_size=4,
                                        **over))
    dense.train()
    sparse.train()
    assert sparse.client_table is None
    for k, v in dense.state.global_params.items():
        assert torch.equal(v, sparse.state.global_params[k]), k
    rows = _store_rows(sparse, np.arange(dense.dataset.num_clients))
    for k, v in dense.client_table.items():
        np.testing.assert_array_equal(v.numpy(), rows[k], err_msg=k)
    assert sparse._store.stats()["touched_rows"] > 0


def test_store_run_matches_the_jax_store_run():
    cfg = tiny(federated_optimizer="SCAFFOLD", client_store=True,
               store_page_size=4, comm_round=3)
    japi, tapi, model = build(cfg, JFedAvgAPI, TFedAvgAPI)
    tapi.state = tapi.state.replace(
        global_params=port_tree(japi.state.global_params, model))
    for r in range(3):
        jm = japi.train_one_round(r)
        tm = tapi.train_one_round(r)
        assert abs(float(tm["train_loss"]) - float(jm["train_loss"])) < TOL
    japi._pager.drain_writebacks()
    tapi._pager.drain_writebacks()
    tree_close(tapi.state.global_params, japi.state.global_params, model,
               "params")
    ids = np.arange(tapi.dataset.num_clients)
    jrows = japi._store.gather(ids)
    trows = tapi._store.gather(ids)
    for i in ids:
        tree_close({k: torch.from_numpy(v[i]) for k, v in trows.items()},
                   jax.tree_util.tree_map(lambda l: l[i], jrows), model,
                   f"row {i}")
    assert tapi._store.stats()["touched_rows"] == \
        japi._store.stats()["touched_rows"]


def test_registered_million_ids_stay_sparse():
    """A 10^6-client id space over a 12-client dataset: cohorts sample the
    whole range (the JAX package's draws), state is keyed by registered
    id, and the host holds the touched rows only."""
    args = base_args(federated_optimizer="SCAFFOLD", client_store=True,
                     registered_clients=1_000_000, store_page_size=64,
                     comm_round=3)
    api = port(TFedAvgAPI, args)
    api.train()
    from fedml_tpu.core import rng as j_rng
    clients = np.unique(np.concatenate(
        [api._client_sampling(r) for r in range(3)]))
    for r in range(3):
        np.testing.assert_array_equal(
            api._client_sampling(r),
            j_rng.sample_clients(api.seed, r, 1_000_000,
                                 api.clients_per_round))
    assert clients.max() >= api.dataset.num_clients
    st = api._store.stats()
    assert st["touched_rows"] == len(clients)
    assert st["resident_bytes"] < 2 ** 22
    assert api._store.dense_nbytes() > 2 ** 30
    rows = api._store.gather(clients)
    assert max(float(np.abs(v).max()) for v in rows.values()) > 0
    with pytest.raises(ValueError, match="registered_clients"):
        port(TFedAvgAPI, base_args(registered_clients=4))


def test_data_paging_is_bitwise_unpaged():
    over = dict(federated_optimizer="FedAvg", comm_round=3)
    plain = port(TFedAvgAPI, base_args(device_data=False, **over))
    paged = port(TFedAvgAPI, base_args(data_paging=True, data_page_size=32,
                                       **over))
    assert not hasattr(paged, "_dev_x")
    plain.train()
    paged.train()
    for k, v in plain.state.global_params.items():
        assert torch.equal(v, paged.state.global_params[k]), k
    assert [m["train_loss"] for m in plain.metrics_history] == \
        [m["train_loss"] for m in paged.metrics_history]
    assert paged._data_store.stats()["touched_rows"] == \
        len(paged.dataset.train_x)


def test_state_plane_refusals():
    with pytest.raises(ValueError, match="population"):
        port(TFedAvgAPI, base_args(federated_optimizer="SCAFFOLD",
                                   client_store=True, population=2))
    from fedml_tpu_torch.simulation.sp.hierarchical_fl import \
        HierarchicalFedAvgAPI
    with pytest.raises(NotImplementedError, match="client_store"):
        port(HierarchicalFedAvgAPI, base_args(client_store=True))


# -- the adapter cache mode ---------------------------------------------------

def test_adapter_cache_mode_gives_the_bank_streams():
    """Four adapters through a 3-row cache (2 usable rows): rows miss, page
    in and evict, and every stream equals the bank-resident engine's."""
    import dataclasses

    from fedml_tpu_torch.llm import model as tm
    from fedml_tpu_torch.serving.batching import ContinuousBatchingEngine

    cfg = dataclasses.replace(tm.TINY, lora_rank=4, max_seq_len=48,
                              attn_impl="blockwise")
    model = tm.LlamaLM(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    loras = {f"a{i}": {k: torch.from_numpy(
        (0.5 * rng.standard_normal(s)).astype(np.float32))
        for k, s in model.lora_shapes().items()} for i in range(4)}
    order = ["a0", "a1", "a2", "a3", "a0", None, "a2", "a1"]
    prompt = [5, 17, 42]

    def streams(**kw):
        eng = ContinuousBatchingEngine(model, None, slots=2, buf_len=32,
                                       **kw)
        try:
            for name, tree in loras.items():
                eng.registry.register(name, tree)
            out = [eng.generate(prompt, max_new_tokens=6, adapter=a)
                   for a in order]
            return out, dict(eng.registry.stats)
        finally:
            eng.stop()

    want, _ = streams(adapter_slots=8)
    got, st = streams(adapter_cache_slots=3)
    assert got == want
    assert len({tuple(w) for w in want}) >= 4     # the adapters differ
    assert st["cache_misses"] >= 4 and st["cache_evictions"] >= 2
    assert st["cache_hits"] >= len([a for a in order if a])
    eng = ContinuousBatchingEngine(model, None, slots=1, buf_len=32,
                                   adapter_cache_slots=3)
    try:
        with pytest.raises(KeyError):
            eng.submit(prompt, adapter="nope")
    finally:
        eng.stop()


def test_store_survives_concurrent_writers_and_page_ins(tmp_path):
    """Writers on disjoint ids, a page-in thread and readers share one
    store with the LRU spill on and a short switch interval: every row
    ends at its writer's last value (a lost slot or page would not)."""
    import sys

    store = ClientStateStore(_template(), registered=256, page_size=4,
                             max_resident_pages=3, spill_dir=str(tmp_path))
    n_threads, steps = 8, 15
    errors = []

    def writer(t):
        try:
            ids = np.arange(t, 256, n_threads)
            for v in range(steps):
                store.scatter(ids, {"w": np.full((len(ids), 3, 2), v + t,
                                                 np.float32),
                                    "b": np.full((len(ids), 2), v,
                                                 np.float32)})
                store.gather(ids[::3])
        except Exception as e:   # noqa: BLE001 — reported by the test
            errors.append(e)

    def pager():
        rng = np.random.default_rng(1)
        for _ in range(200):
            store.page_in(rng.integers(0, 256, 16))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=writer, args=(t,))
                   for t in range(n_threads)]
        threads.append(threading.Thread(target=pager))
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    rows = store.gather(np.arange(256))
    want_w = (steps - 1 + np.arange(256) % n_threads).astype(np.float32)
    np.testing.assert_array_equal(rows["w"][:, 0, 0], want_w)
    np.testing.assert_array_equal(rows["b"][:, 0], steps - 1)
    assert store.stats()["touched_rows"] == 256
