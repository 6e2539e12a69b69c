"""The port's serverless and vertical cross-silo managers
(``cross_silo/decentralized_manager.py``, ``cross_silo/vertical_manager.py``)
as threads over the ``local`` backend, mirroring the JAX package's
``tests/test_cross_silo.py`` gossip and VFL tests, and held to the JAX
managers from the same weights.

- gossip: 4 peers on a symmetric ring, every peer finishes its rounds,
  the peers reach consensus and learn; from the JAX peers' initial weights
  each peer's final model is the JAX peer's within 1e-5;
- VFL: a guest and 2 hosts; the loss falls, the joint model beats the
  guest's alone, and the guest's losses are the JAX guest's from the same
  towers.
"""

import threading
import types

import numpy as np
import torch

import fedml_tpu_torch
from fedml_tpu_torch import data as t_data
from fedml_tpu_torch import model as t_model
from fedml_tpu_torch.core.distributed.communication.local import (
    local_comm_manager)
from fedml_tpu_torch.core.distributed.topology.topology_manager import (
    SymmetricTopologyManager)
from fedml_tpu_torch.cross_silo.decentralized_manager import (
    DecentralizedWorkerManager)
from fedml_tpu_torch.cross_silo.vertical_manager import (VflGuestManager,
                                                         VflHostManager)
from fedml_tpu_torch.models.convert import from_flax

JOIN_S = 60.0
#: tests/test_cross_silo.py's make_args, 4 peers
GOSSIP = dict(dataset="synthetic", num_classes=10, input_shape=(14, 14, 1),
              train_size=512, test_size=128, model="lr",
              client_num_in_total=4, client_num_per_round=4, epochs=1,
              batch_size=16, learning_rate=0.1, random_seed=11,
              data_cache_dir="", frequency_of_the_test=10 ** 9)
PEERS = 4
PARITY_TOL = 1e-5


def run_threads(fn, ranks, run_id):
    errors = []

    def guard(r):
        try:
            fn(r)
        except BaseException as e:   # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=guard, args=(r,), daemon=True)
               for r in ranks]
    for t in threads:
        t.start()
    try:
        for t in threads:
            t.join(timeout=JOIN_S)
    finally:
        local_comm_manager.reset_run(run_id)
    if errors:
        raise errors[0]
    assert not any(t.is_alive() for t in threads), "federation deadlocked"


def jax_gossip(rounds, run_id):
    from fedml_tpu import data as j_data
    from fedml_tpu import model as j_model
    from fedml_tpu.arguments import load_arguments
    from fedml_tpu.core.distributed.topology.topology_manager import (
        SymmetricTopologyManager as JTopo)
    from fedml_tpu.cross_silo.decentralized_manager import (
        DecentralizedWorkerManager as JPeer)

    topo = JTopo(PEERS, 2)
    topo.generate_topology()
    managers, inits = [None] * PEERS, [None] * PEERS

    def peer(rank):
        args = load_arguments().update(**dict(
            GOSSIP, comm_round=rounds, rank=rank, run_id=run_id,
            backend="local"))
        ds, n = j_data.load(args)
        mgr = JPeer(args, ds, j_model.create(args, n), rank=rank,
                    size=PEERS, backend="local", topology=topo)
        inits[rank] = mgr.params
        managers[rank] = mgr
        mgr.run()

    run_threads(peer, range(PEERS), run_id)
    return managers, inits


def port_gossip(rounds, run_id, inits=None):
    topo = SymmetricTopologyManager(PEERS, 2)
    managers = [None] * PEERS
    for r in range(PEERS):
        a = fedml_tpu_torch.load_arguments().update(**dict(
            GOSSIP, comm_round=rounds, rank=r, run_id=run_id,
            backend="local"))
        ds, n = t_data.load(a)
        model = t_model.create(a, n)
        mgr = DecentralizedWorkerManager(a, ds, model, rank=r, size=PEERS,
                                         backend="local", topology=topo,
                                         device="cpu")
        if inits is not None:
            mgr.params = from_flax(inits[r], model, device="cpu")
        managers[r] = mgr
    run_threads(lambda r: managers[r].run(), range(PEERS), run_id)
    return managers


def flat(params):
    return torch.cat([v.reshape(-1) for v in params.values()])


def test_gossip_peers_reach_consensus_and_learn():
    managers = port_gossip(12, "t_p2p")
    assert all(m.round_idx == 12 for m in managers)
    f0 = flat(managers[0].params)
    norm0 = float(torch.linalg.norm(f0))
    assert norm0 > 1e-3
    for other in managers[1:]:
        rel = float(torch.linalg.norm(f0 - flat(other.params))) / norm0
        assert rel < 0.5, rel
    init = managers[0].model.init(torch.Generator())
    assert not torch.equal(f0, flat(init))


def test_gossip_matches_jax_peers():
    import jax

    jm, inits = jax_gossip(3, "t_p2p_jax")
    pm = port_gossip(3, "t_p2p_port",
                     [jax.device_get(p) for p in inits])
    for j, p in zip(jm, pm):
        want = from_flax(jax.device_get(j.params), p.model, device="cpu")
        for k, v in want.items():
            np.testing.assert_allclose(p.params[k].numpy(), v.numpy(),
                                       rtol=0, atol=PARITY_TOL)


def vfl(pkg, feats, labels, rounds=12, towers=None):
    """A guest and 2 hosts as threads; returns the managers by rank."""
    args = types.SimpleNamespace(run_id=f"t_vfl_{pkg}", batch_size=50,
                                 comm_round=rounds, learning_rate=0.3,
                                 random_seed=0, device="cpu")
    if pkg == "jax":
        from fedml_tpu.cross_silo.vertical_manager import (
            VflGuestManager as Guest, VflHostManager as Host)
        extra = {}
    else:
        Guest, Host, extra = VflGuestManager, VflHostManager, dict(
            device="cpu")
    held = {0: Guest(args, feats[0], labels, 4, size=3, backend="local",
                     **extra)}
    for r in (1, 2):
        held[r] = Host(args, feats[r], 4, rank=r, size=3, backend="local",
                       **extra)
    if towers is not None:
        for r, w in towers.items():
            held[r].model.w = torch.tensor(w)
    run_threads(lambda r: held[r].run(), (0, 1, 2), args.run_id)
    return held


def test_vertical_split_learning_learns_and_matches_jax():
    import jax

    from fedml_tpu.core import rng as j_rng
    from fedml_tpu.data.synthetic import synthetic_vertical_parties

    feats, labels = synthetic_vertical_parties(600, 3, [6, 6, 6],
                                               classes=4, seed=0)
    # the JAX towers' initial weights: N(0, 0.01²) from the guest's and
    # each host's purpose key
    init = {r: 0.01 * np.asarray(jax.random.normal(
        j_rng.purpose_key(j_rng.root_key(0), f"vfl{r}"), (6, 4)))
        for r in range(3)}
    jax_held = vfl("jax", feats, labels, rounds=3)
    towers = {r: np.asarray(jax_held[r].model.w) for r in range(3)}
    port_held = vfl("port", feats, labels, rounds=3, towers=init)
    np.testing.assert_allclose(port_held[0].losses, jax_held[0].losses,
                               rtol=0, atol=PARITY_TOL)
    for r in range(3):
        np.testing.assert_allclose(port_held[r].model.w.numpy(), towers[r],
                                   rtol=0, atol=PARITY_TOL)

    g = vfl("port", feats, labels)
    assert g[0].losses[-1] < g[0].losses[0]
    x = [torch.as_tensor(f.reshape(len(labels), -1), dtype=torch.float32)
         for f in feats]
    joint = sum(g[r].model.forward(x[r]) for r in range(3))
    acc = lambda logits: float((torch.argmax(logits, -1).numpy()
                                == labels).mean())
    acc_joint, acc_guest = acc(joint), acc(g[0].model.forward(x[0]))
    assert acc_joint > max(acc_guest, 0.5), (acc_guest, acc_joint)
