"""The port's host-side copies give arrays EQUAL to the JAX package's:
Philox streams, client sampling, partitions, synthetic LM tokens, the
cohort batch schedule and the LM loader."""

import jax  # noqa: F401  (JAX stays on the CPU, as tests/conftest.py sets)
import numpy as np
import pytest
import torch

from fedml_tpu.core import hostrng as j_hostrng
from fedml_tpu.core import rng as j_rng
from fedml_tpu.core.data import noniid_partition as j_part
from fedml_tpu.data import data_loader as j_loader
from fedml_tpu.data import synthetic as j_syn
from fedml_tpu.data.federated_dataset import FederatedDataset as JDataset
from fedml_tpu_torch.core import hostrng as t_hostrng
from fedml_tpu_torch.core import rng as t_rng
from fedml_tpu_torch.core.data import noniid_partition as t_part
from fedml_tpu_torch.data import data_loader as t_loader
from fedml_tpu_torch.data import synthetic as t_syn
from fedml_tpu_torch.data.federated_dataset import FederatedDataset as TDataset

SEEDS = [0, 7, 12345]


@pytest.mark.parametrize("seed", SEEDS)
def test_hostrng_streams_bitwise(seed):
    for words in ((seed,), (seed, 3, 0xC11E), (seed, 2**63 + 5, -1)):
        a = j_hostrng.gen(*words)
        b = t_hostrng.gen(*words)
        np.testing.assert_array_equal(a.integers(0, 2**62, 64),
                                      b.integers(0, 2**62, 64))
        np.testing.assert_array_equal(a.random(16), b.random(16))


@pytest.mark.parametrize("seed", SEEDS)
def test_sample_clients_equal(seed):
    for r in range(5):
        for n, k in ((100, 10), (6, 3), (4, 8)):
            np.testing.assert_array_equal(
                j_rng.sample_clients(seed, r, n, k),
                t_rng.sample_clients(seed, r, n, k))


@pytest.mark.parametrize("seed", SEEDS)
def test_partition_equal(seed):
    y = np.random.default_rng(seed).integers(0, 5, size=300)
    for method in ("homo", "hetero"):
        a = j_part.partition(y, 8, method, 0.5, seed)
        b = t_part.partition(y, 8, method, 0.5, seed)
        assert a.keys() == b.keys()
        for c in a:
            np.testing.assert_array_equal(a[c], b[c])


@pytest.mark.parametrize("seed", SEEDS)
def test_synthetic_lm_tokens_equal(seed):
    for a, b in zip(j_syn.synthetic_lm_tokens(40, 8, 90, 33, seed),
                    t_syn.synthetic_lm_tokens(40, 8, 90, 33, seed)):
        np.testing.assert_array_equal(a, b)


def _datasets(seed, sizes):
    tx, ty, vx, vy = t_syn.synthetic_lm_tokens(200, 10, 90, 16, seed)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(200)
    idxs, off = {}, 0
    for c, n in enumerate(sizes):
        idxs[c] = np.sort(perm[off:off + n])
        off += n
    return (JDataset(tx, ty, vx, vy, idxs, 90),
            TDataset(tx, ty, vx, vy, idxs, 90))


@pytest.mark.parametrize("seed", SEEDS)
def test_cohort_schedule_equal(seed):
    jd, td = _datasets(seed, [3, 9, 17, 40, 12])   # ragged: masked steps
    for r in range(3):
        clients = t_rng.sample_clients(seed, r, 5, 3)
        for a, b in zip(jd.cohort_batches(clients, 4, seed, r, 2,
                                          max_steps=6),
                        td.cohort_batches(clients, 4, seed, r, 2,
                                          max_steps=6)):
            np.testing.assert_array_equal(a, b)
        for c in clients:
            np.testing.assert_array_equal(
                jd.client_index_batches(c, 4, seed, r),
                td.client_index_batches(c, 4, seed, r))
    for a, b in zip(jd.test_batches(4), td.test_batches(4)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jd.pack_per_client(4), td.pack_per_client(4)):
        np.testing.assert_array_equal(a, b)


def test_lm_loader_equal():
    from fedml_tpu.arguments import load_arguments as j_args
    from fedml_tpu_torch.arguments import load_arguments as t_args

    over = dict(dataset="shakespeare", seq_len=24, train_size=120,
                test_size=10, client_num_in_total=6, random_seed=3,
                data_cache_dir="")
    jd, jv = j_loader.load(j_args().update(**over))
    td, tv = t_loader.load(t_args().update(**over))
    assert jv == tv == 90 and td.provenance == jd.provenance == "synthetic"
    for name in ("train_x", "train_y", "test_x", "test_y"):
        np.testing.assert_array_equal(getattr(jd, name), getattr(td, name))
    for c in jd.client_idxs:
        np.testing.assert_array_equal(jd.client_idxs[c], td.client_idxs[c])


def test_purpose_keys_are_independent_and_reproducible():
    root = t_rng.root_key(5)
    a = torch.randn(4, generator=t_rng.purpose_key(root, "init"))
    b = torch.randn(4, generator=t_rng.purpose_key(t_rng.root_key(5), "init"))
    c = torch.randn(4, generator=t_rng.purpose_key(root, "lora"))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
