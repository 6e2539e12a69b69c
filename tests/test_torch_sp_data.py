"""The sp path's host-side data copies give arrays EQUAL to the JAX
package's: the image generator, the LEAF reader on the committed digits
shard, the cohort index schedule and ``load()`` on every ported branch
(synthetic fallback at a small size, LEAF, ``.npz``, MNIST idx files,
CIFAR archives, sklearn digits)."""

import gzip
import json
import pathlib
import pickle
import struct

import jax  # noqa: F401  (JAX stays on the CPU, as tests/conftest.py sets)
import numpy as np
import pytest

from fedml_tpu.arguments import load_arguments as j_arguments
from fedml_tpu.data import data_loader as j_loader
from fedml_tpu.data import leaf as j_leaf
from fedml_tpu.data import synthetic as j_syn
from fedml_tpu.data.federated_dataset import FederatedDataset as JDataset
from fedml_tpu_torch.arguments import load_arguments as t_arguments
from fedml_tpu_torch.data import data_loader as t_loader
from fedml_tpu_torch.data import leaf as t_leaf
from fedml_tpu_torch.data import synthetic as t_syn
from fedml_tpu_torch.data.federated_dataset import FederatedDataset as TDataset

SHARDS = pathlib.Path(__file__).resolve().parents[1] / "data_shards"


def _same_dataset(jd, td):
    for name in ("train_x", "train_y", "test_x", "test_y"):
        a, b = getattr(jd, name), getattr(td, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert jd.num_classes == td.num_classes
    assert jd.provenance == td.provenance
    assert jd.client_idxs.keys() == td.client_idxs.keys()
    for c in jd.client_idxs:
        np.testing.assert_array_equal(jd.client_idxs[c], td.client_idxs[c])
    assert (jd.test_client_idxs is None) == (td.test_client_idxs is None)
    for c in (jd.test_client_idxs or {}):
        np.testing.assert_array_equal(jd.test_client_idxs[c],
                                      td.test_client_idxs[c])


@pytest.mark.parametrize("seed,shape,noise", [
    (0, (28, 28, 1), 0.35), (7, (8, 8, 1), 1.8), (3, (12,), 0.35),
    (11, (32, 32, 3), 0.5)])
def test_synthetic_images_bitwise(seed, shape, noise):
    for a, b in zip(
            j_syn.synthetic_image_classification(60, 13, 10, shape, seed,
                                                 noise),
            t_syn.synthetic_image_classification(60, 13, 10, shape, seed,
                                                 noise)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_leaf_digits_shard_bitwise():
    root = str(SHARDS / "digits")
    assert j_leaf.find_leaf_root(str(SHARDS), "digits") == \
        t_leaf.find_leaf_root(str(SHARDS), "digits") == root
    assert t_leaf.find_leaf_root(str(SHARDS), "femnist") is None
    a = j_leaf.load_leaf(root, input_shape=(8, 8, 1))
    b = t_leaf.load_leaf(root, input_shape=(8, 8, 1))
    for x, y in zip(a[:4], b[:4]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert b[0].shape == (1527, 8, 8, 1) and len(b[2]) == 270
    for ja, ta in zip(a[4:], b[4:]):
        assert ja.keys() == ta.keys() and len(ta) == 15
        for c in ja:
            np.testing.assert_array_equal(ja[c], ta[c])


def _write_leaf(root, users, rows):
    for split in ("train", "test"):
        (root / split).mkdir(parents=True)
        blob = {"users": users, "num_samples": [len(rows[u]) for u in users],
                "user_data": {u: {"x": rows[u], "y": rows[u][:]}
                              for u in users}}
        if split == "test":   # a user present only in the train split
            blob["users"] = users[1:]
        (root / split / "shard.json").write_text(json.dumps(blob))


def test_leaf_char_rows_bitwise(tmp_path):
    rows = {"u0": ["To be, or", "not}"], "u1": ["x\x00y"]}
    _write_leaf(tmp_path, ["u0", "u1"], rows)
    a = j_leaf.load_leaf(str(tmp_path), seq_len=6)
    b = t_leaf.load_leaf(str(tmp_path), seq_len=6)
    for x, y in zip(a[:4], b[:4]):
        np.testing.assert_array_equal(x, y)
    assert list(b[5][0]) == [] and list(b[5][1]) == [0]


def _ragged(seed):
    tx, ty, vx, vy = t_syn.synthetic_image_classification(200, 10, 5,
                                                          (4, 4, 1), seed)
    perm = np.random.default_rng(seed).permutation(200)
    idxs, off = {}, 0
    for c, n in enumerate([3, 9, 17, 40, 12, 1]):
        idxs[c] = np.sort(perm[off:off + n])
        off += n
    return JDataset(tx, ty, vx, vy, idxs, 5), TDataset(tx, ty, vx, vy,
                                                       idxs, 5)


@pytest.mark.parametrize("seed", [0, 5])
def test_cohort_indices_bitwise(seed):
    jd, td = _ragged(seed)
    for r in range(3):
        for epochs, max_steps in ((1, None), (2, None), (2, 3)):
            for a, b in zip(
                    jd.cohort_indices([0, 2, 3, 5], 4, seed, r, epochs,
                                      max_steps),
                    td.cohort_indices([0, 2, 3, 5], 4, seed, r, epochs,
                                      max_steps)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jd.client_sample_counts(),
                                  td.client_sample_counts())
    assert jd.stats() == td.stats()
    assert (jd.train_data_num, jd.test_data_num) == \
        (td.train_data_num, td.test_data_num)


def _load_both(**over):
    over.setdefault("data_cache_dir", "")
    jd, jn = j_loader.load(j_arguments().update(**over))
    td, tn = t_loader.load(t_arguments().update(**over))
    assert jn == tn
    _same_dataset(jd, td)
    return td


@pytest.mark.parametrize("over", [
    dict(dataset="femnist", train_size=300, test_size=40,
         client_num_in_total=10, partition_method="hetero"),
    dict(dataset="cifar10", train_size=100, test_size=20,
         client_num_in_total=4, partition_method="homo", random_seed=3),
    dict(dataset="synthetic", num_classes=4, input_shape=(12,),
         train_size=200, test_size=30, client_num_in_total=5,
         partition_alpha=0.3),
    dict(dataset="synthetic_mnist", train_size=64, test_size=16,
         client_num_in_total=4, synthetic_noise=1.2),
])
def test_load_synthetic_branches_bitwise(over):
    td = _load_both(**over)
    assert td.provenance == "synthetic"


def test_load_digits_leaf_and_sklearn_bitwise():
    td = _load_both(dataset="digits", data_cache_dir=str(SHARDS),
                    client_num_in_total=15)
    assert td.num_clients == 15 and td.train_x.shape == (1527, 8, 8, 1)
    assert td.provenance.startswith("real:sklearn-digits")
    pytest.importorskip("sklearn")
    td = _load_both(dataset="digits", client_num_in_total=20,
                    partition_method="hetero", random_seed=2)
    assert td.provenance == "real:sklearn-digits"


def _idx_file(path, arr):
    header = struct.pack(">HBB", 0, 8, arr.ndim) + struct.pack(
        f">{arr.ndim}I", *arr.shape)
    with gzip.open(path, "wb") as f:
        f.write(header + arr.astype(np.uint8).tobytes())


def test_load_cache_readers_bitwise(tmp_path):
    """``.npz`` (with a dataset-scoped provenance marker), MNIST idx files
    and both CIFAR-10 layouts, written small under a cache directory."""
    rng = np.random.default_rng(0)
    np.savez(tmp_path / "femnist.npz",
             train_x=rng.random((40, 28, 28, 1), np.float32),
             train_y=rng.integers(0, 62, 40), test_x=rng.random(
                 (8, 28, 28, 1), np.float32), test_y=rng.integers(0, 62, 8))
    (tmp_path / "PROVENANCE.femnist").write_text("synthetic:format-test")
    td = _load_both(dataset="femnist", data_cache_dir=str(tmp_path),
                    client_num_in_total=4)
    assert td.provenance == "synthetic:format-test"

    mn = tmp_path / "mn"
    (mn / "MNIST" / "raw").mkdir(parents=True)
    for name, shape in (("train-images-idx3-ubyte", (30, 28, 28)),
                        ("train-labels-idx1-ubyte", (30,)),
                        ("t10k-images-idx3-ubyte", (6, 28, 28)),
                        ("t10k-labels-idx1-ubyte", (6,))):
        _idx_file(mn / "MNIST" / "raw" / (name + ".gz"),
                  rng.integers(0, 10 if "labels" in name else 256, shape))
    td = _load_both(dataset="mnist", data_cache_dir=str(mn),
                    client_num_in_total=3, partition_method="homo")
    assert td.provenance == "real:cache" and td.train_x.shape[1:] == (28,
                                                                       28, 1)

    py = tmp_path / "cpy" / "cifar-10-batches-py"
    py.mkdir(parents=True)
    for name in ["data_batch_1", "data_batch_2", "test_batch"]:
        with open(py / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (10, 3072)),
                         b"labels": list(rng.integers(0, 10, 10))}, f)
    _load_both(dataset="cifar10", data_cache_dir=str(py.parent),
               client_num_in_total=2, partition_method="homo")

    bn = tmp_path / "cbin" / "cifar-10-batches-bin"
    bn.mkdir(parents=True)
    for name in ["data_batch_1.bin", "test_batch.bin"]:
        rng.integers(0, 256, 7 * 3073).astype(np.uint8).tofile(bn / name)
    _load_both(dataset="cifar10", data_cache_dir=str(bn.parent),
               client_num_in_total=2, partition_method="homo")


def test_lm_loader_refuses_a_cache_it_cannot_read(tmp_path):
    """A raw corpus too short for a train and a test window is refused as
    the JAX loader refuses it (the LM cache readers are ported)."""
    (tmp_path / "shakespeare.txt").write_text("To be, or not")
    msgs = []
    for loader, arguments in ((j_loader, j_arguments),
                              (t_loader, t_arguments)):
        with pytest.raises(ValueError, match="corpus too short") as err:
            loader.load(arguments().update(dataset="shakespeare",
                                           data_cache_dir=str(tmp_path)))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
