"""The port's multi-rank two-tier driver against the JAX package's, on
the same inputs and from the same weights (carried across by
``models/convert.py``), each side's ranks as threads over its ``local``
backend on the CPU.

``run_silo_federation`` at int8 with ``wire_overlap`` (error feedback on
each silo's partial link and on the combine tier's state-sync link):
per-round losses and final global params within 2e-5 of the JAX driver's,
on ``lr`` (``wire_block`` 16) and on a narrow text transformer (the
realtext shard; the default 256-element block), and the params every silo
receives in each round as far from the server's f32 params on both sides.
(``tests/test_torch_async_driver.py`` holds the one-worker async driver
against the JAX one in the same way.)

Run as a script, it prints the int8 and bf16 text gaps to the fp32 run
on both sides, and the state-sync errors, at widths 32, 64 and 128 (at
the phase's batch 16)::

    JAX_PLATFORMS=cpu python3 -m tests.test_torch_wire_drivers
"""

import pathlib

import numpy as np
import pytest
import torch

from fedml_tpu_torch.store.hierarchy import (HierarchicalSiloAPI,
                                             run_silo_federation)

from .torch_wire_parity import (TOL, SyncErrors, assert_params_close,
                                losses, pair)

REALTEXT = str(pathlib.Path(__file__).resolve().parents[1] / "data_shards"
               / "realtext")

#: tests/test_wire.py's two-tier harness config
SILO_LR = dict(dataset="synthetic", num_classes=4, input_shape=(8,),
               train_size=96, test_size=32, model="lr",
               client_num_in_total=8, client_num_per_round=4, comm_round=4,
               epochs=1, batch_size=8, learning_rate=0.1, random_seed=7,
               partition_method="homo", num_silos=2, wire_block=16,
               frequency_of_the_test=10 ** 9, data_cache_dir="",
               comm_recv_timeout_s=120.0)
#: chip_smoke.py phase 20's text federation (realtext, 4 clients over 2
#: silos, SGD at 0.1 with clip 1.0, 2 rounds, the default block) at a
#: narrow width and, to halve the steps, batch 32 (the script's sweep
#: runs the phase's 16)
SILO_TEXT = dict(dataset="realtext", model="text_transformer", seq_len=128,
                 vocab_size=8192, data_cache_dir=REALTEXT,
                 client_num_in_total=10, client_num_per_round=4,
                 batch_size=32, learning_rate=0.1, client_optimizer="sgd",
                 clip_grad_norm=1.0, partition_method="hetero",
                 partition_alpha=0.5, comm_round=2, num_silos=2,
                 frequency_of_the_test=10 ** 9, model_dim=32,
                 model_layers=1, model_heads=2, model_ffn_dim=64,
                 comm_recv_timeout_s=300.0)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Three ranks share the machine's cores in one process."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def silo_pair(monkeypatch, cfg, run_id):
    import fedml_tpu.store.hierarchy as j_hier
    ranks = list(range(int(cfg["num_silos"]), -1, -1))
    return pair(monkeypatch, cfg, run_id, j_hier, "HierarchicalSiloAPI",
                j_hier.run_silo_federation, HierarchicalSiloAPI,
                run_silo_federation, ranks)


@pytest.mark.parametrize("cfg", [SILO_LR, SILO_TEXT], ids=["lr", "text"])
def test_silo_federation_int8_matches_jax(monkeypatch, cfg):
    sync = SyncErrors(monkeypatch)
    j_hist, t_hist, j_params, t_params = silo_pair(
        monkeypatch, dict(cfg, wire_precision="int8", wire_overlap=True),
        f"wire_drv_{cfg['model']}")
    assert len(t_hist) == cfg["comm_round"]
    np.testing.assert_allclose(losses(t_hist), losses(j_hist), rtol=0,
                               atol=TOL)
    assert_params_close(t_params, j_params)
    # the state sync quantized, with its residual carried from round 0 on
    assert len(sync.port) == len(sync.jax) == cfg["comm_round"]
    assert min(sync.port) > 0
    np.testing.assert_allclose(sync.port, sync.jax, rtol=1e-3, atol=0)


def text_gaps(dim, layers):
    """The narrow text federation at fp32, int8 and bf16 on both sides:
    each precision's largest per-round loss gap to fp32, JAX's and the
    port's, and the largest gap between the two sides."""
    out = {}
    cfg = dict(SILO_TEXT, model_dim=dim, model_layers=layers,
               model_heads=max(2, dim // 32), model_ffn_dim=2 * dim,
               batch_size=16)
    runs = {}
    for prec in ("fp32", "int8", "bf16"):
        with pytest.MonkeyPatch.context() as mp:
            sync = SyncErrors(mp)
            j_hist, t_hist, _, _ = silo_pair(
                mp, dict(cfg, wire_precision=prec), f"gap_{dim}_{prec}")
        runs[prec] = (losses(j_hist), losses(t_hist), sync.jax, sync.port)
    for prec in ("int8", "bf16"):
        j, t, sj, sp = runs[prec]
        out[prec] = {
            "jax_gap": max(abs(x - y) for x, y in zip(j, runs["fp32"][0])),
            "port_gap": max(abs(x - y) for x, y in zip(t, runs["fp32"][1])),
            "port_vs_jax": max(abs(x - y) for x, y in zip(t, j)),
            "sync_err_jax": sj, "sync_err_port": sp}
    return out


if __name__ == "__main__":
    for dim, layers in ((32, 1), (64, 2), (128, 2)):
        for prec, r in text_gaps(dim, layers).items():
            print(f"dim {dim}, {layers} layer(s), {prec}: gap to fp32 JAX "
                  f"{r['jax_gap']:.3e} port {r['port_gap']:.3e}; port vs "
                  f"JAX {r['port_vs_jax']:.3e}; state-sync error by round "
                  f"JAX {r['sync_err_jax']} port {r['sync_err_port']}",
                  flush=True)
