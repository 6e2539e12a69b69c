"""Card-only tests of the port: the CUDA kernels K1/K2/K3 against their
plain PyTorch versions on the same inputs, and the sp FedAvg rounds on the
card against the CPU.  They skip where no CUDA device is visible; on the
card run them with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: tests/conftest.py sets up JAX, which the card's machine
does not have; this file imports neither JAX nor the JAX package.)

The f32 tile product of K2 and K3 (3xTF32 ``mma.sync``,
``csrc/flash_tf32.cuh``) is also checked alone, in each operand layout at
the kernels' tile shapes, against a float64 product, and so is K1's f32
P·V product, whose A operand is S's C fragment in registers.

Tolerance: ``attention.KERNEL_TOL`` through ``compare_with_plain`` — per
element ``|kernel − plain| <= atol + rtol·|plain|`` and per 64-row block
``‖kernel − plain‖ <= nrel·‖plain‖``, with (atol, rtol, nrel) =
(2e-3, 1.6e-2, 1e-2) in bf16 (both versions round P and dS to bf16 before
their products, at other points of the online softmax, and round their
outputs to bf16) and (1e-5, 1e-4, 1e-4) in f32.  sp rounds (FedAvg and
every algorithm of the zoo): f32 with TF32 off, global params, round
losses, server state and per-client state rows within 1e-6 on ``lr`` and
``cnn_web`` (a TF32 run reads 5e-6 and 5e-5 on FedAvg's).  The CNN dropout
rounds hold scan ≡ vmap to 1e-4 (cuDNN's convolution backward sums in
another order, and not reproducibly).
"""

import pathlib

import numpy as np
import pytest
import torch

from fedml_tpu_torch.ops import attention as tatt

SHARDS = str(pathlib.Path(__file__).resolve().parents[1] / "data_shards")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (none visible)")
    return torch.device("cuda")


def _inputs(b, h, hkv, s, d, dtype, device, seed=0, sk=None):
    """q, k, v, dO; k and v have ``sk`` rows (default ``s``)."""
    rng = np.random.default_rng(seed)
    mk = lambda *shape: torch.tensor(
        rng.standard_normal(shape).astype(np.float32), device=device,
        dtype=dtype)
    sk = s if sk is None else sk
    return (mk(b, h, s, d), mk(b, hkv, sk, d), mk(b, hkv, sk, d),
            mk(b, h, s, d))


def _close(got, ref):
    st = tatt.compare_with_plain(got, ref)
    assert st["elem"] <= 1 and st["block"] <= 1, st


def _kernels_vs_plain(device, dtype, b, h, hkv, s, d, causal, sk=None):
    dt = getattr(torch, dtype)
    q, k, v, do = _inputs(b, h, hkv, s, d, dt, device, sk=sk)
    tatt.reset_launch_counts()
    o, lse = tatt.flash_attention_fwd(q, k, v, causal)
    po, plse = tatt.flash_attention_fwd_plain(q, k, v, causal)
    dq, delta = tatt.flash_attention_bwd_dq(q, k, v, o, lse, do, causal)
    pdq, pdelta = tatt.flash_attention_bwd_dq_plain(q, k, v, o, lse, do,
                                                    causal)
    dk, dv = tatt.flash_attention_bwd_dkv(q, k, v, lse, delta, do, causal)
    pdk, pdv = tatt.flash_attention_bwd_dkv_plain(q, k, v, lse, delta, do,
                                                  causal)
    torch.cuda.synchronize()
    assert [f.launches for f in tatt.KERNELS] == [1, 1, 1]
    for got, ref in ((o, po), (lse, plse), (delta, pdelta), (dq, pdq),
                     (dk, pdk), (dv, pdv)):
        _close(got, ref)
    # the autograd Function runs the same three kernels: bitwise the same
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = tatt.flash_attention(*leaves, causal)
    grads = torch.autograd.grad(out, leaves, do)
    assert all(map(torch.equal, (out, *grads), (o, dq, dk, dv)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,h,hkv,s,d,causal", [
    (1, 8, 2, 200, 64, True), (1, 8, 2, 200, 64, False),
    (2, 4, 4, 128, 128, True), (1, 2, 1, 1000, 128, False)])
def test_kernels_match_plain_on_card(cuda_device, dtype, b, h, hkv, s, d,
                                     causal):
    _kernels_vs_plain(cuda_device, dtype, b, h, hkv, s, d, causal)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,hkv,s,d", [
    (1, 4, 1, 64, 64), (2, 4, 1, 129, 128), (1, 8, 2, 1000, 64),
    (1, 4, 1, 1000, 128), (1, 4, 1, 2048, 128), (1, 4, 1, 2048, 64),
    (1, 4, 1, 129, 16), (1, 4, 1, 200, 32), (1, 8, 2, 1000, 48),
    (2, 4, 1, 129, 80), (1, 4, 1, 1000, 96), (1, 4, 1, 200, 112)])
def test_kernels_match_plain_across_tile_edges(cuda_device, dtype, causal, b,
                                               h, hkv, s, d):
    """Sequence lengths of one tile (64), one past two tiles (129), ragged
    (1000) and long (2048), GQA with H/H_kv = 4: every causal case has
    diagonal, below-diagonal and skipped tiles of K1 and K3.  Head dims
    other than 64 and 128 are padded by the bf16 K1 and K3 to tiles of 64
    or 128 columns."""
    _kernels_vs_plain(cuda_device, dtype, b, h, hkv, s, d, causal)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(200, 1000), (1000, 200)])
def test_kernels_match_plain_when_sq_differs_from_sk(cuda_device, dtype,
                                                     causal, sq, sk):
    """Fewer queries than keys (causal: every q tile stops at its diagonal
    long before the last KV tile; K3's k tiles past Sq see no query) and
    more (causal: q rows past Sk see every key, and K2's heaviest tiles
    carry a ragged last KV tile)."""
    _kernels_vs_plain(cuda_device, dtype, 1, 8, 2, sq, 128, causal, sk=sk)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dq_kernel_is_deterministic(cuda_device, dtype):
    """K2 sums in a fixed order (no atomics): two launches on the same
    inputs give bitwise the same dQ and Δ."""
    q, k, v, do = _inputs(2, 8, 2, 1000, 128, dtype, cuda_device)
    o, lse = tatt.flash_attention_fwd(q, k, v, True)
    first = tatt.flash_attention_bwd_dq(q, k, v, o, lse, do, True)
    second = tatt.flash_attention_bwd_dq(q, k, v, o, lse, do, True)
    assert all(map(torch.equal, first, second))


def _tile_mm_f32(a, b, c, m, n, k, a_t, b_t, acc):
    """``fa_tile_mm_f32_test``: c (+)= a·b through ``mm_tf32x3`` in one
    block, a and b as stored (transposed if a_t / b_t)."""
    import ctypes

    from fedml_tpu_torch.ops import cuda_build
    lib = cuda_build.library("flash_bwd_dq")
    fn = lib.fa_tile_mm_f32_test
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, int(a_t),
            int(b_t), int(acc), torch.cuda.current_stream().cuda_stream)
    cuda_build.check(lib, "fa_tile_mm_f32_test", rc)


@pytest.mark.gpu
@pytest.mark.parametrize("acc", [False, True])
@pytest.mark.parametrize("a_t,b_t", [(False, False), (False, True),
                                     (True, False), (True, True)])
@pytest.mark.parametrize("d", range(16, 129, 16))
def test_tf32x3_tile_product_matches_float64(cuda_device, d, a_t, b_t, acc):
    """K2's and K3's f32 tile product (3xTF32 ``mma.sync``) in each operand
    layout, at the kernels' shapes 32×32×D (Q·Kᵀ, dO·Vᵀ) and 32×D×32 (dS·K,
    Pᵀ·dO, dSᵀ·Q), against a float64 product on the CPU, held to
    ``KERNEL_TOL[float32]``: a wrong fragment layout reads O(1) errors."""
    rng = np.random.default_rng(d)
    for m, n, k in ((32, 32, d), (32, d, 32)):
        a, b, c = (torch.tensor(rng.standard_normal(shape).astype(np.float32))
                   for shape in ((m, k), (k, n), (m, n)))
        out = c.to(cuda_device)
        _tile_mm_f32((a.t() if a_t else a).contiguous().to(cuda_device),
                     (b.t() if b_t else b).contiguous().to(cuda_device), out,
                     m, n, k, a_t, b_t, acc)
        ref = a.double() @ b.double() + (c.double() if acc else 0)
        st = tatt.compare_with_plain(out.cpu()[None, None],
                                     ref.float()[None, None])
        assert st["elem"] <= 1 and st["block"] <= 1, ((m, n, k), st)


def _pv_f32(p, v, o, d, bk):
    """``fa_pv_f32_test``: o = p·v through K1's f32 register-A product in
    one block (p 64 × bk, v bk × d, o 64 × d, row-major)."""
    import ctypes

    from fedml_tpu_torch.ops import cuda_build
    lib = cuda_build.library("flash_fwd")
    fn = lib.fa_pv_f32_test
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(p.data_ptr(), v.data_ptr(), o.data_ptr(), d, bk,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(lib, "fa_pv_f32_test", rc)


@pytest.mark.gpu
@pytest.mark.parametrize("bk", [32, 64])
@pytest.mark.parametrize("d", range(16, 129, 16))
def test_register_a_pv_product_matches_float64(cuda_device, d, bk):
    """K1's f32 O += P·V (3xTF32 ``mma.sync``), each warp's P taken from
    registers in S's C-fragment layout (``c_frag_as_a``) and V read as
    stored, at K1's K/V tile rows (32, 64) and every head dim, against a
    float64 product on the CPU, held to ``KERNEL_TOL[float32]``: a wrong
    fragment mapping reads O(1) errors."""
    rng = np.random.default_rng(d + bk)
    p = torch.tensor(rng.random((64, bk)).astype(np.float32))
    v = torch.tensor(rng.standard_normal((bk, d)).astype(np.float32))
    out = torch.full((64, d), float("nan"), device=cuda_device)
    _pv_f32(p.to(cuda_device), v.to(cuda_device), out, d, bk)
    ref = p.double() @ v.double()
    st = tatt.compare_with_plain(out.cpu()[None, None],
                                 ref.float()[None, None])
    assert st["elem"] <= 1 and st["block"] <= 1, st


@pytest.mark.gpu
@pytest.mark.parametrize("d", [40, 144])
def test_head_dims_no_kernel_takes_raise(cuda_device, d):
    q, k, v, do = _inputs(1, 2, 1, 64, d, torch.bfloat16, cuda_device)
    o = torch.zeros_like(q)
    lse = torch.zeros(q.shape[:3], device=cuda_device)
    tatt.reset_launch_counts()
    with pytest.raises(ValueError, match="flash_fwd: .*multiple of 16 up to"):
        tatt.flash_attention_fwd(q, k, v, True)
    with pytest.raises(ValueError, match="flash_bwd_dq: "):
        tatt.flash_attention_bwd_dq(q, k, v, o, lse, do, True)
    with pytest.raises(ValueError, match="flash_bwd_dkv: "):
        tatt.flash_attention_bwd_dkv(q, k, v, lse, lse, do, True)
    assert [f.launches for f in tatt.KERNELS] == [0, 0, 0]


@pytest.mark.gpu
def test_autograd_function_launches_kernels(cuda_device):
    q, k, v, do = _inputs(1, 4, 2, 96, 64, torch.bfloat16, cuda_device)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    tatt.reset_launch_counts()
    out = tatt.flash_attention(q, k, v, True)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert [f.launches for f in tatt.KERNELS] == [1, 1, 1]
    assert all(torch.isfinite(g).all() for g in grads)


def _sp_api(device, mode="vmap", **over):
    from fedml_tpu_torch import data, model
    from fedml_tpu_torch.arguments import load_arguments
    from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI

    cfg = dict(dataset="synthetic", num_classes=10, input_shape=(28, 28, 1),
               train_size=512, test_size=128, client_num_in_total=8,
               client_num_per_round=4, epochs=1, batch_size=16,
               learning_rate=0.05, partition_method="hetero",
               partition_alpha=0.3, momentum=0.9, random_seed=3,
               frequency_of_the_test=10 ** 9, device=device)
    cfg.update(over)
    args = load_arguments().update(**cfg)
    ds, n_out = data.load(args)
    return FedAvgAPI(args, None, ds, model.create(args, n_out),
                     client_mode=mode)


@pytest.mark.gpu
@pytest.mark.parametrize("name,tol", [("lr", 1e-6), ("cnn_web", 1e-6)])
def test_sp_rounds_on_card_match_cpu(cuda_device, name, tol):
    """Three f32 rounds (TF32 off, the device policy) on the card and the
    CPU from the same seed: the same initial weights (drawn on the CPU),
    cohorts and masks, so params, round losses and the evaluation agree."""
    card, cpu = _sp_api("cuda", model=name), _sp_api("cpu", model=name)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    for k, v in card.state.global_params.items():
        assert v.is_cuda and torch.equal(v.cpu(), cpu.state.global_params[k])
    for r in range(3):
        lg = float(card.train_one_round(r)["train_loss"])
        lc = float(cpu.train_one_round(r)["train_loss"])
        assert abs(lg - lc) <= tol, (r, lg, lc)
    for k, v in cpu.state.global_params.items():
        assert (card.state.global_params[k].cpu() - v).abs().max() <= tol, k
    (gl, ga), (cl, ca) = card.evaluate(), cpu.evaluate()
    assert abs(gl - cl) <= tol and abs(ga - ca) <= 1e-6


def _state_tensors(api):
    """Every ServerState field and per-client table row of an sp engine,
    as one flat ``{name: tensor}`` dict."""
    out = {}
    for f in ("global_params", "opt_state", "c_server", "h", "momentum"):
        out.update({f"{f}/{k}": v
                    for k, v in (getattr(api.state, f) or {}).items()})
    out.update({f"table/{k}": v for k, v in (api.client_table or {}).items()})
    return out


#: (algorithm, model, extra args) of the zoo's card ≡ CPU cases; server Adam
#: at server_lr 0.01 (at 1.0 its normalised step turns f32 summation-order
#: noise into steps of order server_lr: tests/test_torch_sp_algorithms.py)
ZOO_ON_CARD = [("fedprox", "lr", {}),
               ("fedopt", "lr", dict(server_optimizer="sgd")),
               ("fedopt", "lr", dict(server_lr=0.01)),
               ("scaffold", "lr", {}), ("feddyn", "lr", {}),
               ("fednova", "lr", {}), ("mime", "lr", {}),
               ("fedsgd", "lr", {}), ("qfedavg", "lr", {}),
               ("scaffold", "cnn_web", {}), ("feddyn", "cnn_web", {}),
               ("fednova", "cnn_web", {})]


#: SCAFFOLD's control variates (c_server, the table) on cnn_web: c_i⁺ = c_i −
#: c + (x − y_i)/(K·lr) divides the params' f32 rounding by K·lr (~0.2
#: there), so they read 1.4e-6 after 3 rounds on one H100 where the params
#: read 1e-7 (on the CPU against JAX: 6.6e-7 from 1.2e-7); a TF32 run would
#: read ~3e-4
SCAFFOLD_CNN_C_TOL = 4e-6


@pytest.mark.gpu
@pytest.mark.parametrize("alg,name,over", ZOO_ON_CARD)
def test_zoo_rounds_on_card_match_cpu(cuda_device, alg, name, over):
    """Three f32 rounds of each algorithm on the card and the CPU from the
    same seed: params, round losses, every server-state field and every
    row of the per-client state table within 1e-6 (SCAFFOLD's control
    variates on cnn_web: ``SCAFFOLD_CNN_C_TOL``); the state was written
    (non-zero)."""
    kw = dict(model=name, federated_optimizer=alg, **over)
    card, cpu = _sp_api("cuda", **kw), _sp_api("cpu", **kw)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    for r in range(3):
        lg = float(card.train_one_round(r)["train_loss"])
        lc = float(cpu.train_one_round(r)["train_loss"])
        assert abs(lg - lc) <= 1e-6, (r, lg, lc)
    got, ref = _state_tensors(card), _state_tensors(cpu)
    assert set(got) == set(ref)
    c_tol = SCAFFOLD_CNN_C_TOL if (alg, name) == ("scaffold", "cnn_web") \
        else 1e-6
    for k, v in ref.items():
        assert got[k].is_cuda
        tol = 1e-6 if k.startswith("global_params/") else c_tol
        assert (got[k].cpu() - v).abs().max() <= tol, k
    extra = [k for k in ref if not k.startswith("global_params/")]
    assert all(ref[k].abs().max() > 0 for k in extra if k != "opt_state/count")
    assert bool(extra) == (alg not in ("fedprox", "fednova", "fedsgd",
                                       "qfedavg"))


@pytest.mark.gpu
def test_client_table_out_of_range_on_card(cuda_device):
    """The table's gather and scatter on CUDA with out-of-range ids (the
    padded-cohort sentinel, a larger id, a negative one): zero rows on
    read, dropped on write, no device assert, the last row untouched."""
    from fedml_tpu_torch.core import tree

    table = tree.client_table_init(
        {"w": torch.zeros(3, 2, device=cuda_device)}, 8)
    table = {"w": table["w"] + torch.arange(8, device=cuda_device)
             .view(8, 1, 1).float()}
    ids = np.asarray([2, 8, 7, -1, 100])
    got = tree.cohort_gather(table, ids)["w"]
    torch.cuda.synchronize()
    assert got.is_cuda and got.shape == (5, 3, 2)
    assert torch.equal(got[0], table["w"][2])
    assert torch.equal(got[2], table["w"][7])
    assert not got[[1, 3, 4]].any()
    new = {"w": -torch.ones(5, 3, 2, device=cuda_device)}
    after = tree.cohort_scatter(table, ids, new)["w"]
    torch.cuda.synchronize()
    assert torch.equal(after[[2, 7]], -torch.ones(2, 3, 2,
                                                  device=cuda_device))
    rest = [0, 1, 3, 4, 5, 6]
    assert torch.equal(after[rest], table["w"][rest])


@pytest.mark.gpu
def test_cnn_dropout_rounds_on_card(cuda_device):
    """``CNNDropOut`` on the real digits shard: its keep-masks are drawn
    on the card from the round's generator; rounds are finite, move every
    parameter, and ``scan`` ≡ ``vmap`` (same masks) to 1e-4."""
    from fedml_tpu_torch.core import rng

    over = dict(dataset="digits", model="cnn", input_shape=(8, 8, 1),
                data_cache_dir=SHARDS, client_num_per_round=5,
                momentum=0.0)
    apis = [_sp_api("cuda", mode, **over) for mode in ("vmap", "scan")]
    masks = apis[0].model.dropout_masks(
        rng.round_key(apis[0]._root, 0), (2, 3, 4))
    assert all(m.is_cuda and m.dtype == torch.bool for m in masks)
    start = {k: v.clone() for k, v in apis[0].state.global_params.items()}
    for r in range(2):
        losses = [float(a.train_one_round(r)["train_loss"]) for a in apis]
        assert all(np.isfinite(losses)) and abs(losses[0] - losses[1]) < 1e-4
    for k, v in apis[0].state.global_params.items():
        assert torch.isfinite(v).all() and not torch.equal(v, start[k]), k
        assert (v - apis[1].state.global_params[k]).abs().max() < 1e-4, k


def _same_state(a, b):
    """Max abs difference over every ServerState field and table row."""
    got, ref = _state_tensors(a), _state_tensors(b)
    assert set(got) == set(ref)
    return max((got[k].float() - ref[k].float()).abs().max().item()
               for k in ref)


def _blocks(api, rounds):
    losses, r = [], 0
    while r < rounds:
        k, ms = api.train_block(r)
        losses.append(ms["train_loss"])
        r += k
    return torch.cat(losses, dim=-1).cpu()


@pytest.mark.gpu
@pytest.mark.parametrize("alg,name", [("fedavg", "lr"), ("fedopt", "lr"),
                                      ("scaffold", "lr"),
                                      ("feddyn", "cnn_web"),
                                      ("scaffold", "cnn_web")])
def test_fused_blocks_replay_graphs_and_match_unfused(cuda_device, alg,
                                                      name):
    """``round_block`` 2 over 5 rounds (2+2+1) on the card: the rounds are
    captured as CUDA graphs (one per step class and cohort size) and
    replayed; per-round losses, params, server state and table rows equal
    the unfused rounds' to 1e-6 (the same kernels in the same order; cuDNN's
    weight-gradient sums may vary between calls)."""
    kw = dict(model=name, federated_optimizer=alg, comm_round=5)
    if alg == "fedopt":
        kw.update(server_lr=0.01)
    ref, fused = _sp_api("cuda", **kw), _sp_api("cuda", round_block=2, **kw)
    ref_losses = torch.stack([ref.train_one_round(r)["train_loss"]
                              for r in range(5)]).cpu()
    fused_losses = _blocks(fused, 5)
    assert fused._block_fn.captures >= 1
    assert (fused_losses - ref_losses).abs().max() <= 1e-6
    assert _same_state(fused, ref) <= 1e-6
    assert fused.state.round_idx == ref.state.round_idx == 5


@pytest.mark.gpu
def test_fused_dropout_blocks_match_unfused_on_card(cuda_device):
    """The dropout CNN on the real digits: each round's masks are drawn on
    the card outside the graph, at the round's own step class, into the
    graph's static buffers; fused ≡ unfused to 1e-6 over two rounds."""
    over = dict(dataset="digits", model="cnn", input_shape=(8, 8, 1),
                data_cache_dir=SHARDS, client_num_per_round=5,
                momentum=0.0, comm_round=2)
    ref = _sp_api("cuda", **over)
    fused = _sp_api("cuda", round_block=2, **over)
    ref_losses = torch.stack([ref.train_one_round(r)["train_loss"]
                              for r in range(2)]).cpu()
    assert (_blocks(fused, 2) - ref_losses).abs().max() <= 1e-6
    assert _same_state(fused, ref) <= 1e-6


@pytest.mark.gpu
def test_bucketed_rounds_match_unbucketed_on_card(cuda_device):
    """Bucketed rounds on the card do the same real work over fewer
    allocated step slots and end within the JAX test's bars (eval loss
    2e-4, accuracy 2e-2) of the unbucketed rounds."""
    kw = dict(dataset="synthetic", model="lr", num_classes=4,
              input_shape=(10,),
              train_size=1200, test_size=120, client_num_in_total=24,
              client_num_per_round=12, batch_size=8, learning_rate=0.2,
              partition_alpha=0.15, random_seed=5, momentum=0.0)
    plain, buck = _sp_api("cuda", **kw), _sp_api("cuda", cohort_bucketing=True,
                                                  **kw)
    for r in range(4):
        mp, mb = plain.train_one_round(r), buck.train_one_round(r)
        assert float(mb["total_steps"]) == float(mp["total_steps"])
        assert mb["allocated_steps"] < mp["allocated_steps"]
    (l0, a0), (l1, a1) = plain.evaluate(), buck.evaluate()
    assert abs(l0 - l1) < 2e-4 and abs(a0 - a1) < 2e-2


@pytest.mark.gpu
def test_population_member_matches_single_run_on_card(cuda_device):
    """A client-lr population of 3 on the card: member 0 (the static rate)
    is the single run (the member map batches the same arithmetic in
    another order: 1e-6 after one round), and the fused population (K 2,
    graph replays) is the unfused one to 1e-6."""
    from fedml_tpu_torch.core import federated

    kw = dict(model="cnn_web", comm_round=3)
    axes = {"client_lr": [0.05, 0.02, 0.1]}
    single = _sp_api("cuda", **kw)
    pop = _sp_api("cuda", population_axes=axes, **kw)
    single.train_one_round(0)
    pop.train_one_round(0)
    m0 = federated.population_member(pop.state.global_params, 0)
    for k, v in single.state.global_params.items():
        assert (m0[k] - v).abs().max() <= 1e-6, k
    for r in (1, 2):
        pop.train_one_round(r)
    fused = _sp_api("cuda", population_axes=axes, round_block=2, **kw)
    _blocks(fused, 3)
    assert fused._block_fn.captures >= 1
    for k, v in pop.state.global_params.items():
        assert (fused.state.global_params[k] - v).abs().max() <= 1e-6, k


@pytest.mark.gpu
def test_capture_that_syncs_the_host_raises(cuda_device):
    """A round that reads a value back to the host cannot be captured: the
    block raises instead of falling back to eager rounds."""
    from fedml_tpu_torch.simulation.round_engine import BlockRoundFn

    def core(state, idx, mask, w, drop, c, hp):
        if float(w.sum()) < 0:        # a device→host read
            raise AssertionError
        return state, {"train_loss": w.sum(), "total_steps": mask.sum()}, c

    from fedml_tpu_torch.ml.aggregator.agg_operator import ServerState
    block = BlockRoundFn(core, model=None, has_table=False)
    block._draw = lambda gen, lead: None
    st = ServerState(round_idx=0, global_params={
        "w": torch.zeros(3, device=cuda_device)})
    k, c, s, b = 2, 4, 2, 3
    args = (torch.zeros((k, c, s, b), dtype=torch.int32, device=cuda_device),
            torch.ones((k, c, s), device=cuda_device),
            torch.ones((k, c), device=cuda_device), [None] * k,
            torch.zeros((k, c), dtype=torch.long, device=cuda_device))
    with pytest.raises(RuntimeError):
        block(st, *args)
    assert block.captures == 0


# -- the kernel Functions under torch.func, and the text model -------------

def _attention_loss(q, k, v, w):
    """A client's loss through ``flash_attention``, non-causal: its
    cotangent dO is ``w``."""
    return (tatt.flash_attention(q, k, v, False) * w).sum()


@pytest.mark.gpu
@pytest.mark.parametrize("d", [32, 16])
def test_vmapped_kernel_functions_match_per_client_launches(cuda_device, d):
    """``vmap(grad_and_value)`` over a cohort of 5 folds the clients into
    the batch dim: one launch of each kernel for the cohort, and O, dQ,
    dK and dV bitwise those of five per-client launches (each block of a
    kernel computes one (b, h, tile) whatever B is)."""
    c, b, h, s = 5, 4, 4, 128
    per = [_inputs(b, h, h, s, d, torch.float32, cuda_device, seed=i)
           for i in range(c)]
    q, k, v, w = (torch.stack(t) for t in zip(*per))
    tatt.reset_launch_counts()
    o = torch.func.vmap(lambda *a: tatt.flash_attention(*a, False))(q, k, v)
    grads, _ = torch.func.vmap(torch.func.grad_and_value(
        _attention_loss, argnums=(0, 1, 2)))(q, k, v, w)
    torch.cuda.synchronize()
    assert [f.launches for f in tatt.KERNELS] == [2, 1, 1]
    tatt.reset_launch_counts()
    for i in range(c):
        leaves = [t[i].clone().requires_grad_(True) for t in (q, k, v)]
        oi = tatt.flash_attention(*leaves, False)
        gi = torch.autograd.grad(oi, leaves, w[i])
        assert torch.equal(oi, o[i])
        assert all(torch.equal(a, g[i]) for a, g in zip(gi, grads))
    assert [f.launches for f in tatt.KERNELS] == [c, c, c]


def _text_api(device, **over):
    from fedml_tpu_torch import data, model
    from fedml_tpu_torch.arguments import load_arguments
    from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI

    cfg = dict(TEXT_SMALL, device=device)
    cfg.update(over)
    args = load_arguments().update(**cfg)
    ds, n_out = data.load(args)
    return FedAvgAPI(args, None, ds, model.create(args, n_out))


#: tests/test_model_zoo_ext.py's text config (seq 32, vocab 512, dim 64, 2
#: layers, 4 heads: head dim 16), SGD
TEXT_SMALL = dict(dataset="20news", model="distilbert", seq_len=32,
                  vocab_size=512, model_dim=64, model_layers=2,
                  model_heads=4, model_ffn_dim=128, text_class_signal=0.5,
                  text_keyword_width=1.0, train_size=600, test_size=120,
                  client_num_in_total=6, client_num_per_round=3, epochs=1,
                  batch_size=20, learning_rate=0.1, partition_method="homo",
                  frequency_of_the_test=10 ** 9, random_seed=0)


@pytest.mark.gpu
def test_text_rounds_on_card_match_cpu_and_launch_once_a_layer(cuda_device):
    """Two SGD rounds of the small text model on the card and the CPU from
    the same weights: params within 1e-5 (f32 kernels against their plain
    versions, summed in another order), and each kernel launched once per
    layer per step for the whole vmapped cohort."""
    card, cpu = _text_api("cuda"), _text_api("cpu")
    tatt.reset_launch_counts()
    steps = 0
    for r in range(2):
        m = card.train_one_round(r)
        cpu.train_one_round(r)
        steps += m["allocated_steps"] // card.clients_per_round
    torch.cuda.synchronize()
    layers = TEXT_SMALL["model_layers"]
    assert [f.launches for f in tatt.KERNELS] == [layers * steps] * 3
    for k, v in cpu.state.global_params.items():
        assert (card.state.global_params[k].cpu() - v).abs().max() <= 1e-5, k


@pytest.mark.gpu
def test_vmapped_text_step_replays_as_a_cuda_graph(cuda_device):
    """A vmapped text round captured as a CUDA graph (``round_block`` 2
    over 4 rounds) launches the kernels inside the graph and equals the
    eager rounds bitwise; the Python counters count the capture only."""
    ref, fused = _text_api("cuda", comm_round=4), _text_api(
        "cuda", comm_round=4, round_block=2)
    ref_losses = torch.stack([ref.train_one_round(r)["train_loss"]
                              for r in range(4)]).cpu()
    tatt.reset_launch_counts()
    fused_losses = _blocks(fused, 4)
    assert fused._block_fn.captures == 1
    # the warm run before the capture and the capture: two a kernel a layer
    # a step; the replays add none on the host
    assert len({f.launches for f in tatt.KERNELS}) == 1
    assert torch.equal(fused_losses, ref_losses)
    assert _same_state(fused, ref) == 0


def _lm_api(device, **over):
    """tests/test_torch_rnn.py's small Shakespeare rounds (the char-LSTM
    at its full width, seq 10)."""
    return _sp_api(device, **dict(dict(
        model="rnn", dataset="shakespeare", seq_len=10, train_size=120,
        test_size=24, client_num_in_total=4, client_num_per_round=2,
        batch_size=5, learning_rate=0.5, momentum=0.0, random_seed=0,
        partition_method="homo", comm_round=4), **over))


@pytest.mark.gpu
@pytest.mark.parametrize("name,vocab,seq", [("rnn", 90, 12),
                                            ("rnn_stackoverflow", 200, 6)])
def test_vmapped_lstm_matches_per_client_calls(cuda_device, name, vocab,
                                               seq):
    """The hand-written LSTM under ``torch.func.vmap`` over 3 clients'
    params and tokens on the card: logits and gradients equal each
    client's own call to 1e-6 (the batched products sum in another
    order)."""
    import types

    from fedml_tpu_torch.core import rng as t_rng
    from fedml_tpu_torch.ml.trainer.local_trainer import cross_entropy_loss
    from fedml_tpu_torch.models import model_hub

    m = model_hub.create(types.SimpleNamespace(model=name, dataset="x",
                                               seq_len=seq), vocab)
    per = [m.init(t_rng.root_key(c, cuda_device)) for c in range(3)]
    params = {k: torch.stack([p[k] for p in per]) for k in per[0]}
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randint(0, vocab, (3, 4, seq), generator=gen,
                      device=cuda_device)
    y = torch.randint(0, vocab, (3, 4, seq), generator=gen,
                      device=cuda_device)

    def loss(p, xc, yc):
        logits = m.apply(p, xc)
        return cross_entropy_loss(logits, yc), logits

    grads, (_, logits) = torch.func.vmap(torch.func.grad_and_value(
        loss, has_aux=True))(params, x, y)
    for c in range(3):
        g, (_, lc) = torch.func.grad_and_value(loss, has_aux=True)(
            per[c], x[c], y[c])
        assert (logits[c] - lc).abs().max() <= 1e-6
        for k in g:
            assert (grads[k][c] - g[k]).abs().max() <= 1e-6, k


@pytest.mark.gpu
def test_fused_lstm_rounds_match_unfused(cuda_device):
    """The char-LSTM's rounds in blocks of 2 (CUDA graphs of the vmapped
    80-op-a-step cell loop, at seq 10) equal the unfused rounds to 1e-6,
    with a graph captured."""
    ref, fused = _lm_api("cuda"), _lm_api("cuda", round_block=2)
    ref_losses = torch.stack([ref.train_one_round(r)["train_loss"]
                              for r in range(4)]).cpu()
    fused_losses = _blocks(fused, 4)
    assert fused._block_fn.captures >= 1
    assert (fused_losses - ref_losses).abs().max() <= 1e-6
    assert _same_state(fused, ref) <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["rnn", "rnn_stackoverflow"])
def test_lm_eval_step_on_card_matches_cpu(cuda_device, name):
    """The LM eval step (per-position means per example, a masked ragged
    tail) on the card against the CPU at the same weights: loss sum, hit
    sum and count within 1e-5 relative (f32 log-softmax over the
    vocabulary, summed in another order)."""
    over = {} if name == "rnn" else dict(
        model="rnn_stackoverflow", dataset="stackoverflow_nwp", seq_len=6,
        train_size=64, test_size=16)
    card, cpu = _lm_api("cuda", **over), _lm_api("cpu", **over)
    cpu.state = cpu.state.replace(global_params={
        k: v.cpu() for k, v in card.state.global_params.items()})
    xb, yb, mb = cpu.dataset.test_batches(8)
    mb[-1, 3:] = 0.0
    step_c = card.trainer.make_eval_step()
    step_p = cpu.trainer.make_eval_step()
    with torch.no_grad():
        for x, y, m in zip(xb, yb, mb):
            got = step_c(card.state.global_params,
                         *(torch.as_tensor(a, device=cuda_device)
                           for a in (x, y, m)))
            want = step_p(cpu.state.global_params,
                          *(torch.as_tensor(a) for a in (x, y, m)))
            for g, w in zip(got, want):
                assert abs(float(g) - float(w)) <= 1e-5 * max(
                    1.0, abs(float(w)))
    (lc, ac), (lp, ap) = card.evaluate(), cpu.evaluate()
    assert abs(lc - lp) <= 1e-5 * max(1.0, abs(lp)) and abs(ac - ap) <= 1e-6


#: the other sp engines on the card, at the CPU tests' sizes
ENGINES_ON_CARD = {
    "fednas": dict(dataset="synthetic", num_classes=3, input_shape=(8, 8, 1),
                   model="darts", federated_optimizer="FedNAS",
                   client_num_in_total=4, client_num_per_round=2,
                   batch_size=4, train_size=64, test_size=16),
    # lr 0.1, as chip_smoke.py phase 11 (f): at lr 0.05 the 6th step meets
    # a max-pool window whose top two values lie 1.0e-6 apart, the card's
    # and the CPU's summation orders pick different maxima, and the routed
    # gradient jumps the weights 1.5e-5 apart (1.2e-4 after 2 rounds; each
    # device's run is itself deterministic)
    "fedseg": dict(dataset="fets2021", input_shape=(16, 16, 1), model="unet",
                   federated_optimizer="FedSeg", client_num_in_total=4,
                   client_num_per_round=2, batch_size=4, train_size=48,
                   test_size=40, learning_rate=0.1),
    "fedgkt": dict(dataset="synthetic", num_classes=3, input_shape=(8, 8, 1),
                   model="lr", federated_optimizer="FedGKT",
                   client_num_in_total=3, batch_size=8, train_size=96,
                   test_size=32),
    "fedgan": dict(dataset="synthetic", num_classes=3, input_shape=(8, 8, 1),
                   model="lr", federated_optimizer="FedGAN",
                   client_num_in_total=4, client_num_per_round=2,
                   batch_size=8, train_size=96, test_size=32,
                   learning_rate=2e-4),
}
#: what Adam trains (FedGKT's server head at lr 1e-3, FedGAN's nets at
#: 2e-4): Adam normalises f32 rounding noise into steps of up to lr
#: (6.97e-6 and 1.45e-6 read on one H100); everything else 1e-6
ENGINE_CARD_TOL = {"fedgkt": 1e-4, "fedgan": 1e-4}
_ENGINE_WEIGHTS = ("params", "g_params", "d_params", "_init_e", "_init_h",
                   "s_params", "client_params", "server_params")


def _engine_weights(api):
    out = {}
    for attr in _ENGINE_WEIGHTS:
        for k, v in (getattr(api, attr, None) or {}).items():
            out[f"{attr}.{k}"] = v
    for c, nets in (getattr(api, "c_params", None) or {}).items():
        for i, net in enumerate(nets):
            out.update({f"c{c}.{i}.{k}": v for k, v in net.items()})
    return out


def _start_cpu_from_card(card, cpu):
    for attr in _ENGINE_WEIGHTS:
        if hasattr(card, attr):
            setattr(cpu, attr, {k: v.cpu() for k, v in
                                getattr(card, attr).items()})


@pytest.mark.gpu
@pytest.mark.parametrize("tag", list(ENGINES_ON_CARD))
def test_engine_rounds_on_card_match_cpu(cuda_device, tag):
    """Two rounds of FedNAS, FedSeg, FedGKT and FedGAN through the
    simulator on the card (its default device) and on the CPU from the
    same weights (and FedGAN's same latent noise): every weight and the
    history within 1e-6, Adam-trained weights within ``ENGINE_CARD_TOL``;
    no flash-attention launch."""
    from fedml_tpu_torch import data, device, model
    from fedml_tpu_torch.arguments import load_arguments
    from fedml_tpu_torch.runner import FedMLRunner

    args = load_arguments().update(**dict(dict(
        comm_round=2, random_seed=0, learning_rate=0.05,
        partition_method="homo", data_cache_dir=""), **ENGINES_ON_CARD[tag]))
    ds, out_dim = data.load(args)
    card, cpu = (FedMLRunner(args, d, ds, model.create(args, out_dim))
                 .runner.fl_trainer
                 for d in (device.get_device(args), torch.device("cpu")))
    assert card.device.type == "cuda" and cpu.device.type == "cpu"
    _start_cpu_from_card(card, cpu)
    if tag == "fedgan":
        zs, draw = [], card.client_noise
        card.client_noise = lambda s, b: zs.append(draw(s, b)) or zs[-1]
        cpu.client_noise = lambda s, b: zs.pop(0).cpu()
    tatt.reset_launch_counts()
    hc, hp = card.train()["history"], cpu.train()["history"]
    assert [f.launches for f in tatt.KERNELS] == [0, 0, 0]
    tol = ENGINE_CARD_TOL.get(tag, 1e-6)
    wc, wp = _engine_weights(card), _engine_weights(cpu)
    assert wc.keys() == wp.keys() and wc
    for k, v in wp.items():
        assert (wc[k].cpu() - v).abs().max().item() <= tol, k
    for a, b in zip(hc, hp):
        assert all(abs(a[k] - b[k]) <= tol for k in a), (a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("tag", ["split_nn", "vertical_fl", "centralized"])
def test_class_engines_on_card_match_cpu(cuda_device, tag):
    """Split learning, vertical FL and the centralized trainer, built on
    the card by default and on the CPU from the same weights: weights and
    losses within 1e-6."""
    from torch import nn

    from fedml_tpu_torch import data, model
    from fedml_tpu_torch.arguments import load_arguments
    from fedml_tpu_torch.data.data_loader import load_vertical
    from fedml_tpu_torch.simulation.centralized_trainer import \
        CentralizedTrainer
    from fedml_tpu_torch.simulation.sp.split_nn import SplitNNAPI
    from fedml_tpu_torch.simulation.sp.vertical_fl import VerticalFLAPI

    args = load_arguments().update(
        dataset="mnist", model="lr", train_size=256, test_size=64,
        client_num_in_total=1, partition_method="homo", batch_size=32,
        learning_rate=0.1, comm_round=1, epochs=2, random_seed=0,
        data_cache_dir="")
    ds, out_dim = data.load(args)
    if tag == "split_nn":
        def halves():
            return (nn.Sequential(nn.Flatten(), nn.Linear(784, 32),
                                  nn.ReLU()), nn.Linear(32, 10))
        card, cpu = (SplitNNAPI(args, ds, *halves(), device=d)
                     for d in (None, "cpu"))
    elif tag == "vertical_fl":
        vargs = load_arguments().update(dataset="nus_wide", train_size=400,
                                        batch_size=64, comm_round=2,
                                        learning_rate=0.1, random_seed=0)
        f, y, c = load_vertical(vargs)
        card, cpu = (VerticalFLAPI(vargs, [a[:320] for a in f], y[:320],
                                   [a[320:] for a in f], y[320:], c,
                                   device=d) for d in (None, "cpu"))
        for pc, pp in zip(card.parties, cpu.parties):
            pp.w = pc.w.cpu()
    else:
        m = model.create(args, out_dim)
        card, cpu = (CentralizedTrainer(ds, m, d, args)
                     for d in (None, "cpu"))
    assert card.device.type == "cuda" and cpu.device.type == "cpu"
    _start_cpu_from_card(card, cpu)
    lc, lp = card.train(), cpu.train()
    if tag == "centralized":
        lc, lp = ([h["train_loss"] for h in h_] for h_ in (lc, lp))
    assert np.abs(np.asarray(lc) - np.asarray(lp)).max() <= 1e-6
    wc, wp = _engine_weights(card), _engine_weights(cpu)
    if tag == "vertical_fl":
        wc = {i: p.w for i, p in enumerate(card.parties)}
        wp = {i: p.w for i, p in enumerate(cpu.parties)}
    assert wc.keys() == wp.keys() and wc
    for k, v in wp.items():
        assert (wc[k].cpu() - v).abs().max().item() <= 1e-6, k


# -- the causal-LM remainder (streaming xent, MoE, trainer, remat, hub) ---
def _llm_trainer(device, **over):
    import fedml_tpu_torch
    from fedml_tpu_torch import data
    from fedml_tpu_torch.llm.trainer import CausalLMTrainer

    cfg = dict(model="tiny_llama", dataset="shakespeare", seq_len=16,
               batch_size=4, learning_rate=1e-3, random_seed=9, lora_rank=4,
               partition_method="homo", train_size=12, test_size=8,
               client_num_in_total=2, client_num_per_round=2, epochs=3,
               gradient_accumulation_steps=2, max_grad_norm=0.5,
               warmup_steps=1, lr_scheduler_type="cosine", max_steps=3,
               weight_decay=0.01)
    cfg.update(over)
    args = fedml_tpu_torch.init(fedml_tpu_torch.load_arguments().update(
        **cfg), should_init_logs=False)
    ds, _ = data.load(args)
    return CausalLMTrainer(args, ds, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("v,chunk", [(70, 16), (64, 64)])
def test_streaming_xent_on_card_matches_cpu(cuda_device, v, chunk):
    """The streaming cross-entropy on the card against the CPU on the same
    f32 inputs (tests/test_torch_xent.py's shape): loss 2e-6, dh and dw
    1e-6 + 1e-5 relative."""
    from fedml_tpu_torch.ops.xent import streaming_xent

    rng = np.random.default_rng(0)
    h = torch.tensor(rng.standard_normal((2, 12, 24)).astype(np.float32))
    w = torch.tensor((0.3 * rng.standard_normal((24, v))).astype(np.float32))
    t = torch.tensor(rng.integers(0, v, size=(2, 12)))
    res = {}
    for dev in ("cpu", "cuda"):
        hh = h.to(dev).requires_grad_(True)
        ww = w.to(dev).requires_grad_(True)
        loss = streaming_xent(hh, ww, t.to(dev), chunk)
        res[dev] = [loss.detach().cpu()] + [
            g.cpu() for g in torch.autograd.grad(loss, (hh, ww))]
    assert abs(res["cuda"][0].item() - res["cpu"][0].item()) <= 2e-6
    for a, b in zip(res["cuda"][1:], res["cpu"][1:]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("v,chunk", [(70, 16), (64, 64)])
def test_streaming_xent_bf16_on_card_keeps_f32_logits(cuda_device, v, chunk,
                                                      monkeypatch):
    """bf16 h and w on the card: the loss and each token's NLL within 1e-5
    of the dense f32 logits of the same operands; with the chunk products
    left in bf16 (the control) the per-token NLL moves by more."""
    from fedml_tpu_torch.ops import xent as xent_mod
    from fedml_tpu_torch.ops.xent import streaming_xent

    rng = np.random.default_rng(0)
    h = torch.tensor(rng.standard_normal((24, 24)).astype(np.float32)).to(
        "cuda", torch.bfloat16)
    w = torch.tensor((0.3 * rng.standard_normal((24, v))).astype(
        np.float32)).to("cuda", torch.bfloat16)
    t = torch.tensor(rng.integers(0, v, size=24), device="cuda")
    ref = torch.nn.functional.cross_entropy(h.float() @ w.float(), t,
                                            reduction="none")

    def errs():
        tok = torch.stack([streaming_xent(h[i:i + 1], w, t[i:i + 1], chunk)
                           for i in range(24)])
        return (abs(streaming_xent(h, w, t, chunk).item()
                    - ref.mean().item()),
                (tok - ref).abs().max().item())

    assert max(errs()) <= 1e-5
    f32_logits = xent_mod._chunk_logits

    def bf16_logits(h2f, w_, base, chunk_):
        logits, wc = f32_logits(h2f, w_, base, chunk_)
        lb = (h2f.bfloat16() @ wc.bfloat16()).float()
        return torch.where(logits == xent_mod.NEG_INF, logits, lb), wc

    monkeypatch.setattr(xent_mod, "_chunk_logits", bf16_logits)
    assert errs()[1] > 1e-5


@pytest.mark.gpu
def test_moe_on_card_matches_cpu_and_its_per_token_version(cuda_device):
    """MoEMLP on the card against the CPU from the same weights (outputs
    1e-5, aux 1e-6) and against its plain per-token version (1e-5)."""
    from fedml_tpu_torch.llm.moe import MoEMLP, moe_per_token

    gen = torch.Generator().manual_seed(1)
    cpu = MoEMLP(16, 32, 4, 2, capacity_factor=0.5)
    with torch.no_grad():
        for p in cpu.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=gen))
    card = MoEMLP(16, 32, 4, 2, capacity_factor=0.5).cuda()
    card.load_state_dict(cpu.state_dict())
    x = torch.randn((2, 8, 16), generator=gen)
    o1, a1 = cpu.forward_with_aux(x)
    o2, a2 = card.forward_with_aux(x.cuda())
    torch.testing.assert_close(o2.detach().cpu(), o1.detach(), atol=1e-5,
                               rtol=0)
    assert abs(a1.item() - a2.item()) <= 1e-6
    torch.testing.assert_close(o2.detach(), moe_per_token(card, x.cuda()),
                               atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_llm_trainer_on_card_matches_cpu_and_counts_launches(cuda_device):
    """The LoRA trainer (accumulation 2, clip, warmup + cosine, max_steps)
    on the card against the CPU from the same weights: every micro-step's
    loss within 1e-5 and the adapters within 1e-4 (Adam at lr 1e-3); K1
    twice a layer a micro-step (remat "full") and K2/K3 once."""
    cpu, card = _llm_trainer("cpu"), _llm_trainer("cuda")
    with torch.no_grad():
        for p, q in zip(card.model.parameters(), cpu.model.parameters()):
            p.copy_(q)
    card.lora = {k: v.cuda() for k, v in cpu.lora.items()}
    cpu.train()
    tatt.reset_launch_counts()
    card.train()
    torch.cuda.synchronize()
    layers, micro = card.cfg.n_layers, card.global_step
    assert [f.launches for f in tatt.KERNELS] == [
        2 * layers * micro, layers * micro, layers * micro]
    np.testing.assert_allclose(card.step_losses, cpu.step_losses, atol=1e-5,
                               rtol=0)
    for k, v in cpu.lora.items():
        assert (card.lora[k].cpu() - v).abs().max() <= 1e-4, k


@pytest.mark.gpu
def test_remat_modes_on_card_agree_and_launch_k1_as_expected(cuda_device):
    """One bf16 step of a 2-layer model at head dim 128 under each remat
    mode: the same loss and adapter gradients (to 1e-6 of each leaf's
    largest entry); K1 once a layer under "none", twice under "full" and
    "dots" (attention is recomputed: it is no 2-D product)."""
    import dataclasses

    from fedml_tpu_torch.llm import model as tmodel
    from fedml_tpu_torch.llm.fedllm import lora_init

    cfg = dataclasses.replace(tmodel.TINY, dim=256, n_heads=2, n_kv_heads=2,
                              ffn_dim=512, lora_rank=4,
                              dtype=torch.bfloat16)
    with torch.device("cuda"):
        m = tmodel.LlamaLM(cfg)
    m.init_weights(torch.Generator(device="cuda").manual_seed(0))
    lora = lora_init(torch.Generator(device="cuda").manual_seed(1),
                     m.lora_shapes(), "cuda")
    lora = {k: v + 0.01 for k, v in lora.items()}
    tok = torch.randint(0, 256, (2, 64), device="cuda")
    out = {}
    for remat in ("none", "full", "dots"):
        m.cfg = dataclasses.replace(cfg, remat=remat)
        leaves = {k: v.clone().requires_grad_(True) for k, v in lora.items()}
        tatt.reset_launch_counts()
        loss = tmodel.causal_nll(m(tok, leaves), tok)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        torch.cuda.synchronize()
        out[remat] = (loss.item(), grads,
                      [f.launches for f in tatt.KERNELS])
    assert out["none"][2] == [2, 2, 2]
    assert out["full"][2] == out["dots"][2] == [4, 2, 2]
    for remat in ("full", "dots"):
        assert abs(out[remat][0] - out["none"][0]) <= 1e-6
        for a, b in zip(out[remat][1], out["none"][1]):
            assert (a - b).abs().max() <= 1e-6 * b.abs().max()


@pytest.mark.gpu
def test_hub_tiny_llama_on_card_matches_cpu_once_a_layer_a_step(
        cuda_device):
    """Two sp rounds of the hub's ``tiny_llama`` (f32, GQA 4:2, head dim
    16, vmapped cohort) on the card and the CPU from the same weights:
    params within 1e-5 (tests/test_torch_llm_paths.py's tolerance against
    JAX), K1–K3 once a layer a padded step for the whole cohort, and the
    per-client evaluation within 1e-5."""
    cfg = dict(model="tiny_llama", dataset="shakespeare", seq_len=16,
               client_num_in_total=4, client_num_per_round=2, comm_round=2,
               batch_size=4, learning_rate=0.1, train_size=48, test_size=8,
               random_seed=3, partition_method="homo")
    card, cpu = _sp_api("cuda", **cfg), _sp_api("cpu", **cfg)
    tatt.reset_launch_counts()
    steps = 0
    for r in range(2):
        m = card.train_one_round(r)
        cpu.train_one_round(r)
        steps += int(m["allocated_steps"]) // card.clients_per_round
    torch.cuda.synchronize()
    layers = card.model.module.cfg.n_layers
    assert [f.launches for f in tatt.KERNELS] == [layers * steps] * 3
    for k, v in cpu.state.global_params.items():
        assert (card.state.global_params[k].cpu() - v).abs().max() <= 1e-5, k
    a, b = card.evaluate_per_client(batch_size=4), \
        cpu.evaluate_per_client(batch_size=4)
    for key in ("per_client_acc", "per_client_loss"):
        np.testing.assert_allclose(a[key], b[key], atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("over", [{"streaming_xent_chunk": 40},
                                  {"n_experts": 4, "moe_top_k": 2}])
def test_fedllm_round_options_on_card_match_cpu(cuda_device, over):
    """A federated LoRA round with the streaming loss (chunk 40 over the
    90-token vocabulary: padded) or MoE blocks, card against CPU from the
    same weights: loss and adapters within 1e-4 (Adam at lr 1e-3)."""
    import fedml_tpu_torch
    from fedml_tpu_torch import data
    from fedml_tpu_torch.llm.fedllm import FedLLMAPI

    args = fedml_tpu_torch.init(fedml_tpu_torch.load_arguments().update(
        model="tiny_llama", dataset="shakespeare", seq_len=16,
        client_num_in_total=4, client_num_per_round=2, comm_round=1,
        batch_size=4, learning_rate=1e-3, random_seed=9,
        llm_max_local_steps=3, lora_rank=4, partition_method="homo",
        train_size=64, test_size=8, **over), should_init_logs=False)
    ds, _ = data.load(args)
    cpu, card = FedLLMAPI(args, ds, "cpu"), FedLLMAPI(args, ds, "cuda")
    with torch.no_grad():
        for p, q in zip(card.model.parameters(), cpu.model.parameters()):
            p.copy_(q)
    card.global_lora = {k: v.cuda() for k, v in cpu.global_lora.items()}
    lc = cpu.train_one_round(0)["train_loss"]
    lg = card.train_one_round(0)["train_loss"]
    assert abs(lc - lg) <= 1e-4
    for k, v in cpu.global_lora.items():
        assert (card.global_lora[k].cpu() - v).abs().max() <= 1e-4, k


# -- serving (PR 15): the decode paths, the engine and the bank on the card --
def _serving_pair(cuda_device, **over):
    """A TINY f32 LlamaLM on the CPU and its copy on the card."""
    import dataclasses

    from fedml_tpu_torch.llm import model as lm

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(lm.TINY, max_seq_len=64, vocab_size=258,
                              **over)
    cpu = lm.LlamaLM(cfg)
    cpu.init_weights(torch.Generator().manual_seed(5))
    card = lm.LlamaLM(cfg).to(cuda_device)
    card.load_state_dict(cpu.state_dict())
    return cpu, card


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["native", "int8"])
@pytest.mark.parametrize("paged", [False, True])
def test_decode_logits_on_card_match_cpu(cuda_device, kv, paged):
    """Prefill and 4 single-token steps: the card's decode logits within
    1e-5 of the CPU's (f32, TF32 off) on the dense, int8 and paged caches."""
    over = {"kv_cache_dtype": kv}
    if paged:
        over.update(kv_page_tokens=8, kv_pool_pages=12)
    cpu, card = _serving_pair(cuda_device, **over)
    toks = torch.randint(0, 258, (2, 20), generator=torch.Generator()
                         .manual_seed(6))
    bt = torch.tensor([[3, 1, 7, 6], [2, 5, 4, 9]])
    caches = {"cpu": cpu.init_cache(2), "card": card.init_cache(2)}
    for s0, s1 in ((0, 16), (16, 17), (17, 18), (18, 19), (19, 20)):
        got = {}
        for name, m, dev in (("cpu", cpu, "cpu"), ("card", card,
                                                   cuda_device)):
            kw = {"block_tables": bt.to(dev),
                  "start_pos": torch.full((2,), s0, device=dev)} \
                if paged else {"start_pos": s0}
            with torch.no_grad():
                got[name] = m(toks[:, s0:s1].to(dev), decode=True,
                              cache=caches[name], **kw).cpu()
        assert (got["card"] - got["cpu"]).abs().max() <= 1e-5


@pytest.mark.gpu
def test_bf16_score_products_are_f32_of_exact_inputs(cuda_device):
    """The decode scores and P·V: bf16 inputs multiplied exactly and summed
    in f32 (``_acc_f32``) ≡ the f32 product of the upcast inputs to f32
    rounding, far inside bf16's."""
    from fedml_tpu_torch.llm.model import _acc_f32

    g = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn(4, 8, 16, 128, generator=g,
                    device=cuda_device).bfloat16()
    b = torch.randn(4, 8, 128, 1000, generator=g,
                    device=cuda_device).bfloat16()
    got = _acc_f32(a, b)
    assert got.dtype == torch.float32
    want = torch.matmul(a.double(), b.double())
    assert ((got.double() - want).abs() / want.abs().clamp_min(1)).max() \
        <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [{}, {"kv_page_tokens": 8,
                                     "prefill_chunk_tokens": 8},
                                {"horizon": 3}])
def test_engine_on_card_matches_generate(cuda_device, kw):
    """The engine on the card (dense, paged, horizon 3) gives each request
    ``generate``'s greedy tokens, and a sampled request the same draws (f32
    TINY, one generator per request)."""
    from fedml_tpu_torch.serving import ContinuousBatchingEngine
    from fedml_tpu_torch.serving.templates.openai_compat import generate

    _, card = _serving_pair(cuda_device, lora_rank=4)
    prompts = [[5, 17, 42], list(range(30, 58)), [7] * 11, [1, 2, 3, 4]]
    eng = ContinuousBatchingEngine(card, None, slots=2, buf_len=48,
                                   adapter_slots=2, **kw)
    try:
        for temp in (0.0, 0.8):
            qs = [eng.submit(p, max_new_tokens=9, temperature=temp, seed=i)
                  for i, p in enumerate(prompts)]
            got = [[t for t in iter(lambda: q.get(timeout=120), None)]
                   for q in qs]
            want = [generate(None, None, p, max_new_tokens=9, buf_len=48,
                             model=card, temperature=temp, seed=i)
                    for i, p in enumerate(prompts)]
            assert got == want, temp
    finally:
        eng.stop()


# -- ring attention's kernel schedule (phase 18 (c)) -------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("b,h,hkv,s_local,d,dt", [
    (1, 4, 4, 200, 64, "bfloat16"),     # S_local not a tile multiple
    (2, 4, 4, 129, 128, "bfloat16"),    # one row past a tile
    (1, 8, 2, 256, 128, "bfloat16"),    # grouped-query heads
    (1, 8, 2, 100, 64, "float32")])
def test_kernel_ring_matches_plain_ring(cuda_device, b, h, hkv, s_local, d,
                                        dt):
    """The ring's schedule over 4 blocks on one card (each rank's steps by
    slicing): K1 once a visible block forward, K2 and K3 once a visible
    block backward (10 each); the output and gradients held to
    ``KERNEL_TOL`` against the same ring run with each kernel's plain
    version, and the output against the plain ring (the JAX recurrence),
    at block lengths the kernels' tiles do not divide and with
    grouped-query heads.  The gradients against the plain ring's: in f32
    to ``KERNEL_TOL``; in bf16, where its autograd keeps dS in f32 and K2
    and K3 round it to bf16, within one limit of what one call over the
    whole sequence reads against them."""
    from fedml_tpu_torch.ops import ring_attention as ring
    n = 4
    dtype = getattr(torch, dt)
    q, k, v, do = _inputs(b, h, hkv, n * s_local, d, dtype, cuda_device,
                          seed=18)
    tatt.reset_launch_counts()
    o, lse = ring.ring_schedule_fwd(q, k, v, n)
    dq, dk, dv = ring.ring_schedule_bwd(q, k, v, o, lse, do, n)
    torch.cuda.synchronize()
    assert [f.launches for f in tatt.KERNELS] == [10, 10, 10]
    vo, vlse = ring.ring_schedule_fwd(q, k, v, n, plain=True)
    vgrads = ring.ring_schedule_bwd(q, k, v, o, lse, do, n, plain=True)
    for got, ref in zip((o, lse, dq, dk, dv), (vo, vlse) + tuple(vgrads)):
        _close(got, ref)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    po = ring.ring_schedule_plain(*leaves, n)
    _close(o, po)
    pgrads = torch.autograd.grad(po, leaves, do)
    if dtype == torch.float32:
        for got, ref in zip((dq, dk, dv), pgrads):
            _close(got, ref)
        return
    one = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    ograds = torch.autograd.grad(tatt.flash_attention(*one), one, do)
    for got, one_g, ref in zip((dq, dk, dv), ograds, pgrads):
        st, st1 = (tatt.compare_with_plain(t, ref) for t in (got, one_g))
        assert st["elem"] <= st1["elem"] + 1 and \
            st["block"] <= st1["block"] + 1, (st, st1)


@pytest.mark.gpu
def test_ring_of_one_rank_is_one_kernel_call(cuda_device):
    """Without a seq group the ring is one diagonal K1 call forward and
    one K2 and K3 call backward: bitwise ``flash_attention``."""
    from fedml_tpu_torch.ops.ring_attention import ring_attention
    q, k, v, do = _inputs(1, 8, 2, 300, 128, torch.bfloat16, cuda_device,
                          seed=7)
    outs = []
    for fn in (ring_attention, tatt.flash_attention):
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        o = fn(*leaves)
        outs.append((o,) + torch.autograd.grad(o, leaves, do))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,d,hkv", [(200, 64, 4), (1024, 128, 2)])
def test_f32_outputs_of_bf16_kernels_round_to_their_bf16_outputs(
        cuda_device, causal, s, d, hkv):
    """K1, K2 and K3 on bf16 inputs with ``out_f32`` (the ring's partial
    results): the f32 outputs, rounded to bf16, are bitwise the bf16
    outputs, and lse and Δ are the same."""
    q, k, v, do = _inputs(1, 4, hkv, s, d, torch.bfloat16, cuda_device,
                          seed=3)
    o, lse = tatt.flash_attention_fwd(q, k, v, causal)
    o32, lse32 = tatt.flash_attention_fwd(q, k, v, causal, out_f32=True)
    assert o32.dtype == torch.float32
    assert torch.equal(o32.to(torch.bfloat16), o) and torch.equal(lse32, lse)
    dq, delta = tatt.flash_attention_bwd_dq(q, k, v, o, lse, do, causal)
    dq32, delta32 = tatt.flash_attention_bwd_dq(q, k, v, o, lse, do, causal,
                                                out_f32=True)
    assert torch.equal(dq32.to(torch.bfloat16), dq)
    assert torch.equal(delta32, delta)
    dk, dv = tatt.flash_attention_bwd_dkv(q, k, v, lse, delta, do, causal)
    dk32, dv32 = tatt.flash_attention_bwd_dkv(q, k, v, lse, delta, do,
                                              causal, out_f32=True)
    assert torch.equal(dk32.to(torch.bfloat16), dk)
    assert torch.equal(dv32.to(torch.bfloat16), dv)
