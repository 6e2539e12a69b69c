"""The port's flash attention (fedml_tpu_torch.ops.attention) against the JAX
package's Pallas kernels run in interpret mode, on the CPU: forward O and
logsumexp, and dQ/dK/dV through torch.autograd, at the parametrisation of
tests/test_flash_bwd.py (causal and not, S 128 and ragged 96 with 64-row
blocks, GQA H=8/H_kv=2).  f32 throughout; tolerances are the ones the JAX
tests hold the same kernels to (O atol 2e-5 rtol 1e-4; grads atol 5e-5
rtol 1e-3) — they differ only by f32 summation order.

The CUDA kernels themselves are held to their plain versions on the card
by tests/test_torch_gpu.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.ops.attention import (flash_attention_bwd_pallas,
                                     flash_attention_fwd_pallas)
from fedml_tpu_torch.ops import attention as tatt
from fedml_tpu_torch.ops import cuda_build


def _inputs(b, h, hkv, s, d, seed=0, sk=None):
    """q, k, v, dO; k and v have ``sk`` rows (default ``s``)."""
    rng = np.random.default_rng(seed)
    sk = s if sk is None else sk
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    do = rng.standard_normal((b, h, s, d)).astype(np.float32)
    return q, k, v, do


def _jax_ref(q, k, v, do, causal, block):
    out, lse = flash_attention_fwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
        block_q=block, block_k=block, return_lse=True, interpret=True)
    dq, dk, dv = flash_attention_bwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), out, lse,
        jnp.asarray(do), causal, block_q=block, block_k=block,
        interpret=True)
    return [np.asarray(a) for a in (out, lse, dq, dk, dv)]


# the last four: head dims that the bf16 kernels pad to 64 or 128 columns
CASES = [(1, 2, 2, 128, 32, True), (1, 2, 2, 128, 32, False),
         (1, 2, 2, 96, 32, True), (1, 2, 2, 96, 32, False),
         (2, 8, 2, 96, 32, True), (2, 8, 2, 128, 32, False),
         (1, 4, 2, 96, 16, True), (1, 4, 1, 128, 48, False),
         (1, 4, 2, 96, 80, True), (1, 2, 1, 128, 112, False)]


def _matches_pallas_interpret(b, h, hkv, s, d, causal, sk=None):
    q, k, v, do = _inputs(b, h, hkv, s, d, sk=sk)
    r_out, r_lse, r_dq, r_dk, r_dv = _jax_ref(q, k, v, do, causal, 64)

    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out, lse = tatt.flash_attention_fwd(tq, tk, tv, causal)
    np.testing.assert_allclose(out.detach().numpy(), r_out, atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(lse.detach().numpy(), r_lse, atol=2e-5,
                               rtol=1e-4)

    o = tatt.flash_attention(tq, tk, tv, causal)
    np.testing.assert_allclose(o.detach().numpy(), r_out, atol=2e-5,
                               rtol=1e-4)
    gq, gk, gv = torch.autograd.grad(o, (tq, tk, tv), torch.tensor(do))
    for got, ref in ((gq, r_dq), (gk, r_dk), (gv, r_dv)):
        np.testing.assert_allclose(got.numpy(), ref, atol=5e-5, rtol=1e-3)


@pytest.mark.parametrize("b,h,hkv,s,d,causal", CASES)
def test_flash_attention_matches_pallas_interpret(b, h, hkv, s, d, causal):
    _matches_pallas_interpret(b, h, hkv, s, d, causal)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(96, 160), (160, 96)])
def test_flash_attention_matches_pallas_interpret_when_sq_differs_from_sk(
        causal, sq, sk):
    """Fewer queries than keys and more, both ragged against the 64-row
    blocks: the card tests hold the kernels to the plain versions at such
    shapes, so the plain versions are held to the reference here."""
    _matches_pallas_interpret(1, 4, 2, sq, 32, causal, sk=sk)


@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_matches_flash_plain_and_autograd(causal):
    """blockwise_attention under autograd and the explicit plain backward
    of the kernels agree (GQA, ragged S not a multiple of the block)."""
    q, k, v, do = _inputs(1, 4, 2, 70, 16, seed=3)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    ref = tatt.blockwise_attention(tq, tk, tv, causal, block_k=32)
    rg = torch.autograd.grad(ref, (tq, tk, tv), torch.tensor(do))
    got = tatt.flash_attention(tq, tk, tv, causal)
    gg = torch.autograd.grad(got, (tq, tk, tv), torch.tensor(do))
    np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(),
                               atol=2e-5, rtol=1e-4)
    for a, r in zip(gg, rg):
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=5e-5,
                                   rtol=1e-3)


def test_bf16_plain_keeps_f32_accumulation():
    """bf16 inputs: the plain versions compute every product in f32 (the
    reference's preferred_element_type=f32) — the f32 result of the same
    bf16 values differs from it only by the final rounding of O."""
    q, k, v, _ = _inputs(1, 2, 2, 64, 32, seed=5)
    tb = [torch.tensor(a).bfloat16() for a in (q, k, v)]
    out_bf, lse_bf = tatt.flash_attention_fwd(*tb, True)
    out_f, lse_f = tatt.flash_attention_fwd(*(t.float() for t in tb), True)
    assert out_bf.dtype == torch.bfloat16 and lse_bf.dtype == torch.float32
    np.testing.assert_allclose(lse_bf.numpy(), lse_f.numpy(), atol=1e-5)
    np.testing.assert_allclose(out_bf.float().numpy(), out_f.numpy(),
                               atol=2e-2, rtol=1e-2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_tolerance_passes_rounding_and_catches_a_skipped_tile(dtype):
    """``compare_with_plain`` (the rule the kernels are held to on the
    card): exact attention rounded to the output dtype passes against the
    plain version; the same with the last 64 q rows blind to the first 64
    keys (a skipped KV tile) is caught."""
    q, k, v, _ = (torch.tensor(a).to(dtype)
                  for a in _inputs(1, 2, 2, 256, 64, seed=6))
    plain, _ = tatt.flash_attention_fwd_plain(q, k, v, True)

    def exact(keep):
        s = (q.double() @ k.double().transpose(-1, -2)) * 64 ** -0.5
        p = torch.softmax(s.masked_fill(~keep, float("-inf")), -1)
        return (p @ v.double()).to(dtype)

    keep = torch.ones(256, 256, dtype=torch.bool).tril()
    st = tatt.compare_with_plain(exact(keep), plain)
    assert st["elem"] <= 1 and st["block"] <= 1, st
    keep[-64:, :64] = False
    st = tatt.compare_with_plain(exact(keep), plain)
    assert st["elem"] > 1 or st["block"] > 1, st


def test_cuda_wrappers_refuse_cpu_kernel_launch():
    """The wrappers take the plain path only for CPU tensors and never
    count a launch there."""
    tatt.reset_launch_counts()
    q, k, v, do = (torch.tensor(a) for a in _inputs(1, 2, 2, 32, 16))
    o, lse = tatt.flash_attention_fwd(q, k, v)
    dq, delta = tatt.flash_attention_bwd_dq(q, k, v, o, lse, do)
    tatt.flash_attention_bwd_dkv(q, k, v, lse, delta, do)
    assert [f.launches for f in tatt.KERNELS] == [0, 0, 0]
    with pytest.raises(RuntimeError):
        tatt._check("flash_fwd", q, k, v)


@pytest.mark.parametrize("d", [16, 32, 48, 64, 80, 96, 112, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shape_gate_holds_bf16_k1_k3_to_their_head_dims(dtype, d):
    """Every kernel, bf16 K1 and K3 included (they pad the head dim to tiles
    of 64 or 128 columns), takes any head dim that is a multiple of 16 up
    to 128."""
    q = (1, 4, 100, d)
    for kv in ((1, 2, 100, d), (1, 4, 60, d)):
        assert tatt.shape_error(q, kv, kv, dtype) is None


@pytest.mark.parametrize("q,kv,dtype,needle", [
    ((1, 4, 8, 144), (1, 2, 8, 144), torch.float32, "multiple of 16 up to"),
    ((1, 4, 8, 40), (1, 2, 8, 40), torch.float32, "multiple of 16 up to"),
    ((1, 3, 8, 64), (1, 2, 8, 64), torch.bfloat16, "H_kv | H"),
    ((1, 4, 0, 64), (1, 2, 8, 64), torch.bfloat16, "unsupported shapes"),
    ((1, 4, 8, 64), (1, 2, 8, 64), torch.float16, "f32 or bf16"),
    ((4, 8, 64), (1, 2, 8, 64), torch.float32, "(B, H, S, D)")])
def test_shape_gate_names_what_no_kernel_takes(q, kv, dtype, needle):
    assert needle in tatt.shape_error(q, kv, kv, dtype)


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN2fa21flash_fwd_bf16_kernelILi128EEEvPK13__nv_bfloat16S3_S3_PS1_Pfiiiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN2fa21flash_fwd_bf16_kernelILi128EEEvPK13__nv_bfloat16S3_S3_PS1_Pfiiiifi
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN2fa24flash_bwd_dq_bf16_kernelILi128EEEvPK13__nv_bfloat16S3_S3_S3_PKfS3_PS1_Pfiiiiffi' for 'sm_90a'
ptxas info    : Function properties for _ZN2fa24flash_bwd_dq_bf16_kernelILi128EEEvPK13__nv_bfloat16S3_S3_S3_PKfS3_PS1_Pfiiiiffi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 16 bytes smem, 404 bytes cmem[0]
"""


def test_ptxas_report_reads_registers_spills_and_shared_memory():
    assert cuda_build.ptxas_report(PTXAS_LOG) == {
        "flash_fwd_bf16_kernel<128>": {
            "registers": 168, "spill_stores": 8, "spill_loads": 12,
            "smem": 0},
        "flash_bwd_dq_bf16_kernel<128>": {
            "registers": 96, "spill_stores": 0, "spill_loads": 0,
            "smem": 16}}
    assert cuda_build.ptxas_report("") == {}


def test_cached_build_still_reports_its_ptxas_log(tmp_path, monkeypatch):
    """The ``-Xptxas -v`` log is kept beside the library, so a second build
    (a cache hit, no compiler run) returns the same report; a library
    without its log is built again."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/usr/bin/env python3\n"
        "import sys\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'w').close()\n"
        f"sys.stdout.write({PTXAS_LOG!r})\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    first = cuda_build.build(["flash_fwd"])["flash_fwd"]
    second = cuda_build.build(["flash_fwd"])["flash_fwd"]
    assert (first["cached"], second["cached"]) == (False, True)
    assert first["ptxas"] == second["ptxas"] == PTXAS_LOG
    assert "flash_fwd_bf16_kernel<128>" in cuda_build.ptxas_report(
        second["ptxas"])
    lib = cuda_build._lib_path("flash_fwd")
    assert lib.startswith(str(tmp_path / "build"))
    os.remove(lib[:-len(".so")] + ".ptxas")
    assert not cuda_build.build(["flash_fwd"])["flash_fwd"]["cached"]
