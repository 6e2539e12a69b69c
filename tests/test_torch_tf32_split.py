"""Why the f32 builds of K1, K2 and K3 run each product as three TF32
passes (``fedml_tpu_torch/csrc/flash_tf32.cuh``), pinned on the CPU.

The card's TF32 products round each operand to TF32 (``cvt.rna.tf32.f32``:
10 mantissa bits, round to nearest, ties away from zero).  Emulated here
with integer bit arithmetic on torch f32 tensors, the attention forward's
two products (S = Q·Kᵀ, and O += P·V inside the online softmax over K1's
64-key tiles) and the backward's five (S = Q·Kᵀ, dP = dO·Vᵀ, dQ = dS·K,
dK = dSᵀ·Q, dV = Pᵀ·dO) at the text transformer's head layout (H 8, S 128,
D 32, full; B cut to 2) are held to the plain f32 path of
``ops/attention.py`` by ``compare_with_plain``'s f32 rule
(``KERNEL_TOL[float32]``): the 3xTF32 split ``a·b ≈ lo_a·hi_b + hi_a·lo_b
+ hi_a·hi_b`` (``hi = tf32(x)``, ``lo = tf32(x − hi)``) stays within a
tenth of both limits; one TF32 pass (``hi_a·hi_b``) breaks them (the
forward's lse, an average over the keys, only loses that margin).  The
emulation sums in f32 on the CPU and does not model the tensor cores' own
accumulation: the card tests (``tests/test_torch_gpu.py``) hold the
kernels themselves.
"""

import numpy as np
import pytest
import torch

from fedml_tpu_torch.ops import attention as tatt

_MAG = 0x7FFFFFFF
_ROUND = 0x1000          # half of the 13 mantissa bits TF32 drops
_KEEP = ~0x1FFF          # clears them


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on f32 ``x``: the 13 low mantissa bits
    cleared after adding half of them to the magnitude (round to nearest,
    ties away from zero; a carry moves into the exponent); inf and nan
    untouched."""
    bits = x.contiguous().view(torch.int32)
    mag = bits & _MAG
    rounded = ((mag + _ROUND) & _KEEP) | (bits & ~_MAG)
    return torch.where(mag < 0x7F800000, rounded, bits).view(torch.float32)


def mm_1xtf32(a, b):
    return tf32(a) @ tf32(b)


def mm_3xtf32(a, b):
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _f32(bits: int) -> float:
    return float(np.array([bits], dtype=np.uint32).view(np.float32)[0])


@pytest.mark.parametrize("x,want", [
    (1.0, 1.0),
    (1 + 2 ** -10, 1 + 2 ** -10),              # kept: TF32's last bit
    (1 + 2 ** -11, 1 + 2 ** -10),              # a tie: away from zero
    (-(1 + 2 ** -11), -(1 + 2 ** -10)),
    (1 + 2 ** -11 - 2 ** -23, 1.0),            # just under the tie
    (1 + 3 * 2 ** -11, 1 + 2 ** -9),           # a tie, odd below
    (2 - 2 ** -23, 2.0),                       # carry into the exponent
    (_f32(0x00000001), 0.0),                   # smallest subnormal
    (_f32(0x00001000), _f32(0x00002000)),      # subnormal tie
    (-0.0, -0.0),
    (float("inf"), float("inf")),
    (float("-inf"), float("-inf")),
])
def test_tf32_rounding_edges(x, want):
    got = tf32(torch.tensor([x], dtype=torch.float32))
    ref = torch.tensor([want], dtype=torch.float32)
    assert got.view(torch.int32).item() == ref.view(torch.int32).item(), \
        (x, got.item(), want)


def test_tf32_leaves_nan_payloads_alone():
    bits = torch.tensor([0x7FC00000, 0x7F800001, -0x00400000 - 1],
                        dtype=torch.int32)   # quiet, signalling, negative
    assert torch.equal(tf32(bits.view(torch.float32)).view(torch.int32),
                       bits)


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor(np.random.default_rng(0).standard_normal(4096)
                     .astype(np.float32))
    r = tf32(x)
    assert not (r.view(torch.int32) & 0x1FFF).any()
    rel = ((r - x).abs() / x.abs()).max().item()
    assert 2 ** -12 < rel <= 2 ** -11


def _emulated_backward(mm, q, k, v, o, lse, do, scale):
    """(dQ, dK, dV) of full attention with every product through ``mm``;
    the elementwise steps as the plain path takes them."""
    delta = (do * o).sum(-1)
    p = torch.exp(mm(q, k.transpose(-1, -2)) * scale - lse[..., None])
    dp = mm(do, v.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    return (mm(ds, k), mm(ds.transpose(-1, -2), q),
            mm(p.transpose(-1, -2), do))


@pytest.fixture(scope="module")
def text_backward():
    """The plain f32 (dQ, dK, dV) at the text head layout, and the same
    through 1xTF32 and 3xTF32 products, from numpy-seeded inputs."""
    b, h, s, d = 2, 8, 128, 32
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.tensor(rng.standard_normal((b, h, s, d))
                                .astype(np.float32)) for _ in range(4))
    o, lse = tatt.flash_attention_fwd_plain(q, k, v, False)
    dq, delta = tatt.flash_attention_bwd_dq_plain(q, k, v, o, lse, do, False)
    dk, dv = tatt.flash_attention_bwd_dkv_plain(q, k, v, lse, delta, do,
                                                False)
    scale = d ** -0.5
    return {"plain": (dq, dk, dv),
            1: _emulated_backward(mm_1xtf32, q, k, v, o, lse, do, scale),
            3: _emulated_backward(mm_3xtf32, q, k, v, o, lse, do, scale)}


@pytest.mark.parametrize("i,name", [(0, "dQ"), (1, "dK"), (2, "dV")])
def test_3xtf32_holds_the_f32_limits_with_10x_margin(text_backward, i,
                                                     name):
    st = tatt.compare_with_plain(text_backward[3][i],
                                 text_backward["plain"][i])
    assert st["elem"] <= 0.1 and st["block"] <= 0.1, (name, st)


@pytest.mark.parametrize("i,name", [(0, "dQ"), (1, "dK"), (2, "dV")])
def test_1xtf32_breaks_the_f32_limits(text_backward, i, name):
    st = tatt.compare_with_plain(text_backward[1][i],
                                 text_backward["plain"][i])
    assert st["elem"] > 1 and st["block"] > 1, (name, st)


def _emulated_forward(mm, q, k, v, scale, block_k=64):
    """(O, lse) of full attention by K1's online softmax over tiles of
    ``block_k`` keys, both products through ``mm``."""
    m = torch.full(q.shape[:-1], tatt.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    for k0 in range(0, k.shape[-2], block_k):
        s = mm(q, k[..., k0:k0 + block_k, :].transpose(-1, -2)) * scale
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + mm(p, v[..., k0:k0 + block_k, :])
        m = m_new
    l = l.clamp_min(1e-30)
    return acc / l[..., None], m + torch.log(l)


@pytest.fixture(scope="module")
def text_forward():
    """The plain f32 (O, lse) at the text head layout, and the same
    through 1xTF32 and 3xTF32 products, from numpy-seeded inputs."""
    b, h, s, d = 2, 8, 128, 32
    rng = np.random.default_rng(1)
    q, k, v = (torch.tensor(rng.standard_normal((b, h, s, d))
                            .astype(np.float32)) for _ in range(3))
    scale = d ** -0.5
    return {"plain": tatt.flash_attention_fwd_plain(q, k, v, False),
            1: _emulated_forward(mm_1xtf32, q, k, v, scale),
            3: _emulated_forward(mm_3xtf32, q, k, v, scale)}


@pytest.mark.parametrize("i,name", [(0, "O"), (1, "lse")])
def test_forward_3xtf32_holds_the_f32_limits_with_10x_margin(text_forward,
                                                             i, name):
    st = tatt.compare_with_plain(text_forward[3][i],
                                 text_forward["plain"][i])
    assert st["elem"] <= 0.1 and st["block"] <= 0.1, (name, st)


def test_forward_1xtf32_breaks_the_f32_limits_on_o(text_forward):
    st = tatt.compare_with_plain(text_forward[1][0], text_forward["plain"][0])
    assert st["elem"] > 1 and st["block"] > 1, st


def test_forward_1xtf32_loses_the_10x_margin_on_lse(text_forward):
    """lse averages S's rounding over the keys, so one TF32 pass stays
    inside its limit (~0.6–0.8 of it per element) but not inside the tenth
    that 3xTF32 keeps: it is O that one pass breaks."""
    st = tatt.compare_with_plain(text_forward[1][1], text_forward["plain"][1])
    assert st["elem"] > 0.1, st
