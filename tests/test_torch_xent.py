"""The port's streaming (vocab-chunked) cross-entropy against the JAX
package's ``fedml_tpu.ops.xent.streaming_xent`` and against the dense loss
on the full logits, on the CPU, from the same numpy-seeded inputs.

Cases: a vocabulary the chunk divides and one it does not (padded, masked
columns), f32 and bf16 hidden states (and bf16 head weights), loss, dh and
dw.  Tolerances: f32 loss 2e-6 and grads 1e-6 abs + 1e-5 rel (the same f32
products in another summation order).  With bf16 operands the loss is
still held to 1e-5, and each token's NLL to 1e-5: the chunk products run in
f32 on the upcast operands, as the dense f32 logits and JAX's
``preferred_element_type=f32`` do.  A control leaves the products in bf16
(what ``bf16 @ bf16`` returns in torch) and must break both limits.  The
bf16 grads are held to 1e-2, as the JAX test holds its own bf16 case (dh
and a bf16 dw are rounded to bf16 at the end, so one bf16 ulp may differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fedml_tpu.ops.xent import streaming_xent as j_xent
from fedml_tpu_torch.llm.model import causal_nll
from fedml_tpu_torch.ops import xent as xent_mod
from fedml_tpu_torch.ops.xent import streaming_xent

B, S, D = 2, 12, 24


def _inputs(v, h_dtype, w_dtype, seed=0, d=D):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, S, d)).astype(np.float32)
    w = (0.3 * rng.standard_normal((d, v))).astype(np.float32)
    t = rng.integers(0, v, size=(B, S))
    th = torch.tensor(h).to(h_dtype)
    tw = torch.tensor(w).to(w_dtype)
    jh = jnp.asarray(th.float().numpy()).astype(
        jnp.bfloat16 if h_dtype == torch.bfloat16 else jnp.float32)
    jw = jnp.asarray(tw.float().numpy()).astype(
        jnp.bfloat16 if w_dtype == torch.bfloat16 else jnp.float32)
    return th, tw, torch.tensor(t), jh, jw, jnp.asarray(t)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _port_grads(fn, h, w, t):
    h = h.detach().requires_grad_(True)
    w = w.detach().requires_grad_(True)
    loss = fn(h, w, t)
    gh, gw = torch.autograd.grad(loss, (h, w))
    return loss.item(), gh.float().numpy(), gw.float().numpy()


DTYPES = {"f32": (torch.float32, torch.float32),
          "bf16_h": (torch.bfloat16, torch.float32),
          "bf16_hw": (torch.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("v,chunk", [(64, 16), (70, 16), (50, 64)])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_streaming_xent_matches_jax_and_dense(v, chunk, dt):
    h_dtype, w_dtype = DTYPES[dt]
    th, tw, tt, jh, jw, jt = _inputs(v, h_dtype, w_dtype)
    loss, gh, gw = _port_grads(
        lambda h, w, t: streaming_xent(h, w, t, chunk), th, tw, tt)

    j_loss, (j_gh, j_gw) = jax.value_and_grad(
        lambda h, w: j_xent(h, w, jt, chunk), argnums=(0, 1))(jh, jw)
    # dense reference: f32 logits of the same (rounded) operands
    d_loss, d_gh, d_gw = _port_grads(
        lambda h, w, t: causal_nll(h.float() @ w.float(), t), th, tw, tt)

    f32 = dt == "f32"
    ltol = 2e-6 if f32 else LOSS_TOL
    atol, rtol = (1e-6, 1e-5) if f32 else (1e-2, 1e-2)
    assert abs(loss - float(j_loss)) < ltol, (loss, float(j_loss))
    assert abs(loss - d_loss) < ltol, (loss, d_loss)
    np.testing.assert_allclose(gh, _np(j_gh), atol=atol, rtol=rtol)
    np.testing.assert_allclose(gw, _np(j_gw), atol=atol, rtol=rtol)
    np.testing.assert_allclose(gh, d_gh, atol=atol, rtol=rtol)
    np.testing.assert_allclose(gw, d_gw, atol=atol, rtol=rtol)


#: streaming vs dense f32 logits of the same bf16 operands: the mean loss
#: and each token's NLL
LOSS_TOL = 1e-5


def _bf16_chunk_logits(h2f, w, base, chunk):
    """The control: each chunk product left in bf16, as ``bf16 @ bf16``
    returns it in torch, then widened (padded columns still masked)."""
    logits, wc = _F32_CHUNK_LOGITS(h2f, w, base, chunk)
    lb = (h2f.bfloat16() @ wc.bfloat16()).float()
    return torch.where(logits == xent_mod.NEG_INF, logits, lb), wc


_F32_CHUNK_LOGITS = xent_mod._chunk_logits


def _per_token(fn, h, w, t):
    h2, t2 = h.reshape(-1, h.shape[-1]), t.reshape(-1)
    return np.array([fn(h2[i:i + 1], w, t2[i:i + 1]).item()
                     for i in range(len(t2))])


@pytest.mark.parametrize("v,chunk", [(64, 16), (70, 16), (50, 64)])
@pytest.mark.parametrize("dt", ["bf16_h", "bf16_hw"])
def test_bf16_operands_keep_f32_logits(v, chunk, dt, monkeypatch):
    """bf16 ``h``/``w``: the loss and every token's NLL equal the dense f32
    logits' within ``LOSS_TOL``; the same call with the chunk products left
    in bf16 breaks both limits, so the check sees the missing upcast."""
    th, tw, tt, *_ = _inputs(v, *DTYPES[dt])
    dense = lambda h, w, t: causal_nll(h.float() @ w.float(), t)
    stream = lambda h, w, t: streaming_xent(h, w, t, chunk)
    ref, ref_tok = dense(th, tw, tt).item(), _per_token(dense, th, tw, tt)
    errs = (abs(stream(th, tw, tt).item() - ref),
            np.abs(_per_token(stream, th, tw, tt) - ref_tok).max())
    monkeypatch.setattr(xent_mod, "_chunk_logits", _bf16_chunk_logits)
    ctrl = (abs(stream(th, tw, tt).item() - ref),
            np.abs(_per_token(stream, th, tw, tt) - ref_tok).max())
    assert max(errs) < LOSS_TOL, errs
    assert min(ctrl) > LOSS_TOL, ctrl


def test_frozen_head_skips_dw_and_keeps_dh():
    """With ``w`` frozen (the LoRA paths' lm_head) only dh is computed, and
    it is the dh of the trainable-head call."""
    th, tw, tt, *_ = _inputs(70, torch.float32, torch.float32, seed=3)
    h = th.clone().requires_grad_(True)
    (gh_frozen,) = torch.autograd.grad(streaming_xent(h, tw, tt, 16), h)
    _, gh, _ = _port_grads(lambda h, w, t: streaming_xent(h, w, t, 16),
                           th, tw, tt)
    np.testing.assert_array_equal(gh_frozen.numpy(), gh)


def test_grad_and_value_accepts_it():
    th, tw, tt, *_ = _inputs(64, torch.float32, torch.float32, seed=4)
    g, val = torch.func.grad_and_value(
        lambda h: streaming_xent(h, tw, tt, 16))(th)
    _, gh, _ = _port_grads(lambda h, w, t: streaming_xent(h, w, t, 16),
                           th, tw, tt)
    assert val.item() == pytest.approx(
        streaming_xent(th, tw, tt, 16).item(), abs=0)
    np.testing.assert_array_equal(g.numpy(), gh)


class _Shapes(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(o, torch.Tensor):
                self.shapes.append(tuple(o.shape))
        return out


def test_no_token_by_vocab_tensor_is_made():
    """Forward and backward hold at most chunk columns of logits: no tensor
    of ``(N, ≥V)`` appears (the ``(D, V)`` dw is the only vocab-wide one;
    D 16 < N 24 keeps the two apart)."""
    n, v, chunk = B * S, 4096, 256
    th, tw, tt, *_ = _inputs(v, torch.float32, torch.float32, seed=5, d=16)
    h = th.clone().requires_grad_(True)
    w = tw.clone().requires_grad_(True)
    with _Shapes() as mode:
        loss = streaming_xent(h, w, tt, chunk)
        torch.autograd.grad(loss, (h, w))
    wide = [s for s in mode.shapes if len(s) >= 2 and s[-1] >= v
            and s[-2] >= n]
    assert not wide, wide
