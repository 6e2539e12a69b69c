"""Fused attention for the FedLLM path and the text transformer (port of
``fedml_tpu.ops.attention``).

- :func:`blockwise_attention` — streaming-softmax attention as a Python
  loop over KV blocks, differentiable by autograd.  The semantic reference
  and the plain version of the forward kernel.
- :func:`flash_attention` — ``autograd.Function``s over three hand-written
  Hopper kernels (``csrc/``): K1 forward (O and logsumexp), K2 dQ (with the
  Δ = rowsum(dO∘O) preprocess folded in), K3 dK/dV (group-summed over the
  q heads of each KV head inside the kernel).  In bf16 all three keep their
  sums in registers and run their products as warpgroup ``wgmma`` from
  128-byte-swizzled shared-memory tiles (``csrc/flash_sm90.cuh``).  In f32
  (the text transformer's builds) all three run their products on the
  tensor cores as 3xTF32 ``mma.sync`` (``csrc/flash_tf32.cuh``: three TF32
  passes a product keep f32's accuracy), K1 with S, P and O in registers.

Each kernel has a wrapper (:func:`flash_attention_fwd`,
:func:`flash_attention_bwd_dq`, :func:`flash_attention_bwd_dkv`) that
launches it for CUDA tensors — or raises — and takes the kernel's plain
PyTorch version (the ``*_plain`` functions below) only for CPU tensors.
``out_f32`` has a bf16 build write its outputs in f32 (rounded, they are
its bf16 outputs): ring attention sums them over its blocks.
Each wrapper counts its launches in its ``launches`` attribute (inside a
CUDA graph it counts the capture, not the replays).  :func:`flash_attention`
composes with ``torch.func.grad``/``grad_and_value`` and ``vmap``: under a
cohort map each kernel launches once for the whole cohort.

Layouts follow the JAX package: q ``(B, H, S, D)``, k/v ``(B, H_kv, S, D)``
with ``H_kv | H`` (grouped-query heads are index-mapped, never repeated),
lse ``(B, H, S)`` f32.  Numerics carried over from the TPU kernels: f32
accumulation on every product, the ``-1e30`` mask value, the ``1e-30``
floor on the softmax normalizer, P and dS rounded to the operand type
before the products they feed, and zeroed out-of-range rows for ragged S.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import cuda_build

NEG_INF = -1e30


def _scale(q: torch.Tensor, sm_scale: Optional[float]) -> float:
    return float(sm_scale) if sm_scale is not None else q.shape[-1] ** -0.5


def _blockwise(q, k, v, causal: bool, sm_scale: float, block_k: int,
               out_f32: bool = False):
    """(out, lse) by the streaming-softmax recurrence over KV blocks (out
    in f32 with ``out_f32``, else in q's type)."""
    if q.dim() == 4 and k.dim() == 4 and k.shape[1] != q.shape[1]:
        b, h, s_q, d = q.shape
        h_kv = k.shape[1]
        assert h % h_kv == 0, (h, h_kv)
        qg = q.reshape(b, h_kv, h // h_kv, s_q, d)
        out, lse = _blockwise(qg, k[:, :, None], v[:, :, None], causal,
                              sm_scale, block_k, out_f32)
        return out.reshape(b, h, s_q, d), lse.reshape(b, h, s_q)
    s_q, s_k = q.shape[-2], k.shape[-2]
    block_k = min(block_k, s_k)
    lead = torch.broadcast_shapes(q.shape[:-2], k.shape[:-2])
    qf = q.float()
    q_pos = torch.arange(s_q, device=q.device)
    m = torch.full((*lead, s_q), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((*lead, s_q, q.shape[-1]), dtype=torch.float32,
                      device=q.device)
    for k0 in range(0, s_k, block_k):
        kblk, vblk = k[..., k0:k0 + block_k, :], v[..., k0:k0 + block_k, :]
        scores = (qf @ kblk.float().transpose(-1, -2)) * sm_scale
        if causal:
            kv_pos = k0 + torch.arange(kblk.shape[-2], device=q.device)
            scores = torch.where(kv_pos[None, :] <= q_pos[:, None], scores,
                                 NEG_INF)
        m_new = torch.maximum(m, scores.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.to(v.dtype).float() @ vblk.float()
        m = m_new
    l_safe = torch.clamp_min(l, 1e-30)
    out = acc / l_safe[..., None]
    return out if out_f32 else out.to(q.dtype), m + torch.log(l_safe)


def blockwise_attention(q, k, v, causal: bool = True,
                        sm_scale: Optional[float] = None,
                        block_k: int = 256) -> torch.Tensor:
    """Streaming-softmax attention, q/k/v ``(..., S, D)``; GQA on 4-D inputs
    by a grouped view of q (no repeated KV)."""
    return _blockwise(q, k, v, causal, _scale(q, sm_scale), block_k)[0]


# -- plain versions of the three kernels ---------------------------------
def flash_attention_fwd_plain(q, k, v, causal: bool = True,
                              sm_scale: Optional[float] = None,
                              out_f32: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: (O, lse)."""
    return _blockwise(q, k, v, causal, _scale(q, sm_scale), 256, out_f32)


def _bwd_plain_common(q, k, v, lse, delta, do, causal, sm_scale):
    """Dense P and dS over all heads, KV expanded to the q heads."""
    rep = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    s = (q.float() @ kf.transpose(-1, -2)) * sm_scale
    p = torch.exp(s - lse[..., None])
    if causal:
        s_q, s_k = q.shape[2], k.shape[2]
        keep = (torch.arange(s_k, device=q.device)[None, :]
                <= torch.arange(s_q, device=q.device)[:, None])
        p = torch.where(keep, p, 0.0)
    dp = do.float() @ vf.transpose(-1, -2)
    ds = p * (dp - delta[..., None]) * sm_scale
    return kf, p, ds


def flash_attention_bwd_dq_plain(q, k, v, o, lse, do, causal: bool = True,
                                 sm_scale: Optional[float] = None,
                                 out_f32: bool = False):
    """Plain version of K2: (dQ, Δ) with Δ = rowsum(dO∘O) in f32."""
    sm_scale = _scale(q, sm_scale)
    delta = (do.float() * o.float()).sum(-1)
    kf, _, ds = _bwd_plain_common(q, k, v, lse, delta, do, causal, sm_scale)
    dq = ds.to(k.dtype).float() @ kf
    return (dq if out_f32 else dq.to(q.dtype)), delta


def flash_attention_bwd_dkv_plain(q, k, v, lse, delta, do,
                                  causal: bool = True,
                                  sm_scale: Optional[float] = None,
                                  out_f32: bool = False):
    """Plain version of K3: (dK, dV), group-summed over each KV head's q
    heads in f32."""
    sm_scale = _scale(q, sm_scale)
    _, p, ds = _bwd_plain_common(q, k, v, lse, delta, do, causal, sm_scale)
    dv = p.to(do.dtype).float().transpose(-1, -2) @ do.float()
    dk = ds.to(q.dtype).float().transpose(-1, -2) @ q.float()
    b, h_kv, s_k, d = k.shape
    dk = dk.reshape(b, h_kv, -1, s_k, d).sum(2)
    dv = dv.reshape(b, h_kv, -1, s_k, d).sum(2)
    if out_f32:
        return dk, dv
    return dk.to(k.dtype), dv.to(v.dtype)


# -- kernel wrappers ------------------------------------------------------
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def shape_error(q_shape, k_shape, v_shape,
                dtype: torch.dtype) -> Optional[str]:
    """Why the kernels cannot take q/k/v of these shapes and ``dtype``, or
    None if they can.  Every kernel takes head dims that are multiples of 16
    up to 128, in f32 and in bf16 (the bf16 kernels pad them to tiles of 64
    or 128 columns)."""
    if dtype not in _DTYPES:
        return f"flash-attention kernels take f32 or bf16, got {dtype}"
    if len(q_shape) != 4 or len(k_shape) != 4:
        return (f"q/k/v must be (B, H, S, D), got {tuple(q_shape)} and "
                f"{tuple(k_shape)}")
    b, h, s_q, d = q_shape
    h_kv = k_shape[1]
    if (k_shape[0] != b or k_shape[3] != d or tuple(v_shape) != tuple(k_shape)
            or h % h_kv or d % 16 or d > 128 or s_q == 0 or k_shape[2] == 0):
        return (f"unsupported shapes q {tuple(q_shape)} k {tuple(k_shape)} "
                f"v {tuple(v_shape)} (need H_kv | H, head_dim a multiple of "
                "16 up to 128)")
    return None


def _check(kernel: str, q, k, v, **more):
    """Raise on anything the kernel does not take."""
    if q.device.type != "cuda":
        raise RuntimeError(f"flash-attention kernels need CUDA tensors, got "
                           f"{q.device}")
    msg = shape_error(q.shape, k.shape, v.shape, q.dtype)
    if msg is not None:
        raise (TypeError if q.dtype not in _DTYPES else ValueError)(
            f"{kernel}: {msg}")
    b, h, s_q, _ = q.shape
    lse_shape = (b, h, s_q)
    for name, t in dict(q=q, k=k, v=v, **more).items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        want_dtype = torch.float32 if name in ("lse", "delta") else q.dtype
        if t.dtype != want_dtype:
            raise TypeError(f"{name} is {t.dtype}, expected {want_dtype}")
        want = lse_shape if name in ("lse", "delta") else (
            q.shape if name in ("o", "do") else None)
        if want is not None and tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{want}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """The kernels copy rows in 16-byte chunks: a view whose data does not
    start on a 16-byte boundary is copied into a fresh allocation."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(name: str, tensors, q, k, causal: bool,
            sm_scale: Optional[float], out_f32: bool = False) -> None:
    """Call ``csrc/<name>.cu`` on ``tensors`` (pointers in the C order) on
    the current stream of q's device; raise unless it returned cudaSuccess.
    ``out_f32`` with bf16 inputs: the outputs are f32 buffers (the C
    ``dtype`` 2)."""
    b, h, s_q, d = q.shape
    dtype = 2 if out_f32 and q.dtype == torch.bfloat16 else _DTYPES[q.dtype]
    lib = cuda_build.library(name)
    with torch.cuda.device(q.device):
        rc = getattr(lib, name)(
            *(t.data_ptr() for t in tensors), b, h, k.shape[1], s_q,
            k.shape[2], d, _scale(q, sm_scale), int(causal), dtype,
            torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(lib, name, rc)


def flash_attention_fwd(q, k, v, causal: bool = True,
                        sm_scale: Optional[float] = None,
                        out_f32: bool = False):
    """K1: (O, lse); O in f32 with ``out_f32`` (ring attention's partial
    outputs), else in q's type.  CPU tensors take
    :func:`flash_attention_fwd_plain`."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, sm_scale, out_f32)
    _check("flash_fwd", q, k, v)
    q, k, v = map(_aligned, (q, k, v))
    o = torch.empty(q.shape, dtype=torch.float32 if out_f32 else q.dtype,
                    device=q.device)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch("flash_fwd", (q, k, v, o, lse), q, k, causal, sm_scale, out_f32)
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_bwd_dq(q, k, v, o, lse, do, causal: bool = True,
                           sm_scale: Optional[float] = None,
                           out_f32: bool = False):
    """K2: (dQ, Δ); dQ in f32 with ``out_f32``.  CPU tensors take
    :func:`flash_attention_bwd_dq_plain`."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, o, lse, do, causal,
                                            sm_scale, out_f32)
    _check("flash_bwd_dq", q, k, v, o=o, lse=lse, do=do)
    q, k, v, o, do = map(_aligned, (q, k, v, o, do))
    dq = torch.empty(q.shape, dtype=torch.float32 if out_f32 else q.dtype,
                     device=q.device)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch("flash_bwd_dq", (q, k, v, o, lse, do, dq, delta), q, k, causal,
            sm_scale, out_f32)
    flash_attention_bwd_dq.launches += 1
    return dq, delta


def flash_attention_bwd_dkv(q, k, v, lse, delta, do, causal: bool = True,
                            sm_scale: Optional[float] = None,
                            out_f32: bool = False):
    """K3: (dK, dV); in f32 with ``out_f32``.  CPU tensors take
    :func:`flash_attention_bwd_dkv_plain`."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, lse, delta, do, causal,
                                             sm_scale, out_f32)
    _check("flash_bwd_dkv", q, k, v, lse=lse, delta=delta, do=do)
    q, k, v, do = map(_aligned, (q, k, v, do))
    odt = torch.float32 if out_f32 else k.dtype
    dk = torch.empty(k.shape, dtype=odt, device=k.device)
    dv = torch.empty(v.shape, dtype=odt, device=v.device)
    _launch("flash_bwd_dkv", (q, k, v, lse, delta, do, dk, dv), q, k, causal,
            sm_scale, out_f32)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


KERNELS = (flash_attention_fwd, flash_attention_bwd_dq,
           flash_attention_bwd_dkv)

#: How far a kernel's output may lie from its plain version's on the same
#: inputs, by the output's dtype: (atol, rtol, nrel).  Per element,
#: ``|kernel − plain| <= atol + rtol·|plain|``; per block of
#: ``TOL_BLOCK_ROWS`` sequence rows of one head, ``‖kernel − plain‖ <=
#: nrel·‖plain‖``.  In bf16 both versions round P and dS to bf16 before
#: their products, at other points of the online softmax, and round their
#: outputs to bf16 (one ulp is 2^-8..2^-7 relative): rtol is two ulps, atol
#: covers the small entries, and the block norm catches a wrong tile among
#: small outputs that the per-element rule alone would let pass.  f32 (and
#: the f32 lse and Δ) differ only by the order of their sums.
KERNEL_TOL = {torch.bfloat16: (2e-3, 1.6e-2, 1e-2),
              torch.float32: (1e-5, 1e-4, 1e-4)}
TOL_BLOCK_ROWS = 64


def compare_with_plain(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """``got`` (a kernel's output) against ``ref`` (its plain version's),
    held to ``KERNEL_TOL[ref.dtype]``; q-shaped ``(B, H, S, D)`` or
    row-shaped ``(B, H, S)``.  Returns ``err`` (max abs), ``elem`` and
    ``block`` (the worst element's and the worst row block's share of its
    limit: the check holds iff both are <= 1), and ``median`` and ``max``
    of ``|ref|``."""
    atol, rtol, nrel = KERNEL_TOL[ref.dtype]
    g, r = got.float(), ref.float()
    if r.dim() == 3:
        g, r = g[..., None], r[..., None]
    err = (g - r).abs()
    pad = -r.shape[-2] % TOL_BLOCK_ROWS

    def block_norm(x):
        x2 = torch.nn.functional.pad((x * x).sum(-1), (0, pad))
        return x2.reshape(*x2.shape[:-1], -1, TOL_BLOCK_ROWS).sum(-1).sqrt()

    ra = r.abs()
    return {"err": err.max().item(),
            "elem": (err / (atol + rtol * ra)).max().item(),
            "block": (block_norm(err) / (nrel * block_norm(r))
                      .clamp_min(1e-30)).max().item(),
            "median": ra.median().item(), "max": ra.max().item()}


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


reset_launch_counts()


# -- autograd and torch.func ----------------------------------------------
# Each kernel is an autograd.Function in the functorch style (``forward``
# without ctx, ``setup_context``, a ``vmap`` rule), so ``flash_attention``
# runs under plain autograd, ``torch.func.grad_and_value`` and
# ``torch.func.vmap``, nested too.  A vmap rule folds every mapped dim into
# the batch dim B and calls the same Function once on the folded tensors:
# a cohort of C clients, each (B, H, S, D), is one launch on (C·B, H, S, D),
# and a map of P members around it folds once more.  The forward's backward
# calls the K2 and K3 Functions, so under ``vmap`` the backward is batched
# by their own rules.  Nothing here syncs the host, so the whole path can be
# captured in a CUDA graph.

def _fold(t: torch.Tensor, d: Optional[int], n: int) -> torch.Tensor:
    """``t`` with its mapped dim ``d`` of size ``n`` moved to the front and
    folded into the batch dim (an unmapped ``t``, ``d`` None, is expanded
    to ``n``); copies only what cannot be viewed."""
    t = t.expand(n, *t.shape) if d is None else t.movedim(d, 0)
    return t.reshape(n * t.shape[1], *t.shape[2:])


def _unfold(t: torch.Tensor, n: int) -> torch.Tensor:
    return t.reshape(n, t.shape[0] // n, *t.shape[1:])


def _contiguous(*tensors):
    return tuple(t.contiguous() for t in tensors)


def _fold_all(info, in_dims, tensors):
    return tuple(_fold(t, d, info.batch_size)
                 for t, d in zip(tensors, in_dims))


class _FlashFwd(torch.autograd.Function):
    """K1: (O, lse), lse not differentiable; backward is K2 then K3."""

    @staticmethod
    def forward(q, k, v, causal, sm_scale):
        return flash_attention_fwd(*_contiguous(q, k, v), causal, sm_scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, sm_scale = inputs
        o, lse = output
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, delta = _FlashBwdDQ.apply(q, k, v, o, lse, do, ctx.causal,
                                      ctx.sm_scale)
        dk, dv = _FlashBwdDKV.apply(q, k, v, lse, delta, do, ctx.causal,
                                    ctx.sm_scale)
        return dq, dk, dv, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, sm_scale):
        o, lse = _FlashFwd.apply(*_fold_all(info, in_dims, (q, k, v)),
                                 causal, sm_scale)
        n = info.batch_size
        return (_unfold(o, n), _unfold(lse, n)), (0, 0)


def _no_double_backward(name):
    raise RuntimeError(f"{name}: double backward through flash attention "
                       "is not supported")


class _FlashBwdDQ(torch.autograd.Function):
    """K2: (dQ, Δ)."""

    @staticmethod
    def forward(q, k, v, o, lse, do, causal, sm_scale):
        return flash_attention_bwd_dq(*_contiguous(q, k, v, o, lse, do),
                                      causal, sm_scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        _no_double_backward("flash_bwd_dq")

    @staticmethod
    def vmap(info, in_dims, q, k, v, o, lse, do, causal, sm_scale):
        dq, delta = _FlashBwdDQ.apply(
            *_fold_all(info, in_dims, (q, k, v, o, lse, do)), causal,
            sm_scale)
        n = info.batch_size
        return (_unfold(dq, n), _unfold(delta, n)), (0, 0)


class _FlashBwdDKV(torch.autograd.Function):
    """K3: (dK, dV)."""

    @staticmethod
    def forward(q, k, v, lse, delta, do, causal, sm_scale):
        return flash_attention_bwd_dkv(*_contiguous(q, k, v, lse, delta, do),
                                       causal, sm_scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        _no_double_backward("flash_bwd_dkv")

    @staticmethod
    def vmap(info, in_dims, q, k, v, lse, delta, do, causal, sm_scale):
        dk, dv = _FlashBwdDKV.apply(
            *_fold_all(info, in_dims, (q, k, v, lse, delta, do)), causal,
            sm_scale)
        n = info.batch_size
        return (_unfold(dk, n), _unfold(dv, n)), (0, 0)


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Fused attention: K1 forward, K2+K3 backward (no S×S tensor on the
    card in either pass); the plain versions on the CPU.  Composes with
    ``torch.func.grad``/``grad_and_value`` and ``vmap``: a mapped cohort
    is one launch of each kernel."""
    return _FlashFwd.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal, sm_scale)[0]
