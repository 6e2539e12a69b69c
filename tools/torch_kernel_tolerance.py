#!/usr/bin/env python3
"""Does the kernel-vs-plain check (``fedml_tpu_torch.ops.attention.
KERNEL_TOL``) catch a wrong kernel at the slice's shape (B 2, H 32, S 1024,
D 128, causal, bf16)?

A wrong kernel is modelled as the plain version's output plus what one
masking fault changes in exact (f32, dense) attention:

- ``drop``: the last 64 q rows do not see the first 64 keys (a skipped KV
  tile);
- ``diag``: the last 64 q rows see all of their diagonal 64×64 tile (a
  causal mask left off the diagonal tile).

For each output (O, dQ, dK, dV) it prints the worst element's and the worst
64-row block's share of their limits under ``KERNEL_TOL`` (caught if either
is above 1), beside the earlier rule ``max|err| <= 1e-2 + 2e-2·max|plain|``,
and the same numbers for the real kernels, each against its plain version
on the same inputs (K2 and K3 on K1's O and lse, K3 on K2's Δ), which must
pass, with the least rtol that would pass them at the rule's atol.

    python3 tools/torch_kernel_tolerance.py
"""

import os
import subprocess
import sys

TILE = 64


def dense(torch, q, k, v, do, keep):
    """O, dQ, dK, dV of exact attention in f32 under the mask ``keep``."""
    qf, kf, vf = (t.float().requires_grad_(True) for t in (q, k, v))
    s = (qf @ kf.transpose(-1, -2)) * q.shape[-1] ** -0.5
    o = torch.softmax(s.masked_fill(~keep, float("-inf")), -1) @ vf
    return (o.detach(), *torch.autograd.grad(o, (qf, kf, vf), do.float()))


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from fedml_tpu_torch.ops import attention as att

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    b, h, s, d = 2, 32, 1024, 128
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    q, k, v, do = (torch.randn((b, h, s, d), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    po, plse = att.flash_attention_fwd_plain(q, k, v, True)
    pdq, delta = att.flash_attention_bwd_dq_plain(q, k, v, po, plse, do, True)
    pdk, pdv = att.flash_attention_bwd_dkv_plain(q, k, v, plse, delta, do,
                                                 True)
    plain = (po, pdq, pdk, pdv)
    o, lse = att.flash_attention_fwd(q, k, v, True)
    dq, delta_k = att.flash_attention_bwd_dq(q, k, v, o, lse, do, True)
    dk, dv = att.flash_attention_bwd_dkv(q, k, v, lse, delta_k, do, True)
    same = (po,
            att.flash_attention_bwd_dq_plain(q, k, v, o, lse, do, True)[0],
            *att.flash_attention_bwd_dkv_plain(q, k, v, lse, delta_k, do,
                                               True))

    causal = torch.ones(s, s, dtype=torch.bool, device="cuda").tril()
    drop, diag = causal.clone(), causal.clone()
    drop[-TILE:, :TILE] = False
    diag[-TILE:, -TILE:] = True
    exact = dense(torch, q, k, v, do, causal)
    cases = {"kernel": ((o, dq, dk, dv), same)}
    for name, keep in (("drop", drop), ("diag", diag)):
        wrong = dense(torch, q, k, v, do, keep)
        cases[name] = (tuple((p.float() + w - e).to(p.dtype)
                             for p, w, e in zip(plain, wrong, exact)), plain)
    print(f"card: {smi}; B{b} H{h} S{s} D{d} causal bf16; rule "
          f"{att.KERNEL_TOL[torch.bfloat16]} (atol, rtol, nrel)")
    atol = att.KERNEL_TOL[torch.bfloat16][0]
    for case, (outs, refs) in cases.items():
        for what, got, ref in zip(("O", "dQ", "dK", "dV"), outs, refs):
            st = att.compare_with_plain(got, ref)
            err, ra = (got.float() - ref.float()).abs(), ref.float().abs()
            least_rtol = ((err - atol) / ra).max().item()
            old = st["err"] / (1e-2 + 2e-2 * st["max"])
            caught = st["elem"] > 1 or st["block"] > 1
            print(f"  {case:6s} {what:2s}: max err {st['err']:.2e}, "
                  f"|plain| median {st['median']:.2e} max {st['max']:.2e}; "
                  f"element {st['elem']:.2f}, block {st['block']:.2f} "
                  f"-> {'caught' if caught else 'passes'}; earlier rule "
                  f"{old:.2f} -> {'caught' if old > 1 else 'passes'}; "
                  f"least rtol at atol {atol:g}: {least_rtol:.2e}")


if __name__ == "__main__":
    main()
