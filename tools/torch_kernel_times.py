#!/usr/bin/env python3
"""Time the port's flash-attention kernels K1–K3 on one card at
the shapes ``chip_smoke.py`` phase 3 times, for one checkout or several in
turns.

    python3 tools/torch_kernel_times.py [--shapes text,slice,text_bf16]
        [--roots DIR,DIR,...] [--rounds N] [--unchecked]

Each root is a checkout of this repository (default: this one); each
round times every root in turn, each in its own process that builds that
checkout's kernels from its own ``csrc/`` (so ``--roots parent,.
--rounds 2`` runs parent, change, parent, change on one card).  A timing is
``chip_smoke.py::time_kernels`` of this checkout on inputs drawn from seed
0, after each kernel is held to its plain version (``compare_with_plain``;
``--unchecked`` skips that, for builds altered on purpose to see what a
part of a kernel costs).  Two readings per kernel and per library call:

- device time: after two warm calls on a side stream, 20 calls are
  captured in one CUDA graph, which is replayed once untimed and three
  times under CUDA events (``graph_ms``); the calls run back to back with
  no host work between them.  A library call that cannot be captured is
  read instead from ``torch.profiler``'s ``key_averages()``: the summed
  device time of the kernels of 20 eager calls (``profiler_ms``); each row
  names the method (``library_method``);
- eager time: CUDA events around 20 calls from Python (``time_ms``), which
  is what an unfused round pays; a kernel faster than its wrapper's host
  work reads as the host work here.

Beside them: the plain version (eager), and the bound at this checkout's
peaks, with TFLOP/s and the share of the bound from the device time.
Prints one line per kernel and the card's name and power limit; writes
every row to ``chiprun_out/kernel_times.json``.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(root, shapes, checked):
    """Time one checkout's kernels; print its rows as one JSON line."""
    import torch
    cs = _chip_smoke()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this needs a card")
    sys.path.insert(0, os.path.abspath(root))
    from fedml_tpu_torch.ops import attention as att
    from fedml_tpu_torch.ops import cuda_build
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi()
    reports = {name: cuda_build.ptxas_report(rec["ptxas"])
               for name, rec in cuda_build.build().items()}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = []
    for tag, b, h, hkv, s, d, causal, dt in cs.KERNEL_SHAPES:
        if tag not in shapes:
            continue
        dtype = getattr(torch, dt)
        mk = lambda *shape: torch.randn(shape, generator=gen, device=dev,
                                        dtype=torch.float32).to(dtype)
        q, k, v, do = (mk(b, h, s, d), mk(b, hkv, s, d), mk(b, hkv, s, d),
                       mk(b, h, s, d))
        o, lse = att.flash_attention_fwd(q, k, v, causal)
        dq, delta = att.flash_attention_bwd_dq(q, k, v, o, lse, do, causal)
        dk, dv = att.flash_attention_bwd_dkv(q, k, v, lse, delta, do,
                                             causal)
        errs = dict.fromkeys(cs.REPLACES)
        if checked:
            pdq, _ = att.flash_attention_bwd_dq_plain(q, k, v, o, lse, do,
                                                      causal)
            pdk, pdv = att.flash_attention_bwd_dkv_plain(q, k, v, lse,
                                                         delta, do, causal)
            po, _ = att.flash_attention_fwd_plain(q, k, v, causal)
            errs = {"flash_fwd": cs.check_close(att, "K1 O", o, po)[0],
                    "flash_bwd_dq": cs.check_close(att, "K2 dQ", dq, pdq)[0],
                    "flash_bwd_dkv": max(
                        cs.check_close(att, "K3 dK", dk, pdk)[0],
                        cs.check_close(att, "K3 dV", dv, pdv)[0])}
        got, _ = cs.time_kernels(torch, att, tag,
                                 (q, k, v, do, o, lse, delta),
                                 (b, h, hkv, s, d, causal, dt), errs, smi)
        for r in got.values():
            # this build's kernel at this shape (built per head dim)
            kind = "bf16" if dt == "bfloat16" else "f32"
            x = reports[r["name"]].get(f"{r['name']}_{kind}_kernel<{d}>")
            r["registers"] = x and x["registers"]
            r["spill_bytes"] = x and x["spill_stores"] + x["spill_loads"]
            rows.append(r)
    print("ROWS " + json.dumps({"root": root, "smi": smi, "rows": rows}),
          flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default="text",
                    help="comma-separated tags of chip_smoke.TIMED_SHAPES")
    ap.add_argument("--roots", default=HERE,
                    help="comma-separated checkouts, timed in turns")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--unchecked", action="store_true",
                    help="time without holding each kernel to its plain "
                         "version")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    opts = ap.parse_args()
    shapes = opts.shapes.split(",")
    timed = _chip_smoke().TIMED_SHAPES
    if not set(shapes) <= set(timed):
        ap.error(f"--shapes: chip_smoke.py times only {', '.join(timed)}")
    if opts.child is not None:
        return child(opts.child, shapes, not opts.unchecked)
    runs, failed = [], []
    for rnd in range(opts.rounds):
        for root in opts.roots.split(","):
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", root,
                 "--shapes", opts.shapes]
                + (["--unchecked"] if opts.unchecked else []),
                capture_output=True, text=True,
                timeout=900)
            sys.stdout.write("".join(
                line for line in out.stdout.splitlines(keepends=True)
                if not line.startswith("ROWS ")))
            if out.returncode != 0:
                sys.stderr.write(out.stderr[-4000:])
                failed.append(root)
                print(f"round {rnd} {root}: FAILED (exit "
                      f"{out.returncode})", flush=True)
                continue
            rec = json.loads(next(line[5:] for line in
                                  out.stdout.splitlines()
                                  if line.startswith("ROWS ")))
            rec["round"] = rnd
            runs.append(rec)
            for r in rec["rows"]:
                print(f"round {rnd} {root}: {r['name']} @{r['shape']} "
                      f"{r['ms']:.4f} ms device (eager {r['eager_ms']:.4f};"
                      f" {r['tflops']:.1f} TFLOP/s, "
                      f"{100 * r['bound_share']:.1f}% of bound "
                      f"{r['bound_ms']:.4f}), library "
                      f"{r['library_ms']:.4f} ms {r['library_method']} "
                      f"(eager {r['library_eager_ms']:.4f}), registers "
                      f"{r['registers']}, spill bytes {r['spill_bytes']} "
                      f"[{rec['smi']}]", flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "kernel_times.json"),
              "w") as f:
        json.dump(runs, f, indent=1)
    if failed:
        sys.exit(f"failed: {failed}")


if __name__ == "__main__":
    main()
