#!/usr/bin/env python3
"""Where a round of the PyTorch port's sp simulation spends its time on
the card: ``chip_smoke.py`` phase 5's configurations (a) ``lr`` at
``bench.py``'s shape and (b) the FEMNIST CNN, phase 8's text transformer
on the real text shard (``text_realtext``), phase 9's ``resnet18_gn``
on the CIFAR-100 stand-in (``resnet18_cifar100``) and phase 10's LSTMs
(``shakespeare_rnn``: the char-LSTM on Shakespeare; ``stackoverflow_nwp``:
Stack Overflow next-word prediction), for each algorithm of
``--federated-optimizer`` (default: each configuration's own, FedAvg
where it names none), each after one warm round (with
``--round_block K``: one warm block, where the CUDA graphs are captured),
then its host staging (cohort sampling and the index tensors, host clock;
a whole block's with ``--round_block``) and rounds under
``torch.profiler``.  Prints each round's wall time, the host's launch
calls (kernel and graph launches, copies, fills) and the device's kernels
a round, the device's busy and idle share, device time by kernel group,
for SCAFFOLD/FedDyn the device time of a round's client-table gather and
scatter (CUDA events; unfused rounds only), and the top kernels; writes
the same as JSON to ``chiprun_out/sp_profile.json``.

    python3 tools/torch_sp_profile.py [--rounds N]
        [--configs lr_bench,femnist_cnn,text_realtext,resnet18_cifar100,
                   shakespeare_rnn,stackoverflow_nwp]
        [--federated-optimizer FedAvg,...]
        [--round_block K] [--cohort_bucketing] [--population P]

``--round_block K`` profiles fused blocks (whole blocks: the rounds are
rounded up to a multiple of K), ``--cohort_bucketing`` bucketed rounds and
``--population P`` a population of P seeds (``population: P``).
"""

import argparse
import json
import os
import subprocess
import sys
import time

GROUPS = (("flash attention (K1-K3)", ("flash_",)),
          ("matmul (cuBLAS)", ("gemm", "cutlass", "sm90_xmma", "nvjet")),
          ("convolution (cuDNN)", ("conv", "cudnn", "implicit", "wgrad",
                                   "dgrad", "fprop")),
          ("pooling", ("pool",)),
          ("gather/index", ("index", "gather", "scatter")),
          ("elementwise/reduce", ("elementwise", "reduce", "vectorized",
                                  "unrolled", "softmax", "copy", "fill",
                                  "where", "cat")))


def stage_s(api, start, n, rb):
    """Host seconds a round to stage ``n`` rounds from ``start`` as the
    round loop would: whole blocks, bucketed clients' index batches, or the
    round's padded cohort arrays."""
    t0 = time.time()
    for r in range(start, start + n, rb):
        if rb > 1:
            api._stage_block(r)
        elif api._bucketing:
            for c in api._client_sampling(r):
                api.dataset.client_index_batches(
                    int(c), api.batch_size, api.seed, r, api.epochs)
        else:
            api._stage_round_arrays(r)
    return (time.time() - t0) / n


def advance(api, r, rb):
    """Run the round (or block) at ``r``; the rounds it ran."""
    if rb > 1:
        return api.train_block(r)[0]
    api.train_one_round(r)
    return 1


def profile(torch, api, rounds, rb):
    from chip_smoke import HOST_LAUNCH_CALLS
    warm = advance(api, 0, rb)   # a fused block captures its graphs here
    torch.cuda.synchronize()
    rec = {"staging_s": stage_s(api, warm, rounds, rb)}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.time()
        r = warm
        while r < warm + rounds:
            r += advance(api, r, rb)
        torch.cuda.synchronize()
        wall = (time.time() - t0) / rounds
    kernels, host = {}, 0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key] = {"us": dev_us / rounds,
                               "count": ev.count / rounds}
        elif ev.key.startswith(HOST_LAUNCH_CALLS):
            host += ev.count
    # busy: the union of the device's kernel intervals (the kernels of a
    # replayed CUDA graph may overlap, so their sum can exceed the wall)
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy = busy_us / 1e6 / rounds
    kernel_s = sum(k["us"] for k in kernels.values()) / 1e6
    groups = {name: 0.0 for name, _ in GROUPS}
    groups["other"] = 0.0
    for key, krec in kernels.items():
        low = key.lower()
        name = next((n for n, pats in GROUPS
                     if any(p in low for p in pats)), "other")
        groups[name] += krec["us"] / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1]["us"])[:12]
    rec.update({"wall_s": wall, "busy_s": busy, "kernel_s": kernel_s,
                "launches": sum(k["count"] for k in kernels.values()),
                "host_launches": host / rounds, "groups_s": groups,
                "top": [{"kernel": k, **v} for k, v in top]})
    if api.client_table is not None and rb == 1 and not api.population:
        # one round's table gather and scatter, alone, on its cohorts
        cohorts = [api._client_sampling(r) for r in range(1, rounds + 1)]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for c in cohorts:
            api._scatter_c(c, api._gather_c(c))
        end.record()
        end.synchronize()
        rec["table_gather_scatter_s"] = start.elapsed_time(end) / 1e3 / rounds
    return rec


def report(name, rec, rounds, smi):
    wall, busy = rec["wall_s"], rec["busy_s"]
    print(f"{name} [{smi}]: {wall:.4f} s a round (mean of "
          f"{rounds}), host staging {rec['staging_s']:.4f} s a round, "
          f"{rec['host_launches']:.0f} host launch calls and "
          f"{rec['launches']:.0f} device kernels a round; device busy "
          f"{busy:.4f} s ({100 * busy / wall:.1f}%), idle "
          f"{100 * (1 - busy / wall):.1f}%; kernel time summed "
          f"{rec['kernel_s']:.4f} s")
    if "table_gather_scatter_s" in rec:
        print(f"  client table gather + scatter "
              f"{1e3 * rec['table_gather_scatter_s']:.3f} ms a round")
    for g, sec in sorted(rec["groups_s"].items(), key=lambda kv: -kv[1]):
        print(f"  {g:24s} {1e3 * sec:9.3f} ms  {100 * sec / wall:5.1f}% "
              "of wall")
    for k in rec["top"]:
        print(f"  {k['us'] / 1e3:9.3f} ms  x{k['count']:<7.0f} "
              f"{k['kernel'][:90]}")



def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3,
                    help="profiled rounds per configuration")
    ap.add_argument("--configs", default="lr_bench,femnist_cnn",
                    help="comma-separated: lr_bench, femnist_cnn, "
                         "text_realtext, resnet18_cifar100, "
                         "shakespeare_rnn, stackoverflow_nwp")
    ap.add_argument("--federated-optimizer", default="",
                    help="comma-separated algorithms, each profiled on "
                         "each configuration (default: the "
                         "configuration's own)")
    ap.add_argument("--round_block", type=int, default=1,
                    help="rounds a fused block (CUDA graphs on the card)")
    ap.add_argument("--cohort_bucketing", action="store_true",
                    help="bucket each cohort by pow2 step class")
    ap.add_argument("--population", type=int, default=0,
                    help="a population of this many seeds")
    opts = ap.parse_args()
    rb = max(opts.round_block, 1)
    rounds = -(-opts.rounds // rb) * rb
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import fedml_tpu_torch
    from chip_smoke import (RESNET_CIFAR100, SP_FEMNIST_CNN, SP_LR_BENCH,
                            TEXT_REALTEXT, ZOO_SHAKESPEARE_RNN,
                            ZOO_STACKOVERFLOW_NWP, build_sp, sp_args)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    configs = {"lr_bench": SP_LR_BENCH, "femnist_cnn": SP_FEMNIST_CNN,
               "text_realtext": TEXT_REALTEXT,
               "resnet18_cifar100": RESNET_CIFAR100,
               "shakespeare_rnn": ZOO_SHAKESPEARE_RNN,
               "stackoverflow_nwp": ZOO_STACKOVERFLOW_NWP}
    mode = dict(round_block=rb, cohort_bucketing=opts.cohort_bucketing,
                population=opts.population)
    out = {"card": smi, "mode": mode}
    tag = "".join([f"/K{rb}" if rb > 1 else "",
                   "/bucketed" if opts.cohort_bucketing else "",
                   f"/P{opts.population}" if opts.population else ""])
    algs = [a for a in opts.federated_optimizer.split(",") if a] or [None]
    for alg in algs:
        for cname in opts.configs.split(","):
            cfg = dict(configs[cname], **mode, comm_round=rb + rounds)
            cfg["federated_optimizer"] = alg or cfg.get(
                "federated_optimizer", "FedAvg")
            name = f"{cname}/{cfg['federated_optimizer']}{tag}"
            api = build_sp(sp_args(fedml_tpu_torch, **cfg))
            rec = out[name] = profile(torch, api, rounds, rb)
            del api
            report(name, rec, rounds, smi)
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    fname = "sp_profile" + tag.replace("/", "_") + ".json"
    with open(os.path.join(root, "chiprun_out", fname), "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
