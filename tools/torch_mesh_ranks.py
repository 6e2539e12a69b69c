#!/usr/bin/env python3
"""The port's mesh engine on N ranks of one host, held against the sp
engine on rank 0: one rank per card over NCCL, or over gloo with
``--device cpu``.

    python3 -m torch.distributed.run --nproc_per_node 4 \\
        tools/torch_mesh_ranks.py [--device cpu] [--out chiprun_out/mesh4.json]

Each rank runs, through the port's public classes:

- ``MeshFedAvgAPI`` on ``tests/test_update_sharding.py``'s ``lr`` config
  (16 clients, 8 a round, 3 rounds) for FedAvg, FedOpt (server Adam at
  ``server_lr`` 0.03, as in the CPU parity tests), SCAFFOLD, FedDyn,
  FedNova and Mime under both merge layouts: params,
  losses, and the gathered server state against the sp engine's run on
  rank 0 (the JAX tests' limits, atol 2e-5 + rtol 1e-4: the merge sums in
  another order across ranks); and at collective_precision bf16 and int8
  (scatter and replicated, FedAvg and SCAFFOLD) the losses against the
  fp32 mesh run within the JAX package's own quantized limits (bf16 2e-3,
  int8 1e-2, ``tests/test_collective_precision.py``);
- ``round_block`` 2 on the mesh (SCAFFOLD, scatter) ≡ its unfused rounds
  (on the card: the merge's NCCL calls inside the CUDA graph);
- ``MeshHierarchicalAPI`` (one group a rank) against the sp
  hierarchical engine, and ``MeshDecentralizedAPI`` (ring gossip, ghost
  rows by send/recv) against the sp engine's dense ``W x``;
- ``FedLLMAPI(mesh=make_mesh())`` (tiny f32 Llama, a cohort that does not
  divide over the ranks) against the single-device round, to the LoRA
  parity limit 1e-4 (``tests/test_torch_fedllm.py``: Adam turns the
  merge's summation order into adapter differences proportional to lr;
  4 gloo ranks read 1.1e-6 after 2 rounds);
- FedAvg on the FEMNIST CNN at ``chip_smoke.py``'s widths (100 clients,
  10 a round) under both layouts, seconds a round beside the sp engine's
  on one card: the lr checks above time a host-bound round, this one a
  round whose clients fill the card.  Round 0's loss is held within
  ``CNN_LOSS_TOL`` to the sp engine's run at the mesh's client-map width
  (``client_mode="vmap:k"``, k = ceil(10 / N) clients a group, in the
  mesh's order): round 0's loss is the clients' own, before any merge,
  and the device's convolutions read differently at another batch width
  (10 against 3 a rank), which 30 local steps of ReLU and max-pool
  amplify.  The gap to the full-width sp run and the params are
  reported, not held; the merge's summation order moves the params too.
  As a control the sp engine also runs round 0 with its clients one
  after another (a client map of width 1) (``--cnn-only`` runs this
  section alone);
- the 2-D ``client × model`` mesh (``--mesh2d-only`` runs this section
  alone), on each factorization of the world into ``c × m`` with ``m`` in
  (2, 4): ``MeshFedAvgAPI`` with ``mesh_shape="c,m"`` on the ``lr``
  config for FedAvg, FedOpt, SCAFFOLD, FedDyn and Mime under both layouts
  against the sp engine (the lr checks' limits); ``FedLLMAPI(mesh=
  make_mesh2d("c,m"))`` at Llama-2-7B widths cut to 2 layers, f32 (TF32
  off), against the single-card API from the same weights: one batch's
  adapter gradients (summed over the model group) within 1e-4 relative
  and both rounds' losses within 1e-5, K1–K3 launched on each rank's
  heads; the adapters after 2 rounds, each rank's base bytes and the
  second round's seconds beside the single card's are reported (Adam's
  normalised step turns rounding-level gradient differences on near-zero
  entries into adapter differences of order lr); the same in bf16,
  reported; greedy decode over the tensor-parallel f32 model (2 layers)
  against ``generate`` on one card, token for token;
- the 3-D ``client × stage × model`` pipeline (``--mesh3d-only`` runs this
  section alone), at ``(1, 4, 1)`` and ``(1, 2, 2)``: ``MeshFedAvgAPI``
  with ``mesh_shape="c,s,m"`` on ``pipe_mlp`` at hidden ``--pipe-hidden``
  (4096) and depth ``--pipe-depth`` (64: 1.07 B params, f32),
  ``microbatches`` 4, FedAvg, 2 rounds, against the sp engine on one card
  from the same weights (losses within 1e-5 relative); seconds a round
  beside the sp engine's, the parameter bytes a rank holds and the
  modeled collective bytes a round by axis, and the measured bubble (one
  minus ``k`` ticks of this stage's work over a pipelined step, both
  timed on the card) beside ``(s-1)/(k+s-1)``; ``round_block`` 2 over 3
  rounds (a ragged tail) on both shapes (``pipe_mlp`` 256 wide, SCAFFOLD,
  scatter) against the unfused rounds, each round on the card a CUDA
  graph holding the stage ring's send/recv; and a probe: one NCCL ring
  shift over the stage group captured in a CUDA graph and replayed;
- ring attention over a ``seq`` group of the whole world (``--ring-only``
  runs this section alone): Llama-2-7B attention (B 1, H 32, D 128,
  causal, bf16) at S 4096, one layer, each rank its ``S/N`` shard: the
  output and dQ, dK, dV against one K1/K2/K3 call over S on one card
  (``KERNEL_TOL``), K1–K3 launched ``n (n + 1) / 2`` times across the
  ranks, the ring's forward+backward seconds beside the one call's;
- the teardown: every graph released, then ``core.mesh.shutdown_world``
  on every rank, which must return within ``--teardown-limit`` seconds.

``--teardown-check keep|release`` runs only ``round_block`` 2 on the mesh
(a CUDA graph that captured the merge's NCCL collectives) and the
teardown, with the block's graphs kept alive or released first: NCCL's
destroy waits for every graph that holds its communicator, so ``keep``
is expected to hang and is stopped at the limit (exit code 3).

Each check prints a line; rank 0 writes the numbers (seconds a round
beside the sp engine's included) to ``--out`` and exits non-zero if any
check failed.  The first line names the card and its power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

ALGS = ["FedAvg", "FedOpt", "SCAFFOLD", "FedDyn", "FedNova", "Mime"]
ATOL, RTOL = 2e-5, 1e-4
QUANT_LOSS_TOL = {"bf16": 2e-3, "int8": 1e-2}
#: round 0's loss on the FEMNIST CNN, mesh against sp: far below the
#: spread of two cohorts' losses, far above f32 noise
CNN_LOSS_TOL = 1e-3


def lr_cfg(**over):
    cfg = dict(dataset="synthetic", num_classes=10, input_shape=(28, 28, 1),
               train_size=1024, test_size=256, model="lr",
               client_num_in_total=16, client_num_per_round=8, comm_round=3,
               epochs=1, batch_size=16, learning_rate=0.1, random_seed=7,
               frequency_of_the_test=10 ** 9, partition_method="homo")
    cfg.update(over)
    if cfg.get("federated_optimizer") == "FedOpt":
        # server Adam's normalised step turns f32 summation-order noise
        # into steps of order server_lr (the CPU parity tests' setting)
        cfg.setdefault("server_lr", 0.03)
    return cfg


#: chip_smoke.py's SP_FEMNIST_CNN
FEMNIST_CNN = dict(dataset="femnist", model="cnn", client_num_in_total=100,
                   client_num_per_round=10, partition_method="hetero",
                   partition_alpha=0.5, batch_size=20, learning_rate=0.06,
                   comm_round=3, epochs=1, random_seed=0,
                   frequency_of_the_test=10 ** 9)


def teardown(rank, limit):
    """``shutdown_world`` on this rank, stopped with exit code 3 when it
    has not returned within ``limit`` seconds; returns its seconds."""
    from fedml_tpu_torch.core.mesh import shutdown_world

    def stuck():
        print(f"[rank {rank}] shutdown_world did not return within "
              f"{limit:.0f} s", flush=True)
        os._exit(3)

    timer = threading.Timer(limit, stuck)
    timer.daemon = True
    timer.start()
    t0 = time.time()
    shutdown_world()
    timer.cancel()
    return time.time() - t0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default="chiprun_out/mesh_ranks.json")
    ap.add_argument("--teardown-check", choices=("keep", "release"),
                    help="run only round_block on the mesh and the "
                         "teardown, the graphs kept or released first")
    ap.add_argument("--teardown-limit", type=float, default=60.0)
    ap.add_argument("--cnn-only", action="store_true",
                    help="run only the FEMNIST CNN section")
    ap.add_argument("--mesh2d-only", action="store_true",
                    help="run only the 2-D client x model section")
    ap.add_argument("--mesh3d-only", action="store_true",
                    help="run only the 3-D pipeline section")
    ap.add_argument("--ring-only", action="store_true",
                    help="run only the ring attention section")
    ap.add_argument("--pipe-hidden", type=int, default=4096)
    ap.add_argument("--pipe-depth", type=int, default=64)
    ap.add_argument("--ring-seq", type=int, default=4096,
                    help="the ring section's sequence length (4096: "
                         "Llama-2-7B attention; smaller over gloo)")
    ap.add_argument("--llm-width", default="7b", choices=("7b", "tiny"),
                    help="the 2-D section's LLM: Llama-2-7B widths, or the "
                         "tiny config (a quick check over gloo on the CPU)")
    opts = ap.parse_args()

    import numpy as np
    import torch
    import torch.distributed as dist
    import fedml_tpu_torch
    from fedml_tpu_torch import data, device as device_mod, model
    from fedml_tpu_torch.core.mesh import make_mesh
    from fedml_tpu_torch.llm.fedllm import FedLLMAPI
    from fedml_tpu_torch.simulation.mesh.decentralized_mesh import \
        MeshDecentralizedAPI
    from fedml_tpu_torch.simulation.mesh.engine import MeshFedAvgAPI
    from fedml_tpu_torch.simulation.mesh.hierarchical_mesh import \
        MeshHierarchicalAPI
    from fedml_tpu_torch.simulation.sp.decentralized import \
        DecentralizedFedAPI
    from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI
    from fedml_tpu_torch.simulation.sp.hierarchical_fl import \
        HierarchicalFedAvgAPI

    dev = device_mod.get_device(None, opts.device)
    mesh = make_mesh(device=dev)
    rank, world = mesh.rank, mesh.size
    if opts.device == "cuda" and world > torch.cuda.device_count():
        raise SystemExit(f"{world} ranks and {torch.cuda.device_count()} "
                         "cards: one card a rank")
    smi = "cpu"
    if opts.device == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[rank]
    out = {"world": world, "backend": str(dist.get_backend()),
           "card": smi, "checks": {}}
    bad = []

    def say(msg):
        if rank == 0:
            print(f"[mesh{world}] {msg}", flush=True)

    def build(cls, cfg, **kw):
        args = fedml_tpu_torch.load_arguments().update(**cfg)
        ds, od = data.load(args)
        return cls(args, dev, ds, model.create(args, od), **kw)

    def sync():
        if opts.device == "cuda":
            torch.cuda.synchronize()

    def rounds(api, n):
        losses, secs = [], []
        for r in range(n):
            if opts.device == "cuda":
                torch.cuda.synchronize()
            t0 = time.time()
            losses.append(float(api.train_one_round(r)["train_loss"]))
            if opts.device == "cuda":
                torch.cuda.synchronize()
            secs.append(time.time() - t0)
        return losses, secs

    def err(a, b):
        """(max |a - b|, whether every element is within ATOL + RTOL·|b|)
        over the leaves of ``b``."""
        d = {k: torch.abs(a[k].cpu() - b[k].cpu()) for k in b}
        return (max(float(v.max()) for v in d.values()),
                all(bool((v <= ATOL + RTOL * torch.abs(b[k].cpu())).all())
                    for k, v in d.items()))

    def check(name, value, ok, extra=None):
        out["checks"][name] = dict(extra or {}, value=value, ok=bool(ok))
        say(f"{name}: {value:.3e} {'ok' if ok else 'FAILED'} [{smi}]")
        if not ok:
            bad.append(name)

    def finish():
        """Write the results, tear the group down, exit 1 on a failed
        check."""
        out["ok"] = not bad
        if rank == 0:
            os.makedirs(os.path.dirname(opts.out) or ".", exist_ok=True)
            with open(opts.out, "w") as fh:
                json.dump(out, fh, indent=1)
        out["teardown_s"] = teardown(rank, opts.teardown_limit)
        say(f"shutdown_world returned in {out['teardown_s']:.2f} s")
        if rank == 0:
            with open(opts.out, "w") as fh:
                json.dump(out, fh, indent=1)
            print(json.dumps({"ok": out["ok"], "failed": bad}), flush=True)
        if bad:
            sys.exit(1)

    def femnist_cnn():
        """FedAvg on the FEMNIST CNN: seconds a round where the clients
        fill the card, and round 0's loss against the sp engine run at
        the mesh's client-map width."""
        args = fedml_tpu_torch.load_arguments().update(**FEMNIST_CNN)
        ds, od = data.load(args)
        cnn = model.create(args, od)
        sp = FedAvgAPI(args, dev, ds, cnn)
        sp_losses, sp_secs = rounds(sp, 3)
        # the mesh pads the cohort to a multiple of the ranks and runs
        # ceil(C / world) clients a rank: the sp engine at that width, in
        # the same order, is the like-for-like reference of round 0
        width = -(-int(FEMNIST_CNN["client_num_per_round"]) // world)
        wide = FedAvgAPI(args, dev, ds, cnn, client_mode=f"vmap:{width}")
        wide_loss0 = float(wide.train_one_round(0)["train_loss"])
        del wide
        # control: the sp engine with its clients one after another (a
        # client map of width 1): what the width alone does to round 0's
        # loss on this device
        scan = FedAvgAPI(args, dev, ds, cnn, client_mode="scan")
        width_gap = abs(float(scan.train_one_round(0)["train_loss"])
                        - sp_losses[0])
        say(f"FEMNIST CNN round 0 loss, sp clients one by one vs vmapped: "
            f"{width_gap:.3e} (control) [{smi}]")
        out["checks"]["femnist_width_control"] = {"value": width_gap}
        say(f"FEMNIST CNN round 0 loss, sp at width {width} vs width "
            f"{FEMNIST_CNN['client_num_per_round']}: "
            f"{abs(wide_loss0 - sp_losses[0]):.3e} [{smi}]")
        out["checks"]["femnist_width_matched_sp"] = {
            "value": abs(wide_loss0 - sp_losses[0]), "width": width,
            "loss0": wide_loss0}
        del scan
        for lay in ("replicated", "scatter"):
            api = MeshFedAvgAPI(fedml_tpu_torch.load_arguments().update(
                update_sharding=lay, **FEMNIST_CNN), dev, ds, cnn)
            losses, secs = rounds(api, 3)
            api._stager.close()
            le = abs(losses[0] - wide_loss0)
            full = abs(losses[0] - sp_losses[0])
            pe = err(api.state.global_params, sp.state.global_params)[0]
            finite = all(np.isfinite(losses))
            check(f"FEMNIST CNN FedAvg/{lay}: round 0 loss vs sp at width "
                  f"{width}", le, le <= CNN_LOSS_TOL and finite,
                  {"losses": losses, "sp_losses": sp_losses,
                   "loss0_vs_full_width_sp": full,
                   "params_vs_sp_after_3_rounds": pe,
                   "s_per_round": secs[1:], "sp_s_per_round": sp_secs[1:]})
            say(f"FEMNIST CNN FedAvg/{lay}: round 0 loss vs the full-width "
                f"sp {full:.3e} (reported); {secs[1]:.4f} {secs[2]:.4f} s a "
                f"round, sp alone {sp_secs[1]:.4f} {sp_secs[2]:.4f}; "
                f"params vs sp after 3 rounds {pe:.2e} (reported) [{smi}]")
            del api
        del sp

    def mesh2d():
        """The 2-D client x model mesh: the sim engine, the
        tensor-parallel LoRA round and decode at Llama-2-7B widths."""
        import dataclasses
        from fedml_tpu_torch.core.mesh import make_mesh2d
        from fedml_tpu_torch.llm.configurations import \
            llama2_7b_round_arguments
        from fedml_tpu_torch.llm.model import LLAMA2_7B, LlamaLM
        from fedml_tpu_torch.ops import attention as att
        from fedml_tpu_torch.serving.templates.openai_compat import \
            generate
        shapes = [f"{world // m},{m}" for m in (2, 4) if world % m == 0]
        for shape in shapes:
            for alg in ("FedAvg", "FedOpt", "SCAFFOLD", "FedDyn", "Mime"):
                cfg = lr_cfg(federated_optimizer=alg)
                sp = build(FedAvgAPI, cfg)
                sp_losses, _ = rounds(sp, 3)
                for lay in ("replicated", "scatter"):
                    api = build(MeshFedAvgAPI, dict(
                        cfg, update_sharding=lay, mesh_shape=shape))
                    losses, secs = rounds(api, 3)
                    api._stager.close()
                    e, ok = err(api.full_params(), sp.state.global_params)
                    le = float(np.max(np.abs(np.subtract(losses,
                                                         sp_losses))))
                    check(f"2-D {shape} {alg}/{lay} vs sp", max(e, le),
                          ok and le <= ATOL, {"s_per_round": secs[1:]})
            mesh2 = make_mesh2d(shape, device=dev)
            m = mesh2.shape["model"]
            for dtype in ("float32", "bfloat16"):
                args = llama2_7b_round_arguments(2).update(
                    comm_round=2, model_dtype=dtype)
                if opts.llm_width == "tiny":
                    args.update(model="tiny_llama", seq_len=32,
                                llm_n_kv_heads=4, train_size=32)
                ds, _ = data.load(args)
                xb, yb, _ = ds.test_batches(batch_size=2)
                runs = {}
                for name, msh in (("single", None), ("tp", mesh2)):
                    api = FedLLMAPI(args, ds, device=dev, mesh=msh)
                    held = sum(p.numel() * p.element_size()
                               for p in api.model.parameters())
                    # one batch's adapter gradients at adapters off zero
                    # (B = 0 zeroes A's gradient): on a mesh each rank's
                    # part, summed over the model group as the round does
                    g = torch.Generator(device=dev)
                    g.manual_seed(5)
                    lora = {k: (v + 0.01 * torch.randn(
                        v.shape, generator=g, device=dev)).requires_grad_()
                        for k, v in api.global_lora.items()}
                    x = torch.as_tensor(xb[0], device=dev)
                    y = torch.as_tensor(yb[0], device=dev)
                    grads = torch.autograd.grad(api.loss(lora, x, y),
                                                list(lora.values()))
                    if msh is not None:
                        grads = msh.psum_many(list(grads), axis="model")
                    grads = dict(zip(lora, (t.cpu() for t in grads)))
                    att.reset_launch_counts()
                    warm = api.train_one_round(0)["train_loss"]
                    sync()
                    t0 = time.time()
                    loss = api.train_one_round(1)["train_loss"]
                    sync()
                    runs[name] = dict(
                        losses=[warm, loss], seconds=time.time() - t0,
                        held=held, grads=grads,
                        lora={k: v.cpu() for k, v in api.global_lora.items()},
                        launches={f.__name__: f.launches
                                  for f in att.KERNELS})
                    del api
                    if opts.device == "cuda":
                        torch.cuda.empty_cache()
                one, tp = runs["single"], runs["tp"]
                e = err(tp["lora"], one["lora"])[0]
                grad_rel = max(float((tp["grads"][k] - v).abs().max())
                               / max(float(v.abs().max()), 1e-30)
                               for k, v in one["grads"].items())
                loss_gap = max(abs(a - b) for a, b in zip(tp["losses"],
                                                          one["losses"]))
                rec = {"losses": tp["losses"], "single_losses": one["losses"],
                       "grad_max_rel_err": grad_rel,
                       "adapters_max_abs_err": e,
                       "s_per_round": tp["seconds"],
                       "single_s_per_round": one["seconds"],
                       "base_bytes": tp["held"],
                       "single_base_bytes": one["held"],
                       "launches": tp["launches"]}
                # on the CPU the attention runs the kernels' plain versions
                launched = all(tp["launches"].values()) or \
                    opts.device == "cpu"
                name = f"TP {shape} FedLLMAPI Llama-2-7B widths 2 layers " \
                    f"{dtype}"
                if dtype == "float32":
                    # the gradients and losses are held; Adam's normalised
                    # step turns rounding-level gradient differences on
                    # near-zero entries into adapter differences of order
                    # lr, so the adapters are reported
                    check(f"{name}: one batch's adapter gradients vs one "
                          "card (max relative)", grad_rel,
                          grad_rel <= 1e-4 and loss_gap <= 1e-5 and launched,
                          rec)
                else:
                    out["checks"][name] = dict(rec, value=grad_rel,
                                               reported=True)
                    if not (launched and all(np.isfinite(tp["losses"]))):
                        bad.append(name)
                say(f"{name}: losses {tp['losses']} vs {one['losses']} on "
                    f"one card; gradients {grad_rel:.2e} relative, adapters "
                    f"after 2 rounds {e:.2e} (reported); round 1 "
                    f"{tp['seconds']:.3f} s vs {one['seconds']:.3f} on one "
                    f"card; base {tp['held'] / 2**30:.2f} GiB a rank vs "
                    f"{one['held'] / 2**30:.2f}; K1-K3 {tp['launches']} "
                    f"[{smi}]")
            cfg = dataclasses.replace(LLAMA2_7B, n_layers=2, max_seq_len=256,
                                      dtype=torch.float32,
                                      attn_impl="blockwise")
            if opts.llm_width == "tiny":
                cfg = dataclasses.replace(cfg, dim=64, n_heads=4,
                                          n_kv_heads=4, ffn_dim=128,
                                          vocab_size=256)
            toks = {}
            for name, msh in (("single", None), ("tp", mesh2)):
                with torch.device("meta"):
                    lm = LlamaLM(cfg, mesh=msh)
                lm = lm.to_empty(device=dev)
                g = torch.Generator(device=dev)
                g.manual_seed(0)
                lm.init_weights(g)
                toks[name] = generate(None, None, list(range(3, 40)),
                                      max_new_tokens=16, buf_len=256,
                                      model=lm)
                del lm
            same = toks["tp"] == toks["single"]
            check(f"TP {shape} greedy decode (f32, 2 layers, model factor "
                  f"{m}) vs one card", 0.0 if same else 1.0, same,
                  {"tokens": toks["tp"]})

    def mesh3d():
        """The 3-D pipeline: the sim engine on pipe_mlp against the sp
        engine on one card, the bubble, and the NCCL capture probe."""
        from fedml_tpu_torch.core.mesh import STAGE_AXIS, make_mesh2d
        cfg = dict(dataset="synthetic", num_classes=10,
                   input_shape=(28, 28, 1), train_size=512, test_size=64,
                   model="pipe_mlp", model_dim=opts.pipe_hidden,
                   model_layers=opts.pipe_depth, client_num_in_total=8,
                   client_num_per_round=2, comm_round=2, epochs=1,
                   batch_size=16, learning_rate=0.05, random_seed=7,
                   partition_method="homo", frequency_of_the_test=10 ** 9)
        micro = 4
        sp = build(FedAvgAPI, cfg)
        init = {k: v.clone() for k, v in sp.state.global_params.items()}
        n_params = sum(v.numel() for v in init.values())
        sp_losses, sp_secs = rounds(sp, 2)
        sp_params = {k: v.cpu() for k, v in sp.state.global_params.items()}
        del sp
        if opts.device == "cuda":
            torch.cuda.empty_cache()
        for shape in ((1, world, 1), (1, world // 2, 2)):
            c, s, m = shape
            api = build(MeshFedAvgAPI, dict(
                cfg, mesh_shape=",".join(map(str, shape)),
                microbatches=micro))
            api.reset_params(init)
            losses, secs = rounds(api, 2)
            api._stager.close()
            rel = max(abs(a - b) / abs(b) for a, b in zip(losses, sp_losses))
            held = sum(v.numel() * v.element_size()
                       for v in api.state.global_params.values())
            pe = err(api.full_params(), sp_params)[0]
            # the bubble: a pipelined step against k ticks of this
            # stage's own work (its layers, forward and backward, on one
            # microbatch)
            tr = api.trainer
            x = torch.randn((cfg["batch_size"], 28, 28, 1), device=dev)
            y = torch.randint(0, 10, (cfg["batch_size"],), device=dev)
            params = api.state.global_params
            t_step = timed(lambda: tr.grad_and_loss(params, x, y), 3)
            h = torch.randn((cfg["batch_size"] // micro, opts.pipe_hidden),
                            device=dev)
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in params.items() if k in tr.staged}

            def tick():
                out_ = tr.pipe.blocks(leaves, h, tr.tp_mesh)
                torch.autograd.grad(out_.sum(), list(leaves.values()))

            t_tick = timed(tick, 3)
            bubble = 1.0 - micro * t_tick / t_step
            ideal = (s - 1) / (micro + s - 1)
            check(f"pipeline {shape} pipe_mlp {n_params / 1e9:.2f} B params "
                  f"vs one card: losses relative", rel, rel <= 1e-5,
                  {"losses": losses, "sp_losses": sp_losses,
                   "params_err": pe, "s_per_round": secs,
                   "sp_s_per_round": sp_secs, "param_bytes_a_rank": held,
                   "bytes": api.collective_bytes(), "n_params": n_params,
                   "t_step_s": t_step, "t_tick_s": t_tick,
                   "bubble_measured": bubble, "bubble_ideal": ideal})
            say(f"pipeline {shape}: {secs[1]:.3f} s a round vs one card "
                f"{sp_secs[1]:.3f}; {held / 2**30:.2f} GiB of params a "
                f"rank; bytes a round {api.collective_bytes()}; bubble "
                f"{bubble:.3f} measured vs (s-1)/(k+s-1) = {ideal:.3f} "
                f"(step {t_step * 1e3:.1f} ms, tick {t_tick * 1e3:.2f} ms); "
                f"params vs one card {pe:.2e} [{smi}]")
            del api, params, leaves
            if opts.device == "cuda":
                torch.cuda.empty_cache()
        # round_block on the pipeline layout: on the card each round a
        # CUDA graph holding the stage ring's send/recv
        small = dict(cfg, model_dim=256, model_layers=2 * world,
                     comm_round=3, federated_optimizer="SCAFFOLD",
                     update_sharding="scatter", microbatches=micro)
        for shape in ((1, world, 1), (1, world // 2, 2)):
            sh = ",".join(map(str, shape))
            u = build(MeshFedAvgAPI, dict(small, mesh_shape=sh))
            rounds(u, 3)
            f = build(MeshFedAvgAPI, dict(small, mesh_shape=sh,
                                          round_block=2))
            f._train_fused()
            u._stager.close()
            f._stager.close()
            us, fs = u.full_state(), f.full_state()
            e = max(err(fs.global_params, us.global_params)[0],
                    float(torch.max(torch.abs(fs.c_server - us.c_server))))
            graphs = f._block_fn.captures if opts.device == "cuda" else 0
            check(f"round_block 2 over 3 rounds vs unfused, pipeline "
                  f"{shape} (SCAFFOLD, scatter)", e, e <= 1e-6,
                  {"graphs_captured": graphs})
            f._block_fn.release()
            del u, f, us, fs
        # can one NCCL ring shift be captured in a CUDA graph?
        if opts.device == "cuda":
            pm = make_mesh2d(f"1,{world},1", device=dev)
            src = torch.full((1024,), float(rank), device=dev)
            pm.ppermute(src, STAGE_AXIS)
            torch.cuda.synchronize()
            note = "ok"
            try:
                g = torch.cuda.CUDAGraph()
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.graph(g, stream=side):
                    got = pm.ppermute(src, STAGE_AXIS)
                g.replay()
                torch.cuda.synchronize()
                want = float((rank - 1) % world)
                captured = bool((got == want).all())
                del g
            except Exception as e:   # the probe's outcome is its result
                captured, note = False, f"{type(e).__name__}: {e}"[:200]
            torch.cuda.synchronize()
            out["checks"]["nccl_p2p_graph_capture"] = {
                "value": float(captured), "note": note}
            say(f"NCCL ring shift captured in a CUDA graph and replayed: "
                f"{captured} ({note}) [{smi}]")

    def ring_section():
        """Ring attention over a seq group of the whole world against one
        card's single K1-K3 call."""
        from fedml_tpu_torch.ops import attention as att
        from fedml_tpu_torch.ops.ring_attention import ring_attention
        rm = make_mesh(client=1, seq=world, device=dev)
        b, h, d, s_len = 1, 32, 128, opts.ring_seq
        dt = torch.bfloat16 if opts.device == "cuda" else torch.float32
        g = torch.Generator(device=dev)
        g.manual_seed(4096)
        mk = lambda: torch.randn((b, h, s_len, d), generator=g, device=dev,
                                 dtype=torch.float32).to(dt)
        q, k, v, do = mk(), mk(), mk(), mk()
        part = slice(rank * s_len // world, (rank + 1) * s_len // world)
        sh = [t[:, :, part].contiguous() for t in (q, k, v, do)]
        leaves = [t.clone().requires_grad_(True) for t in sh[:3]]
        att.reset_launch_counts()
        o = ring_attention(*leaves, rm)
        grads = torch.autograd.grad(o, leaves, sh[3])
        sync()
        mine = {f.__name__: f.launches for f in att.KERNELS}
        total = rm.psum(torch.tensor([float(n) for n in mine.values()],
                                     device=dev))
        so, slse = att.flash_attention_fwd(q, k, v, True)
        sdq, sdelta = att.flash_attention_bwd_dq(q, k, v, so, slse, do, True)
        sdk, sdv = att.flash_attention_bwd_dkv(q, k, v, slse, sdelta, do,
                                               True)
        worst = 0.0
        for name, got, ref in (("O", o, so), ("dQ", grads[0], sdq),
                               ("dK", grads[1], sdk), ("dV", grads[2], sdv)):
            st = att.compare_with_plain(got, ref[:, :, part].contiguous())
            worst = max(worst, st["elem"], st["block"])
            say(f"ring {name} vs one call: err {st['err']:.2e}, worst "
                f"element {st['elem']:.2f} and block {st['block']:.2f} of "
                f"their limits (rank 0's shard) [{smi}]")
        worst_all = float(torch.max(rm.all_gather(torch.tensor(
            [worst], device=dev))))
        steps = world * (world + 1) // 2

        def ring_fb():
            ls = [t.clone().requires_grad_(True) for t in sh[:3]]
            torch.autograd.grad(ring_attention(*ls, rm), ls, sh[3])

        def one_fb():
            o_, l_ = att.flash_attention_fwd(q, k, v, True)
            _, d_ = att.flash_attention_bwd_dq(q, k, v, o_, l_, do, True)
            att.flash_attention_bwd_dkv(q, k, v, l_, d_, do, True)

        t_ring = timed(ring_fb, 5)
        t_one = timed(one_fb, 5)
        counts = dict(zip(mine, [int(x) for x in total.tolist()]))
        ok = worst_all <= 1 and all(n == steps for n in counts.values()) \
            if opts.device == "cuda" else worst_all <= 1
        check(f"ring attention seq {world}, B{b} H{h} S{s_len} D{d} causal "
              f"{str(dt)[6:]} vs one call (worst share of KERNEL_TOL)",
              worst_all, ok, {"launches": counts, "ring_s": t_ring,
                              "one_call_s": t_one})
        say(f"ring: launches across ranks {counts} (want {steps} each on "
            f"the card); forward+backward {t_ring * 1e3:.2f} ms on "
            f"{world} cards vs one call {t_one * 1e3:.2f} ms [{smi}]")

    def timed(fn, reps):
        """Seconds a call of ``fn`` (one warm call, then ``reps``)."""
        fn()
        sync()
        t0 = time.time()
        for _ in range(reps):
            fn()
        sync()
        return (time.time() - t0) / reps

    if opts.mesh3d_only or opts.ring_only:
        if opts.mesh3d_only:
            mesh3d()
        if opts.ring_only:
            ring_section()
        finish()
        return

    if opts.mesh2d_only:
        mesh2d()
        finish()
        return

    if opts.teardown_check:
        api = build(MeshFedAvgAPI, lr_cfg(
            federated_optimizer="SCAFFOLD", update_sharding="scatter",
            comm_round=2, round_block=2))
        api._train_fused()
        api._stager.close()
        captured = api._block_fn.captures
        if opts.teardown_check == "release":
            api._block_fn.release()
        say(f"round_block 2: {captured} graph(s) captured, "
            f"{opts.teardown_check} them; tearing down [{smi}]")
        secs = teardown(rank, opts.teardown_limit)
        say(f"shutdown_world returned in {secs:.2f} s")
        if rank == 0:
            print(json.dumps({"ok": True, "teardown_check":
                              opts.teardown_check, "graphs": captured,
                              "teardown_s": secs}), flush=True)
        return

    if opts.cnn_only:
        femnist_cnn()
        finish()
        return

    # the FedAvg family against the sp engine on rank 0
    for alg in ALGS:
        cfg = lr_cfg(federated_optimizer=alg)
        sp = build(FedAvgAPI, cfg)
        sp_losses, sp_secs = rounds(sp, 3)
        for lay in ("replicated", "scatter"):
            api = build(MeshFedAvgAPI, dict(cfg, update_sharding=lay))
            losses, secs = rounds(api, 3)
            api._stager.close()
            e, ok = err(api.state.global_params, sp.state.global_params)
            le = float(np.max(np.abs(np.subtract(losses, sp_losses))))
            check(f"{alg}/{lay} vs sp", max(e, le), ok and le <= ATOL,
                  {"s_per_round": secs[1:], "sp_s_per_round": sp_secs[1:]})
    # quantized collectives against the fp32 mesh
    for alg in ("FedAvg", "SCAFFOLD"):
        for lay in ("replicated", "scatter"):
            ref = None
            for prec in ("fp32", "bf16", "int8"):
                api = build(MeshFedAvgAPI, lr_cfg(
                    federated_optimizer=alg, update_sharding=lay,
                    collective_precision=prec, comm_round=4))
                losses, secs = rounds(api, 4)
                api._stager.close()
                if prec == "fp32":
                    ref = losses
                    continue
                e = float(np.max(np.abs(np.subtract(losses, ref))))
                check(f"{alg}/{lay}/{prec} losses vs fp32", e,
                      e <= QUANT_LOSS_TOL[prec], {"s_per_round": secs[1:]})
    # round_block on the mesh
    cfg = lr_cfg(federated_optimizer="SCAFFOLD", update_sharding="scatter",
                 comm_round=4)
    u = build(MeshFedAvgAPI, cfg)
    rounds(u, 4)
    f = build(MeshFedAvgAPI, dict(cfg, round_block=2))
    f._train_fused()
    u._stager.close()
    f._stager.close()
    us, fs = u.full_state(), f.full_state()
    e = max(err(fs.global_params, us.global_params)[0],
            float(torch.max(torch.abs(fs.c_server - us.c_server))))
    check("round_block 2 vs unfused (SCAFFOLD, scatter)", e, e <= 1e-6,
          {"graphs_captured": f._block_fn.captures})
    f._block_fn.release()
    del u, f, us, fs
    # the hierarchical mesh: one group a rank
    hcfg = dict(dataset="synthetic", num_classes=4, input_shape=(10,),
                train_size=640, test_size=96, model="lr",
                client_num_in_total=16, client_num_per_round=12,
                comm_round=3, epochs=1, batch_size=8, learning_rate=0.2,
                group_num=world, group_comm_round=2, random_seed=7,
                frequency_of_the_test=100)
    sp = build(HierarchicalFedAvgAPI, hcfg)
    rounds(sp, 3)
    api = build(MeshHierarchicalAPI, hcfg)
    rounds(api, 3)
    check("hierarchical vs sp",
          *err(api.state.global_params, sp.state.global_params))
    # the ring gossip against the dense W x
    rcfg = dict(hcfg, client_num_in_total=2 * world, comm_round=3,
                topology="symmetric", topology_neighbors=2,
                federated_optimizer="dsgd")
    if 2 * world >= 3:
        sp = build(DecentralizedFedAPI, rcfg)
        rounds(sp, 3)
        api = build(MeshDecentralizedAPI, rcfg)
        rounds(api, 3)
        check("ring gossip vs dense W x", *err(api.full_params(),
                                                sp.params))
    # FedLLMAPI over the client axis, a cohort that does not divide
    lcfg = dict(model="tiny_llama", dataset="shakespeare", seq_len=32,
                client_num_in_total=8, client_num_per_round=world + 1,
                comm_round=2, batch_size=2, learning_rate=1e-3,
                random_seed=9, llm_max_local_steps=2, lora_rank=4,
                partition_method="homo", train_size=64, test_size=4)
    args = fedml_tpu_torch.load_arguments().update(**lcfg)
    ds, _ = data.load(args)
    one = FedLLMAPI(args, ds, device=dev)
    many = FedLLMAPI(args, ds, device=dev, mesh=mesh)
    many.global_lora = {k: v.clone() for k, v in one.global_lora.items()}
    for r in range(2):
        one.train_one_round(r)
        many.train_one_round(r)
    e = err(many.global_lora, one.global_lora)[0]
    check("FedLLMAPI(mesh) vs single device", e, e <= 1e-4)
    del one, many

    femnist_cnn()
    mesh2d()
    mesh3d()
    ring_section()

    finish()


if __name__ == "__main__":
    main()
