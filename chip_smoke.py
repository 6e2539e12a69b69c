#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``fedml_tpu_torch``) starts
and is right on one NVIDIA Hopper card.

    python3 chip_smoke.py [--layers N]

Phases, each printing its own lines:

1. device — ``nvidia-smi`` name and power limit, ``torch.cuda`` name;
2. build — the three flash-attention kernels compiled from ``csrc/`` (one
   ``nvcc`` per source, in parallel), with each kernel's registers, spill
   bytes and shared memory per block from ``-Xptxas -v`` (kept beside each
   library, so a cached build reports it too; a K1, K2 or K3 build, bf16
   (``wgmma``) or f32 (3xTF32 ``mma.sync``), that spills or has no report
   at one of the head dims 16, 32, ..., 128 fails);
3. kernels — K1 (forward), K2 (dQ) and K3 (dK/dV), each against its plain
   PyTorch version on the same inputs, and the autograd Function bitwise
   equal to them, at the slice's shape, a ragged GQA shape, a head dim the
   bf16 kernels pad (80) and a small f32 shape, each output held per element and per 64-row block to
   ``attention.KERNEL_TOL``; each kernel's device time (20 calls replayed
   as one CUDA graph) beside its eager time (20 calls from Python), the
   plain version, one library call as a yardstick by both readings
   (``scaled_dot_product_attention`` for K1, PyTorch's attention backward
   for K2 and K3 together; graph replay, or the profiler where the call
   cannot be captured), and the least time the card could take, with the
   achieved TFLOP/s and the share of that bound at the device time;
4. slice — ``build_fedllm`` → ``FedLLMAPI.train()`` + ``evaluate()`` at
   Llama-2-7B width (dim 4096, 32 heads, ffn 11008, bf16, LoRA rank 8 on
   wq/wk/wv/wo) on the synthetic Shakespeare LM data at seq 1024, 4 clients
   per round, batch 2, 2 local steps, random weights from seed 0; checks
   finite losses, a bitwise-unchanged base, moved adapters and each
   kernel's launch count; then a small f32 model trained on the card and
   on the CPU from the same weights must agree;
5. sp — the single-process FedAvg simulation (``FedAvgAPI``, built as a
   user script builds it: ``device.get_device``, ``data.load``,
   ``model.create``, ``FedMLRunner``, or through ``run_simulation``):
   (a) ``lr`` at ``bench.py``'s FedAvg shape (synthetic 28×28×1, 10
   classes, 60,000 samples over 1,000 clients, 256 a round, batch 10, 6
   steps each), one warm round then 10 timed; (b) the FEMNIST CNN
   (``CNNDropOut``, 62 classes) on the synthetic FEMNIST stand-in at its
   reference cardinality (60,000 / 10,000), 100 clients, Dirichlet α 0.5,
   10 a round, batch 20, one warm round then 2 timed; (c) the CNN on the
   committed real 8×8 digits (``data_shards/digits``, a round-robin split
   into 15 users) through ``run_simulation`` for 8 rounds, test accuracy
   above 0.6; (d) small f32 ``lr`` and ``cnn_web`` rounds on the card and
   the CPU from the same weights, TF32 off as ``get_device`` sets it
   (checked), params within 1e-6, with the reading a TF32 run would give
   printed beside them.  The sp path launches none of the
   flash-attention kernels (checked);
6. zoo — the algorithm zoo on the sp frame: (a) ``fedavg`` (the
   baseline), ``fedprox``, ``fedopt`` (server Adam at server_lr 0.01),
   ``scaffold``, ``feddyn``, ``fednova``, ``mime``, ``fedsgd`` and
   ``qfedavg``, each through ``build_sp`` on phase 5(b)'s FEMNIST CNN
   configuration, one warm round then 2 timed, with its round time beside
   FedAvg's of the same phase; each algorithm's own state
   (FedOpt's moments, SCAFFOLD's c_server, FedDyn's h, Mime's momentum)
   non-zero, and for SCAFFOLD and FedDyn exactly the sampled clients' rows
   of the per-client table written; (b) every algorithm (and FedOpt with
   server SGD) on 5(d)'s small ``lr`` rounds, and SCAFFOLD, FedDyn and
   FedNova on ``cnn_web``, card vs CPU from the same weights, TF32 off:
   params, server state and table rows within 1e-6; (c) the hierarchical
   (3 groups, 2 inner rounds), async and decentralized (symmetric and
   asymmetric, 2 neighbours) engines through ``run_simulation`` on the
   FEMNIST CNN configuration for 2 rounds: finite test loss, every
   parameter moved off the seed's initial weights.  The zoo launches none
   of the flash-attention kernels (checked).
7. fusion — the sp round program's options, under the device policy (TF32
   off, deterministic cuDNN, checked): (a) ``lr`` at ``bench.py --fused``'s
   shape (256 clients a round) and (b) the FEMNIST CNN (FedAvg, and
   SCAFFOLD with its table inside the graph), each unfused and in blocks
   of 8 (``round_block``: one CUDA graph per step class, captured in a
   warm block, replayed a round), timed after the warm block, fused ≡
   unfused to 1e-6 (per-round losses, params, state, table rows), a graph
   captured, host launch calls and device kernels a round counted under
   ``torch.profiler``; (c) cohort bucketing on the FEMNIST CNN at α 0.3
   beside the unbucketed rounds (the same real steps over fewer allocated
   ones) and on ``tests/test_e2e_sp.py``'s own split (eval within 2e-4); (d) a population of 4 client learning rates on the
   FEMNIST CNN, unfused and in blocks of 4 (fused ≡ unfused to 1e-6),
   seconds a member beside the single run, member 0 ≡ the single run on
   ``cnn_web`` to 1e-6 (reported on FEMNIST); (e) the same 4 FEMNIST
   rounds twice with cuDNN free to pick its algorithms (reported), and 9
   under the policy against (d)'s single run (bitwise equal, checked).  No
   flash-attention kernel launches (checked).
8. text — the FedNLP text transformer at its full default width (dim 256,
   4 layers, 8 heads, FFN 512, f32) on the committed real text shard
   (``data_shards/realtext``, the ``realtext_docs`` row of
   ``tools/run_baseline_rows.py``: 10 clients, 5 a round, batch 16, Adam at
   3e-3, clip 1.0, α 0.5), ``vmap`` clients: (a) 8 unfused rounds with
   K1, K2 and K3 each launched once per layer per step for the whole
   cohort (K1 also per eval batch), counted; (b) 24 rounds in blocks of 8
   (CUDA graphs), test accuracy above 0.6; (c) the first fused block ≡
   the 8 unfused rounds to 1e-6 with a graph captured; (d) a profiled pass of
   each: host launch calls and device kernels a round, device busy share,
   K1–K3's share of device time, peak GiB, real samples/s; (e) the small
   config of ``tests/test_model_zoo_ext.py``, 2 SGD rounds card vs CPU
   from the same weights, params within 1e-5.
9. resnet — ``resnet18_gn`` at full width on the ``cifar100_resnet18`` row
   (FedProx μ 0.1, 32 clients, 4 a round, batch 20, lr 0.05, α 0.5) on the
   synthetic CIFAR-100 stand-in: one warm round and two timed, finite
   losses, moved params, peak GiB; no flash-attention kernel launches
   (checked).
10. models — the rest of the sp zoo through ``build_sp``: (a) the FedAvg
   paper's Shakespeare char-LSTM (``rnn`` at full width, seq 80; 100
   clients, 10 a round, batch 10, lr 1.47) on the synthetic Markov-chain
   stand-in at 16,000 / 2,000 windows and (b) Stack Overflow next-word
   prediction (``rnn_stackoverflow``, vocab 10,004, seq 20; batch 16) on
   50,000 / 5,000, each 4 rounds unfused and 8 in blocks of 4 (CUDA
   graphs), fused ≡ unfused to 1e-6 after the first block with a graph
   captured, s/round, host launch calls and device kernels a round, busy
   share, peak GiB, test loss (below round 0's) and accuracy; (c) tag
   prediction (``lr`` on ``stackoverflow_lr``, 500 tags × 10,000
   features) and (d) ``uci`` LR, a warm round and three timed, BCE and
   exact match; (e) a round of each of ``vgg11``, ``mobilenet`` and
   ``efficientnet`` after a warm one, on the CIFAR-10 stand-in cut to
   2,000 / 500 images; (f) card ≡ CPU to 1e-6 on small ``rnn``,
   ``rnn_stackoverflow``, tag-prediction and ``mobilenet`` rounds.  No
   flash-attention kernel launches (checked).
11. engines — the other sp engines at the JAX package's default widths,
   built through ``FedMLRunner`` (or as classes), each one warm round, its
   timed rounds and one profiled round (seconds a round, host launch calls
   and device kernels a round, busy share, peak GiB): (a) FedNAS on the
   DARTS supernet (channels 16, steps 3) on the CIFAR-10 stand-in cut to
   2,000 / 500 at 32 px, 10 clients, 4 a round, batch 16: finite losses,
   alphas moved, a genotype without ``none``; (b) FedSeg on the UNet (base
   16) on ``fets2021`` at its reference spec (64×64×4, 4 classes, 2,000 /
   400), 10 clients, 4 a round, batch 8: mIoU above round 0's; (c) FedGKT
   with its default nets on the CIFAR-10 stand-in cut to 2,000 / 500, 4
   clients, batch 32: the server loss falls; (d) FedGAN with its default G
   and D on the MNIST stand-in cut to 2,000 images, 4 clients, 2 a round,
   batch 32: finite losses, samples in [−1, 1]; (e) split learning (the
   JAX test's Dense 32 / Dense 10 halves) on the MNIST stand-in, vertical
   FL at NUS-WIDE's widths 634/1000 (synthetic), TurboAggregate's exact
   sum over the flat updates of (b)'s last cohort, and the centralized
   trainer on ``lr``; (f) card ≡ CPU for every engine at the CPU tests'
   sizes from the same weights (and FedGAN's same z), TF32 off, to 1e-6
   (1e-4 for the Adam-trained nets of FedGKT and FedGAN).  No
   flash-attention kernel launches (checked).
12. llm — the causal-LM remainder at Llama-2-7B widths (dim 4096, 32
   heads, ffn 11008, bf16) over a 32,000-token vocabulary at seq 1024,
   random weights from a seed, depth cut per path: (a) ``CausalLMTrainer``
   LoRA rank 8, 4 layers, batch 2, accumulation 2, cosine after a warmup of
   2, clip 1.0, ``max_steps`` 6: eval NLL falls, the base bitwise unchanged,
   every B adapter non-zero, K1/K2/K3 launched L·(2·micro + eval), L·micro
   and L·micro times, a checkpoint → new trainer → resume round trip with
   the same eval NLL; (b) the trainer dense (f32 masters, AdamW), 2 layers,
   4 steps: the NLL falls, every parameter moves; (c) ``streaming_xent`` at
   N 2048, D 4096, chunks 8192 and 5000 (padded) against ``causal_nll`` on
   the dense logits (loss, dh, dw, peak memory of each), and a
   ``FedLLMAPI`` round with ``streaming_xent_chunk`` 8192 against the
   dense-loss round from the same weights (2 layers, 2 clients); (d)
   ``MoEMLP`` (8 experts, top-2) against its plain per-token version, and a
   MoE LoRA round; (e) ``remat`` "dots" against "full" and "none" on one
   step (loss, adapter gradients, peak GiB, seconds, K1 twice a layer under
   both recomputing modes); (f) the sp hub: ``run_simulation`` with
   ``tiny_llama`` (TINY, f32, GQA 4:2, D 16) on synthetic Shakespeare,
   K1–K3 once a layer a step for the vmapped cohort, fused (blocks of 8,
   CUDA graphs) ≡ unfused, ``evaluate_per_client`` of both APIs, one round
   of ``llama`` at 7B widths (1 layer, 2 clients, seq 256); (g) card ≡ CPU
   at the CPU tests' sizes and tolerances for the trainer, the streaming
   loss, MoE and the hub's rounds.  Every path's K1–K3 counts are set to 0
   just before it and read just after.
13. mesh — the mesh engine as a world of 1 over NCCL (the process group
   the port makes when there is none, checked): (a) ``run_simulation``
   with ``backend`` "mesh", "MPI" and "NCCL" on ``lr`` ≡ the sp engine's
   run, and phase 5(b)'s FEMNIST CNN through ``MeshFedAvgAPI`` for FedAvg,
   SCAFFOLD and FedOpt (server Adam at ``server_lr`` 0.01) under both
   merge layouts (``replicated``, ``scatter``) and every
   ``collective_precision`` (fp32, bf16, int8, the same rounding noise
   given to both engines): 2 rounds ≡
   the sp engine's to 1e-6 (the replicated layout at bf16/int8, which
   quantizes only the numerator, round 0 ≡ the sp engine's fp32 master),
   with each round's seconds beside the sp engine's; (b) the text
   transformer at phase 8's realtext configuration, 2 rounds on the mesh
   ≡ the sp engine's with K1/K2/K3 launched as often; (c)
   ``FedLLMAPI(mesh=make_mesh(client=1))`` at phase 4's widths (2 layers)
   ≡ the single-device round, K1–K3 bf16 launched as often; (d)
   ``round_block`` 4 on the mesh (FEMNIST SCAFFOLD, scatter: the merge's
   NCCL calls and the row-sharded table inside the CUDA graph) ≡ unfused
   with a graph captured.  At the end the process group is torn down
   (``core.mesh.shutdown_world``), which must return within 60 s.
14. serving — Llama-2-7B widths (dim 4096, 32 heads and KV heads, ffn
   11008, vocab 32,000, bf16, ``max_seq_len`` 4096, LoRA rank 8 on the
   projections, blockwise attention for the full-buffer forwards), depth
   ``--layers`` up to ``SERVE_LAYERS`` (16; phase 15 serves the same
   model), random weights from seed 0, byte-tokenized prompts: (a)
   ``generate`` with the KV cache against the plain full-buffer step over
   32 new tokens, ms a token of each; (b) the dense engine (8 slots,
   ``buf_len`` 1024, 16 requests of 32–900 tokens, 64 new each): the first
   2 requests against ``generate``, horizon 4 against 1, tokens/s, time to
   first token, a decode step's ms, host launch calls and device busy time
   beside its bound, peak GiB beside ``estimate_serving_memory``; (c) int8
   KV: one layer's attention output against native (≤ 5e-2 relative), the
   tokens beside native's; (d) the paged engine (16-token pages, 64-token
   chunks) against the dense engine, prefix pages shared (16 new tokens),
   every page free after the drain, and a pool too small for the longest
   requests (they park, then complete 16 new tokens each); (e) 8 saturated rank-8 adapters mixed with base
   traffic in one batch, each request against ``generate`` with its
   adapter; (f) the server over loopback HTTP against the engine
   (completions, chat, an SSE stream joining to the chat reply, an adapter
   by ``model=``, 404 for an unknown one); the P·V product's bits against
   a bf16 matmul with cuBLAS's reduced-precision reduction on and off; (g)
   card ≡ CPU on TINY in f32: the dense, int8 and paged decode logits to
   1e-5.  Every token of every greedy stream of (a)–(e), before and after
   any parting, is held teacher-forced to an f32 witness (the weights
   upcast, the plain forward): within ``SERVE_TIE_FACTOR`` times the bf16
   plain forward's logit distance from the witness of the witness's top
   logit; the paths' logit differences on identical inputs are held to the
   same limit, and another request's stream must fail it.  Each parting
   is printed and recorded.  K1–K3 launch 0 times (checked).
15. serving_spec — on phase 14's model, prompts and dense-engine streams:
   (a) the int8 weight-only tree (``quantize_params_int8``): its bytes
   against bf16, ``quantization_error``, the plain engine over the 16
   requests (tokens/s, time to first token, a decode step's ms, host
   launch calls, device busy time and bound, peak GiB) beside phase 14
   (b)'s, one request against the int8 tree's ``generate``; (b)
   ``speculative_generate`` of one 64-token request with the int8 tree of
   the target as draft and with a 2-layer draft at the same widths: ms a
   token beside ``generate``'s, acceptance, target and draft forwards,
   and a (k+1)-token verify block's logits against 1-token steps; (c) the
   ``SpeculativeBatchingEngine`` (8 slots, k 4, the int8 draft) over the
   16 requests against the dense engine's streams: tokens/s, time to
   first token, its stats; (d) one HTTP request to the server with a draft
   and ``batch_slots``; (e) the adapter cache mode: 4 adapters through 3
   bank rows against the bank-resident engine, hits, misses and
   evictions; (f) card ≡ CPU on TINY f32: speculative tokens (a
   misaligned draft, an int8 draft) equal plain greedy on both devices.
   Every stream is held to a witness as phase 14's are: the bf16 model's
   for (b)–(e), the int8 tree's (its dequantized weights upcast to f32)
   for (a), each with its control; the peak GiB of each sub-phase is
   printed.  K1–K3 launch 0 times (checked).
16. planes — phase 5 (b)'s FEMNIST CNN: (a) FedBuff with K the cohort at
   zero latency ≡ the sync rounds bitwise (the atomic-cohort fast path),
   and a heavy-tailed run (log-normal latency, 2 generations in flight,
   dropout, a staleness cap): finite losses, staleness, drops; (b) a
   SCAFFOLD ``client_store`` run ≡ the dense table bitwise (state and
   every row), ``data_paging`` ≡ the host-staged path bitwise, and
   ``registered_clients`` 10^6 with only the sampled rows touched; (c) a
   ``checkpoint_dir`` run stopped after 2 rounds and resumed from its step
   and store sidecar ≡ the uninterrupted run bitwise.  Seconds a round of
   each beside the sync engine's.  K1–K3 launch 0 times (checked).
17. tp — the 2-D ``client × model`` mesh at a model factor of 1 (one card:
   ``make_mesh2d("1,1")``, its model group of one rank running every
   collective): (a) ``FedLLMAPI(mesh=...)`` at phase 4's configuration
   through the tensor-parallel model (column/row-parallel projections,
   vocab-parallel embedding, row-parallel ``lm_head``, the adapters'
   gradients summed over the model group): its adapters against phase
   4's to ``MESH_LORA_TOL``, K1–K3 launched as the round needs (counts
   set to 0 just before, read just after); (b) K1, K2 and K3 at the shard
   shapes a model factor of 2 and 4 gives a Llama-2-7B layer (B 2, H = H_kv
   16 and 8, S 1024, D 128, causal, bf16), each against its plain version
   and timed as phase 3 times them (rows under ``"tp_shards"``: no path
   runs these shapes on one card); (c) ``MeshFedAvgAPI`` with
   ``mesh_shape="1,1"`` on phase 5 (b)'s FEMNIST CNN, FedAvg and SCAFFOLD
   under both layouts, 2 rounds ≡ the sp engine's to ``MESH_TOL``; (d)
   greedy decode over the tensor-parallel model (Llama-2-7B widths, 2
   layers, dense and int8 KV) ≡ ``generate`` over the plain model from the
   same weights, token for token.  Then the process group is torn down.
   A model factor above 1 needs more cards: ``tools/torch_mesh_ranks.py``.
18. mesh3d — the mesh's remainder on one card: (a) the 3-D pipeline
   trainer (``mesh_shape="1,1,1"``, ``microbatches`` 4) on ``pipe_mlp`` at
   hidden 4096 and depth 16 (268 M params, f32), 2 rounds against the sp
   engine's from the same weights running its clients one by one, as the
   pipeline does (``PIPE_TOL``), seconds a round beside the sp round's;
   the sp engine's vmapped client map is a reported control (why it
   parts from the one-by-one map: ``tools/torch_client_map_gap.py``); (b) ``mesh_shape="1,1,1"`` on phase 5 (b)'s FEMNIST
   CNN with ``client_store``, ``data_paging``, ``registered_clients``
   10^6 and a ``checkpoint_dir`` resume, each bitwise phase 16's sp run
   (state and every row); (c) ring attention's schedule on one card, the
   exchange replaced by slicing: Llama-2-7B attention (B 1, H 32, D 128,
   causal, bf16) at S 4096 in 4 blocks of 1024, K1 launched 10 times
   forward (4 diagonal, 6 full, 6 blocks skipped) and K2 and K3 10 times
   each backward (counts set to 0 just before each, read just after), the
   output and gradients held to one K1/K2/K3 call over S and to the ring
   of the kernels' plain versions (``KERNEL_TOL``), the output to the
   plain ring (the JAX recurrence) and its gradients within one limit of
   what the one call reads against the plain ring's autograd (which keeps
   dS in f32), the ring's forward+backward device time beside the one
   call's, and each kernel timed at the two block shapes in the f32-output
   mode the ring launches (rows under ``"ring_blocks"``).  K1–K3 launch 0 times in (a) and (b)
   (checked).  Then the process group is torn down.  A stage or seq factor
   above 1 needs more cards: ``tools/torch_mesh_ranks.py``.
19. cross_silo — the cross-silo federation (``cross_silo/``, the message
   plane of ``core/distributed/``), server and silos each with its own
   model.  (c)'s processes start first and run beside (a)–(b).  (a) phase
   5 (b)'s FEMNIST CNN as a server and 2 silos in threads over ``local``
   for 3 rounds on the card; each silo's round-0 pass is then traced step
   by step on the card and on the CPU from the same weights (each silo
   draws its dropout masks from its (round, client) generator on the
   host, so both devices draw the same): every step before the first
   whose forward flips a ReLU sign or a max-pool winner between the two
   within ``XS_TOL``, the forwards' pre-activations within ``XS_ACT_TOL``
   through that step, and the federation's round-0 upload of that silo
   bitwise the traced card pass (all checked; the flip step recorded:
   once one flips, the CNN amplifies the difference into 1e-2 within 3
   rounds, PERF.md §6); K1–K3 launch 0 times (checked); (a') phase 5
   (d)'s ``cnn_web`` and ``tests/test_cross_silo.py``'s ``lr`` federations
   card ≡ CPU within ``XS_TOL``, and the ``lr`` one ≡ the sp engine from
   the same weights (the dropout-free config on which the CPU tests show
   the two engines agree; the CNN's per-silo dropout draws differ from
   the sp engine's per-round draws by design); (b) phase 8's text
   transformer at full width (realtext) as 2 silos for 2 rounds, clean
   and under ``XS_FAULTS`` (seeded dup/delay chaos, reliable delivery, 4
   MiB frames): the fault run bitwise the clean run, K1, K2 and K3
   launched in each run exactly layers × (silo steps + eval batches ×
   evals) and layers × silo steps times (counts set to 0 just before each
   run and read just after), the server's eval accuracy printed; (c)
   (a)'s federation as 3 OS processes started by ``CrossSiloLauncher``
   (``tools/torch_cross_silo_entry.py``) over ``MQTT_S3`` through the
   in-repo ``MiniMqttBroker`` on an ephemeral port, done within
   ``XS_JOIN_S`` of their launch: the server's final params bitwise (a)'s
   threads.  Each sub-phase prints its seconds, each round's silo local
   pass and upload-to-next-sync seconds, and a model message's bytes.
20. wire — the wire codec (``core/wire.py``) and its users on phase 8's
   text transformer at full width (realtext, 4 clients a round over 2
   silos, 2 rounds unfused, SGD clients): (a) ``num_silos=2`` through
   ``FedMLRunner`` (``HierarchicalSiloAPI``) beside the flat
   ``FedAvgAPI`` from the same weights: losses and params within the JAX
   package's reassociation bound (2e-5), K1–K3 counted in each (the silos
   map their clients apart: a step launches each kernel once a layer a
   silo; the same eval launches); (b) ``run_silo_federation`` with a
   server and 2 silos in threads over ``local`` at ``wire_precision``
   fp32, 4 MiB frames and reliable delivery: its losses and final params
   bitwise (a)'s two-tier run; (c) as (b) at int8 with ``wire_overlap``,
   traced: the loss gap to (b) (held to ``WIRE_INT8_TEXT_TOL``, printed
   beside the JAX package's ``lr`` bound), each state sync's error as the
   silos receive it, equal to the link's residual step
   (``WireStateSyncs``), the silos holding the last sync bitwise, the
   error feedback's norm, the wire's bytes equal to the codec's model,
   and a text partial's bytes at fp32, bf16 and int8; (d) ``run_async_federation`` with a server and 2
   workers over ``local`` on ``lr`` at int8: every apply's loss finite,
   the final params within ``WIRE_ASYNC_REL`` of ``FedBuffAPI``'s move;
   (e) ``checkpoint_codec="wire"`` on ``lr``: 2 rounds, a checkpoint, a
   fresh API resumed bitwise, and a combine tier with ``checkpoint_dir``
   whose WAL ``state_digest``s are the crc32 of the state it shipped.
21. obs — the obs plane (``fedml_tpu_torch/obs/``): (a) phase 5 (b)'s
   FEMNIST CNN in blocks of 4 for 8 rounds with ``trace``, ``health`` and
   ``metrics_port=0`` on beside the same run off: losses and params
   bitwise, the same graph captures, the same ``TorchRuntimeAudit``
   counts over the steady-state block (sync debug mode "warn": host
   syncs, builds, captures, explicit copies), one finite ``obs.round`` row
   a round with the collective bytes of the byte model, the trace read by
   ``tools/fedtrace.py summarize``, ``/metrics`` parsed, s a round on and
   off; (b) ``tests/test_fedmon.py``'s label-flip config (``lr``, 64
   clients, 32 a round, 6 flipped, 10 rounds) on sp, fused (blocks of 5)
   and FedBuff (the buffer the cohort): the card flags the set the CPU
   flags, at precision and recall >= 0.9; (c) the ``trace_device`` probe
   (``obs/devicetime.py``) on phase 8's text model at full width (f32,
   its cohort): four measured phase times > 0 and K1–K3 counted around
   it (each kernel once a layer a step of each client map it runs,
   ``launches_by_path`` ``obs_probe_text``); (d) the probe's event timer
   on phase 3's K1 text-shape call, 20 calls as one CUDA graph, within
   ``OBS_TIMER_TOL`` of :func:`graph_ms`.
22. trust — serving's obs hooks and the trust stack (``core/security/``,
   ``core/dp/``): (a) at phase 15's end, on phase 14's model and engine,
   4 slots, 8 requests over two adapters and a trailing one after a pause,
   once with ``metrics_port=0``, ``slo_rules`` (a TTFT objective, an
   error-rate rule) and ``hist_labels=2`` under the tracer and once with
   all off: tokens bitwise, ``/metrics`` parsed, ``serve.tokens_total``
   and the per-adapter request counters equal the host's counts, the
   ``traceparent``'s trace id on the span tree, the same host syncs by
   site under ``TorchRuntimeAudit``, ms a step on and off; (b) phase 19
   (b)'s text model at full width as 5 silos for 2 rounds through a FedAvg
   ``ServerAggregator`` whose hooks inject the byzantine attack (random,
   the first silo), keep krum's choice and add global Gaussian DP: finite
   params and eval loss, krum's kept silo never the attacked one (printed
   with its scores), K1–K3 launches the expected count
   (``launches_by_path`` ``trust_text``), round 0's silo passes the
   formula's, none inside the trust hooks; the defense + DP seconds beside the round's, the model
   message's bytes;
   (b-small) phase 8 (e)'s narrow text model through the same pipeline as
   4 silos on the card and in a CPU process, the CPU's noise draws carried
   to the card, every round's params within ``TEXT_CARD_CPU_TOL``; (c)
   every registered defense on a ``(C=8, D = (b)'s parameter count)``
   stack with 2 rows shifted by +100, on the card against the same
   defense in that CPU process, the CPU's noise draws carried: the kept
   or selected positions equal (a krum or bulyan choice that flips at a
   near tie is printed with both devices' scores), the merges within
   ``TRUST_DEFENSE_TOL`` relative, or, where the f32 rounding at this D is
   itself above it (FoolsGold's cosines, cclip's and the clips' norms),
   card and CPU each within ``TRUST_WITNESS_FACTOR`` times the CPU f32
   run's distance from the defense's float64 run; each defense's ms on
   the card;
23. trust2 — the trust stack's second half (``core/fhe/``,
   ``core/contribution/``, ``core/mpc/``, ``cross_silo/{secagg,
   lightsecagg}/``), with a CPU process started at the phase's start:
   (c) the text model at full width as 3 silos (the port's cross-silo
   silo trainer on the card) through the SecAgg and the LightSecAgg FSMs
   (a server and 3 clients on threads over ``local``, 1 round): the
   server's params bitwise the host witness of the same field arithmetic
   and, unless the printed headroom max_e Σ_i n_i·|x_i,e| passes the
   field's (p − 1)/2 / 2^16, within 3·2^-17/Σn + 2^-23·max|avg| of the
   float64 plaintext weighted average; K1–K3 launches the silos' passes
   (``trust2_secagg``, ``trust2_lightsecagg``); (a) (c)'s three SecAgg
   silos encrypted on the card by a ``ClientTrainer``'s hook, merged by
   ``fhe_fedavg`` and decrypted by a ``ServerAggregator``'s hook: every
   element within the scheme's error of the float64 plaintext average
   (2^-17·Σ|x_i| + 2^-30 + W·max|e|/2^46 + 2^-24·|avg|), the ciphertext
   65,536 · ceil(D / 2048) bytes, silo 0's c0, c1 and decryption bitwise
   the CPU process's with the card's draws carried, two codecs of one
   seed drawing different c1; encrypt, aggregate and decrypt ms; (b) the
   text model as 4 silos, 1 round, silo 0 replaced by the byzantine
   attack, exact MR-Shapley through the cross-silo server: the attacked
   silo's φ the lowest, Σφ = U(all) within ``TRUST2_EFFICIENCY_TOL``,
   K1–K3 the silos' passes plus one forward over the test batches a
   coalition (15) and the server's evaluation (``trust2_contribution``),
   GTG and LOO on the same list, the assessment's seconds beside the
   round's; (b-small) the narrow text model's run on the card and in the
   CPU process (its attack draws carried): utilities equal or apart by
   whole test examples (counted), φ equal where none differs.

The second-to-last lines are a JSON object of per-kernel numbers (a row
per kernel at the slice shape and at the text shape, with its launches on
the path that runs it: phase 4's LoRA rounds, phase 8's unfused text
rounds; the bf16 text-shape measurement under ``"bf16_at_text"``; the
forward+backward times, the slice's round numbers, phase 5's numbers
under ``"sp"``, phase 6's under ``"zoo"``, phase 7's under ``"fusion"``,
phase 8's under ``"text"``, phase 9's under ``"resnet"``, phase 10's
under ``"models"``, phase 11's under ``"engines"``, phase 12's under
``"llm"``, phase 13's under ``"mesh"``, phase 14's under ``"serving"``,
phase 15's under ``"serving_spec"``, phase 16's under ``"planes"``,
phase 17's under ``"tp"`` (its kernel rows under ``"tp_shards"``) and
phase 18's under ``"mesh3d"`` (its kernel rows under ``"ring_blocks"``),
phase 19's under ``"cross_silo"``, phase 20's under ``"wire"``,
phase 21's under ``"obs"``, phase 22's under ``"trust"`` and phase 23's
under ``"trust2"`` beside them; each kernel row adds phase 12's to 23's
launches a path under
``launches_by_path``)
and the card's
name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero before
that line; so does a host without CUDA, or a directory without the port.
"""

import argparse
import atexit
import json
import os
import subprocess
import sys
import threading
import time

#: H100 SXM, dense.  f32: the kernels' f32-accurate products run on the
#: tensor cores as 3xTF32 (three TF32 passes a product), so the least time
#: for them is 495 TF32 TFLOP/s / 3, not the 67 of f32 FMA outside the
#: tensor cores
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12 / 3}
PEAK_BYTES = 3.35e12
#: csrc/flash_sm90.cuh FA_BF16_HEAD_DIMS: the head dims every kernel is
#: built for, in bf16 and in f32
BF16_HEAD_DIMS = range(16, 129, 16)
REPLACES = {
    "flash_fwd": "fedml_tpu/ops/attention.py:114",
    "flash_bwd_dq": "fedml_tpu/ops/attention.py:332",
    "flash_bwd_dkv": "fedml_tpu/ops/attention.py:381",
}


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def max_err(got, ref):
    return (got.float() - ref.float()).abs().max().item()


def check_close(att, what, got, ref):
    """Hold a kernel's output to its plain version's (``KERNEL_TOL``)."""
    st = att.compare_with_plain(got, ref)
    line = (f"{what} err {st['err']:.2e} (|plain| median {st['median']:.2e}"
            f", max {st['max']:.2e}; worst element {st['elem']:.2f} and "
            f"worst 64-row block {st['block']:.2f} of their limits)")
    if not (st["elem"] <= 1 and st["block"] <= 1):
        fail(line)
    return st["err"], line


def time_ms(torch, fn, reps, warm=2):
    """Eager time of one call of ``fn``: CUDA events around ``reps`` calls
    from Python after ``warm`` calls; a call faster than its host work
    reads as the host work (what an unfused round pays)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps=20, warm=2, replays=3, stream=None):
    """Device time of one call of ``fn``: ``warm`` calls on a side stream
    (``stream`` if given), then ``reps`` calls captured in one CUDA graph on
    it, the graph replayed once untimed and ``replays`` times under CUDA
    events; ms a call.  The calls run back to back on the card with no host
    work between them, so this reads the kernels (and the gaps between a
    graph's nodes), not the Python wrapper."""
    import gc
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warm):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    gc.collect()
    gc.disable()   # nothing may free CUDA objects inside the capture
    try:
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            for _ in range(reps):
                fn()
    finally:
        gc.enable()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * replays)


def profiler_ms(torch, fn, reps=20, warm=2):
    """Device time of one call of ``fn`` from ``torch.profiler``: the
    summed device time of the kernels that ``reps`` eager calls launched
    (the gaps between them not counted), over ``reps``."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "self_device_time_total", 0) or 0
             for ev in prof.key_averages()
             if ev.device_type == torch.autograd.DeviceType.CUDA)
    if not us:
        fail("torch.profiler saw no device time")
    return us / 1e3 / reps


def library_ms(torch, fn, stream=None):
    """A library call's (device ms, method, eager ms): its device time by
    graph replay (:func:`graph_ms`), or from the profiler
    (:func:`profiler_ms`) where the call cannot be captured; beside it the
    eager time (:func:`time_ms`)."""
    try:
        ms, method = graph_ms(torch, fn, stream=stream), "graph"
    except RuntimeError as e:
        torch.cuda.synchronize()
        say("kernels", f"  library call not captured ({str(e)[:120]}): "
                       "its device time is read from the profiler")
        ms, method = profiler_ms(torch, fn), "profiler"
    return ms, method, time_ms(torch, fn, 20)


def work(kernel, b, h, hkv, s, d, causal, dtype, out_f32=False):
    """(operations, bytes) of one call: the products' flops over the
    unmasked (q, k) pairs (counted exactly for causal attention), and the
    bytes the function must move (each input read once, each output
    written once; ``out_f32``: O, dQ, dK and dV written at 4 bytes an
    element, the f32-output mode of a bf16 build)."""
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    esz = 2 if dtype == "bfloat16" else 4
    osz = 4 if out_f32 else esz
    qb, kvb, row = b * h * s * d * esz, b * hkv * s * d * esz, b * h * s * 4
    qo, kvo = qb // esz * osz, kvb // esz * osz
    if kernel == "flash_fwd":
        return 4 * pairs * d, qb + 2 * kvb + qo + row
    if kernel == "flash_bwd_dq":     # S, dP, dQ products + Δ; q k v o dO lse
        return (6 * pairs * d + 2 * b * h * s * d,
                3 * qb + 2 * kvb + row + qo + row)
    # S, dP, dV, dK; q k v dO lse Δ → dK dV
    return 8 * pairs * d, 2 * qb + 2 * kvb + 2 * row + 2 * kvo


def bound(kernel, b, h, hkv, s, d, causal, dtype, out_f32=False):
    """(ms, "bytes"|"operations"): the larger of the bytes the function
    must move over the memory rate and its operations over the peak rate
    for its type (:func:`work`)."""
    flops, nbytes = work(kernel, b, h, hkv, s, d, causal, dtype, out_f32)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


#: phase 3's shapes: (tag, B, H, H_kv, S, D, causal, dtype).  "slice" is
#: the LoRA round's attention call, "text" the text transformer's (phase 8:
#: 5 clients × batch 16 folded into B, f32, full), "text_bf16" the same in
#: bf16 (a measurement only: the text model runs f32)
KERNEL_SHAPES = [("slice", 2, 32, 32, 1024, 128, True, "bfloat16"),
                 ("ragged_gqa", 1, 8, 2, 1000, 128, False, "bfloat16"),
                 ("padded_head", 1, 8, 2, 300, 80, True, "bfloat16"),
                 ("small_f32", 1, 4, 2, 200, 64, True, "float32"),
                 ("text", 80, 8, 8, 128, 32, False, "float32"),
                 ("text_bf16", 80, 8, 8, 128, 32, False, "bfloat16")]
#: the shapes phase 3 times
TIMED_SHAPES = ("slice", "text", "text_bf16")


def time_kernels(torch, att, tag, inputs, shape, errs, smi, out_f32=False):
    """Phase 3's timings at one shape: each kernel's device time (``ms``:
    20 calls replayed as one CUDA graph, :func:`graph_ms`) beside its eager
    time (``eager_ms``: 20 calls from Python, what an unfused round pays),
    its plain version (eager, 5 calls), its bound, and one library call
    computing the same function, by both readings (``library_ms`` and
    ``library_method``: graph or profiler; ``library_eager_ms``):
    ``scaled_dot_product_attention`` for K1; for K2 and K3 PyTorch's
    attention backward, which gives dQ, dK and dV together (bf16: the
    flash-attention backward op; f32: the backward of SDPA's own f32
    forward, one ``autograd.grad``).  Also K1+K2+K3 forward+backward
    through autograd beside SDPA's, by both readings.  ``tflops`` and
    ``bound_share`` are taken from the device time.  Returns (rows keyed
    ``"<kernel>@<tag>"``, forward+backward times).  ``out_f32``: each
    kernel and plain version in its f32-output mode (the ring's), the
    bound counting its f32 outputs; the library calls as they are."""
    q, k, v, do, o, lse, delta = inputs
    f32 = dict(out_f32=True) if out_f32 else {}
    b, h, hkv, s, d, causal, dt = shape
    calls = {
        "flash_fwd": (
            lambda: att.flash_attention_fwd(q, k, v, causal, **f32),
            lambda: att.flash_attention_fwd_plain(q, k, v, causal, **f32)),
        "flash_bwd_dq": (
            lambda: att.flash_attention_bwd_dq(q, k, v, o, lse, do, causal,
                                               **f32),
            lambda: att.flash_attention_bwd_dq_plain(q, k, v, o, lse, do,
                                                     causal, **f32)),
        "flash_bwd_dkv": (
            lambda: att.flash_attention_bwd_dkv(q, k, v, lse, delta, do,
                                                causal, **f32),
            lambda: att.flash_attention_bwd_dkv_plain(q, k, v, lse, delta,
                                                      do, causal, **f32)),
    }
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fwd = library_ms(torch, lambda: sdpa(q, k, v, is_causal=causal))
    ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    if dt == "bfloat16":
        lo, llse, cq, ck, mq, mk, seed, offset, _ = \
            torch.ops.aten._scaled_dot_product_flash_attention(
                q, k, v, 0.0, causal)
        lib_bwd = library_ms(
            torch, lambda: torch.ops.aten
            ._scaled_dot_product_flash_attention_backward(
                do, q, k, v, lo, llse, cq, ck, mq, mk, 0.0, causal, seed,
                offset))
    else:
        # autograd runs each backward op on its forward's stream: the
        # forward is taken on the stream the graph captures
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            lib_out = sdpa(ql, kl, vl, is_causal=causal)
        torch.cuda.current_stream().wait_stream(side)
        lib_bwd = library_ms(torch, lambda: torch.autograd.grad(
            lib_out, (ql, kl, vl), do, retain_graph=True), stream=side)
    library = {"flash_fwd": lib_fwd, "flash_bwd_dq": lib_bwd,
               "flash_bwd_dkv": lib_bwd}
    rows = {}
    for name, (kern, plain) in calls.items():
        b_ms, b_by = bound(name, b, h, hkv, s, d, causal, dt, out_f32)
        ms = graph_ms(torch, kern)
        lib_ms, lib_method, lib_eager = library[name]
        rows[f"{name}@{tag}"] = r = {
            "name": name, "route": "cuda",
            "source": f"fedml_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": 0,
            "max_abs_err": errs[name], "ms": ms, "method": "graph",
            "eager_ms": time_ms(torch, kern, 20),
            "plain_ms": time_ms(torch, plain, 5),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "library_method": lib_method,
            "library_eager_ms": lib_eager, "shape": tag, "dtype": dt,
            "out_f32": out_f32,
            "tflops": work(name, b, h, hkv, s, d, causal, dt)[0] / ms / 1e9,
            "bound_share": b_ms / ms}
        say("kernels", f"{name} @{tag}{' (f32 out)' if out_f32 else ''}: "
                       f"{ms:.4f} ms device (graph; eager "
                       f"{r['eager_ms']:.4f}) ({r['tflops']:.1f} TFLOP/s, "
                       f"{100 * r['bound_share']:.1f}% of bound), "
                       f"{r['plain_ms']:.3f} ms plain, bound "
                       f"{b_ms:.4f} ms ({b_by}), library {lib_ms:.4f} ms "
                       f"({lib_method}; eager {lib_eager:.4f}) [{smi}]")

    def lib_fb():
        torch.autograd.grad(sdpa(ql, kl, vl, is_causal=causal),
                            (ql, kl, vl), do)

    def ours_fb():
        torch.autograd.grad(att.flash_attention(ql, kl, vl, causal),
                            (ql, kl, vl), do)

    lib = library_ms(torch, lib_fb)
    fwd_bwd = {"ms": graph_ms(torch, ours_fb), "method": "graph",
               "eager_ms": time_ms(torch, ours_fb, 10),
               "library_ms": lib[0], "library_method": lib[1],
               "library_eager_ms": lib[2], "library_fwd_ms": lib_fwd[0],
               "library_fwd_method": lib_fwd[1]}
    say("kernels", f"fwd+bwd @{tag}: ours {fwd_bwd['ms']:.4f} ms device "
                   f"(graph; eager {fwd_bwd['eager_ms']:.3f}), "
                   f"scaled_dot_product_attention {lib[0]:.4f} ms ({lib[1]}"
                   f"; eager {lib[2]:.3f}); its forward alone "
                   f"{lib_fwd[0]:.4f} ms ({lib_fwd[1]}; eager "
                   f"{lib_fwd[2]:.4f}) [{smi}]")
    return rows, fwd_bwd


#: phase 5's configurations (a) and (b) (also profiled by
#: tools/torch_sp_profile.py)
SP_LR_BENCH = dict(dataset="synthetic", num_classes=10,
                   input_shape=(28, 28, 1), train_size=60000, test_size=1000,
                   model="lr", client_num_in_total=1000,
                   client_num_per_round=256, batch_size=10,
                   learning_rate=0.03, partition_method="homo",
                   comm_round=11, sp_client_mode="vmap")
SP_FEMNIST_CNN = dict(dataset="femnist", model="cnn",
                      client_num_in_total=100, client_num_per_round=10,
                      partition_method="hetero", partition_alpha=0.5,
                      batch_size=20, learning_rate=0.06, comm_round=3)


def sp_args(fedml_tpu_torch, **over):
    cfg = dict(epochs=1, frequency_of_the_test=10 ** 9, random_seed=0)
    cfg.update(over)
    return fedml_tpu_torch.load_arguments().update(**cfg)


def build_sp(args):
    """The FedAvg simulation as a user script builds it; returns its
    ``FedAvgAPI``."""
    from fedml_tpu_torch import data, device, model
    from fedml_tpu_torch.runner import FedMLRunner

    dev = device.get_device(args)
    dataset, output_dim = data.load(args)
    runner = FedMLRunner(args, dev, dataset, model.create(args, output_dim))
    return runner.runner.fl_trainer


def timed_rounds(torch, api, phase, timed, smi):
    """One warm round, then ``timed`` rounds each ended by a synchronise:
    seconds a round, real training samples a second, peak device memory,
    the round losses and the test loss/accuracy after the last round."""
    before = {k: v.clone() for k, v in api.state.global_params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, seconds, samples = [], [], 0
    for r in range(timed + 1):
        t0 = time.time()
        m = api.train_one_round(r)
        torch.cuda.synchronize()
        dt = time.time() - t0
        losses.append(float(m["train_loss"]))
        say(phase, f"round {r}{' (warm)' if r == 0 else ''}: loss "
                   f"{losses[-1]:.4f}, {float(m['total_steps']):.0f} real of "
                   f"{m['allocated_steps']} client steps, {dt:.4f} s")
        if r:
            seconds.append(dt)
            samples += int(float(m["total_steps"])) * api.batch_size
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    test_loss, test_acc = api.evaluate()
    if not all(x == x and abs(x) < float("inf")
               for x in losses + [test_loss]):
        fail(f"{phase}: non-finite loss {losses}, test {test_loss}")
    moved = all(not torch.equal(v, before[k])
                for k, v in api.state.global_params.items())
    if not moved:
        fail(f"{phase}: some global params did not move")
    rec = {"s_per_round": sum(seconds) / timed,
           "samples_per_s": samples / sum(seconds), "peak_gib": peak,
           "round_losses": losses, "test_loss": test_loss,
           "test_acc": test_acc, "timed_rounds": timed}
    say(phase, f"{rec['s_per_round']:.4f} s/round, "
               f"{rec['samples_per_s']:.0f} samples/s, peak "
               f"max_memory_allocated {peak:.3f} GiB, test acc "
               f"{test_acc:.4f} [{smi}]")
    return rec


def sp_phase(torch, fedml_tpu_torch, smi):
    from fedml_tpu_torch import data, model
    from fedml_tpu_torch.ml.trainer.local_trainer import LocalTrainer
    from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI

    out = {}
    # (a) lr at bench.py's FedAvg shape
    t0 = time.time()
    api = build_sp(sp_args(fedml_tpu_torch, **SP_LR_BENCH))
    say("sp", f"(a) lr, 1000 clients (256 a round, batch 10), synthetic "
              f"60,000 × 28×28×1; built in {time.time() - t0:.1f} s")
    out["lr_bench"] = timed_rounds(torch, api, "sp a", 10, smi)
    del api

    # (b) the FEMNIST CNN on the synthetic FEMNIST stand-in
    t0 = time.time()
    api = build_sp(sp_args(fedml_tpu_torch, **SP_FEMNIST_CNN))
    n_out = api.state.global_params["Dense_1.bias"].shape[0]
    say("sp", f"(b) CNNDropOut ({n_out} classes), femnist synthetic "
              f"{api.dataset.train_data_num:,} / {api.dataset.test_data_num:,}"
              f", 100 clients (α 0.5), 10 a round, batch 20; built in "
              f"{time.time() - t0:.1f} s")
    if n_out != 62 or api.dataset.train_x.shape[1:] != (28, 28, 1):
        fail(f"(b) is not FEMNIST width: {n_out} classes, "
             f"{api.dataset.train_x.shape}")
    out["femnist_cnn"] = timed_rounds(torch, api, "sp b", 2, smi)
    del api

    # (c) real bytes: the CNN on the committed digits shard, end to end
    shards = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "data_shards")
    args = sp_args(fedml_tpu_torch, dataset="digits", model="cnn",
                   input_shape=(8, 8, 1), data_cache_dir=shards,
                   client_num_in_total=15, client_num_per_round=5,
                   comm_round=8, batch_size=16, learning_rate=0.05)
    t0 = time.time()
    params = fedml_tpu_torch.run_simulation(backend="sp", args=args)
    torch.cuda.synchronize()
    dt = time.time() - t0
    ds, n_out = data.load(args)
    loss, acc = LocalTrainer(model.create(args, n_out), args).evaluate(
        params, *ds.test_batches())
    say("sp", f"(c) digits CNN via run_simulation: 8 rounds in {dt:.2f} s, "
              f"{ds.provenance}, {ds.num_clients} users; test loss "
              f"{loss:.4f}, accuracy {acc:.4f} (bar 0.6) [{smi}]")
    if not acc > 0.6:
        fail(f"(c) real-digits CNN reached only {acc:.4f}")
    out["digits_cnn"] = {"seconds": dt, "test_loss": loss, "test_acc": acc,
                         "provenance": ds.provenance}

    # (d) card ≡ CPU on small f32 rounds from the same weights, under the
    # device policy (TF32 off); a third run with TF32 on shows what the
    # check would read if the policy were lost
    out["card_vs_cpu"], out["card_tf32_vs_cpu"] = {}, {}
    for name, tol in (("lr", 1e-6), ("cnn_web", 1e-6)):
        args = sp_args(fedml_tpu_torch, dataset="synthetic", num_classes=10,
                       input_shape=(28, 28, 1), train_size=512,
                       test_size=128, model=name, client_num_in_total=8,
                       client_num_per_round=4, batch_size=16,
                       learning_rate=0.05, partition_method="hetero",
                       partition_alpha=0.3, momentum=0.9, random_seed=3)
        ds, n_out = data.load(args)
        card, cpu, tf32 = [FedAvgAPI(args, d, ds, model.create(args, n_out))
                           for d in ("cuda", "cpu", "cuda")]
        if torch.backends.cudnn.allow_tf32 or \
                torch.backends.cuda.matmul.allow_tf32:
            fail("(d) get_device left TF32 on")
        start = card.state.global_params
        cpu.state = cpu.state.replace(
            global_params={k: v.cpu() for k, v in start.items()})
        tf32.state = tf32.state.replace(
            global_params={k: v.clone() for k, v in start.items()})
        for r in range(2):
            card.train_one_round(r)
            cpu.train_one_round(r)
            torch.backends.cudnn.allow_tf32 = True
            torch.backends.cuda.matmul.allow_tf32 = True
            tf32.train_one_round(r)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        err, err_tf32 = (
            max(max_err(a.state.global_params[k].cpu(), v)
                for k, v in cpu.state.global_params.items())
            for a in (card, tf32))
        say("sp", f"(d) {name}: 2 f32 rounds card vs CPU from the same "
                  f"weights, params max abs diff {err:.2e} (tol {tol:g}); "
                  f"with TF32 on it would read {err_tf32:.2e}")
        if not err <= tol:
            fail(f"(d) {name}: card and CPU disagree ({err:.2e} > {tol:g})")
        out["card_vs_cpu"][name] = err
        out["card_tf32_vs_cpu"][name] = err_tf32
    return out


#: phase 6 (a): the zoo on the FEMNIST CNN, with the args each algorithm
#: adds to SP_FEMNIST_CNN (server Adam's step is server_lr per entry, so
#: FedOpt takes 0.01 in place of the default 1.0); FedAvg first, as the
#: baseline of the same phase
ZOO_FEMNIST = (("fedavg", {}), ("fedprox", {}),
               ("fedopt", dict(server_lr=0.01)), ("scaffold", {}),
               ("feddyn", {}), ("fednova", {}), ("mime", {}), ("fedsgd", {}),
               ("qfedavg", {}))
#: phase 6 (b): (algorithm, model, extra args) held card ≡ CPU
ZOO_CARD_VS_CPU = (
    [(a, "lr", o) for a, o in (("fedprox", {}),
                               ("fedopt", dict(server_lr=0.01)),
                               ("fedopt", dict(server_optimizer="sgd")),
                               ("scaffold", {}), ("feddyn", {}),
                               ("fednova", {}), ("mime", {}), ("fedsgd", {}),
                               ("qfedavg", {}))]
    + [(a, "cnn_web", {}) for a in ("scaffold", "feddyn", "fednova")])
#: phase 6 (c): the engines, with the args each adds
ZOO_ENGINES = (("hierarchical", dict(federated_optimizer="HierarchicalFL",
                                     group_num=3, group_comm_round=2)),
               ("async", dict(federated_optimizer="async_fedavg")),
               ("dsgd_symmetric", dict(federated_optimizer="dsgd",
                                       topology="symmetric",
                                       topology_neighbors=2)),
               ("dsgd_asymmetric", dict(federated_optimizer="dsgd",
                                        topology="asymmetric",
                                        topology_neighbors=2)))
#: card ≡ CPU limit of SCAFFOLD's control variates (c_server and the table)
#: on cnn_web: c_i⁺ = c_i − c + (x − y_i)/(K·lr) divides the params' f32
#: rounding by K·lr (~0.2 there), so they read 1.1e-6–1.4e-6 where the
#: params read 1e-7; everything else is held to 1e-6
SCAFFOLD_CNN_C_TOL = 4e-6
#: the server-state fields each algorithm keeps beyond the params
ZOO_STATE = {"fedopt": ("opt_state",), "scaffold": ("c_server",),
             "feddyn": ("h",), "mime": ("momentum",)}


def state_tensors(api):
    """Every ServerState field and per-client table row of an sp engine,
    as one flat ``{name: tensor}`` dict."""
    out = {}
    for f in ("global_params", "opt_state", "c_server", "h", "momentum"):
        out.update({f"{f}/{k}": v
                    for k, v in (getattr(api.state, f) or {}).items()})
    out.update({f"table/{k}": v for k, v in (api.client_table or {}).items()})
    return out


def zoo_phase(torch, fedml_tpu_torch, smi):
    """Phase 6."""
    from fedml_tpu_torch import data, model
    from fedml_tpu_torch.core import rng
    from fedml_tpu_torch.ml.trainer.local_trainer import LocalTrainer
    from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI

    out = {"femnist_cnn": {}, "card_vs_cpu": {}, "engines": {}}
    # (a) every algorithm at FEMNIST CNN width
    for alg, over in ZOO_FEMNIST:
        t0 = time.time()
        api = build_sp(sp_args(fedml_tpu_torch, federated_optimizer=alg,
                               **dict(SP_FEMNIST_CNN, **over)))
        if api.server_opt.algorithm != alg or \
                api.state.global_params["Dense_1.bias"].shape[0] != 62:
            fail(f"zoo (a) {alg}: built {api.server_opt.algorithm!r} at "
                 f"{api.state.global_params['Dense_1.bias'].shape[0]} "
                 "classes")
        say("zoo", f"(a) {alg}: FEMNIST CNN, built in "
                   f"{time.time() - t0:.1f} s")
        rec = timed_rounds(torch, api, f"zoo a {alg}", 2, smi)
        fedavg_s = out["femnist_cnn"].get("fedavg", rec)["s_per_round"]
        rec["vs_fedavg"] = rec["s_per_round"] / fedavg_s
        for f in ZOO_STATE.get(alg, ()):
            leaves = getattr(api.state, f)
            if not leaves or not all(
                    v.abs().max().item() > 0 for k, v in leaves.items()
                    if k != "count"):
                fail(f"zoo (a) {alg}: state {f} not written")
        if api.client_table is not None:
            sampled = set().union(*(api._client_sampling(r).tolist()
                                    for r in range(3)))
            rows = sum(v.flatten(1).abs().amax(1)
                       for v in api.client_table.values())
            written = set(torch.nonzero(rows).flatten().tolist())
            if written != sampled:
                fail(f"zoo (a) {alg}: table rows written {sorted(written)}"
                     f" != sampled {sorted(sampled)}")
            rec["table_rows_written"] = len(written)
            rec["table_gib"] = sum(v.numel() * v.element_size() for v in
                                   api.client_table.values()) / 2 ** 30
        written = [f"state {f}" for f in ZOO_STATE.get(alg, ())]
        if "table_gib" in rec:
            written.append(f"{rec['table_rows_written']} table rows of a "
                           f"{rec['table_gib']:.3f} GiB table")
        say("zoo", f"(a) {alg}: {rec['vs_fedavg']:.2f}x FedAvg's "
                   f"{fedavg_s:.4f} s/round; written: "
                   f"{', '.join(written) or 'no state beyond the params'}")
        out["femnist_cnn"][alg] = rec
        del api

    # (b) card ≡ CPU on small f32 rounds from the same weights, TF32 off
    for alg, name, over in ZOO_CARD_VS_CPU:
        args = sp_args(fedml_tpu_torch, dataset="synthetic", num_classes=10,
                       input_shape=(28, 28, 1), train_size=512,
                       test_size=128, model=name, client_num_in_total=8,
                       client_num_per_round=4, batch_size=16,
                       learning_rate=0.05, partition_method="hetero",
                       partition_alpha=0.3, momentum=0.9, random_seed=3,
                       federated_optimizer=alg, **over)
        ds, n_out = data.load(args)
        card, cpu = [FedAvgAPI(args, d, ds, model.create(args, n_out))
                     for d in ("cuda", "cpu")]
        if torch.backends.cudnn.allow_tf32 or \
                torch.backends.cuda.matmul.allow_tf32:
            fail("zoo (b) get_device left TF32 on")
        for r in range(2):
            card.train_one_round(r)
            cpu.train_one_round(r)
        got, ref = state_tensors(card), state_tensors(cpu)
        if set(got) != set(ref):
            fail(f"zoo (b) {alg}: state fields differ")
        tag = (alg + ("_sgd" if over.get("server_optimizer") == "sgd"
                      else "") + "/" + name)
        c_tol = (SCAFFOLD_CNN_C_TOL if tag == "scaffold/cnn_web" else 1e-6)
        errs = {"params": 0.0, "state": 0.0}
        for k, v in ref.items():
            part = "params" if k.startswith("global_params/") else "state"
            errs[part] = max(errs[part], max_err(got[k].cpu(), v))
        say("zoo", f"(b) {tag}: 2 f32 rounds card vs CPU, params max abs "
                   f"diff {errs['params']:.2e} (tol 1e-6), "
                   f"{len(ref) - len(card.state.global_params)} state and "
                   f"table tensors {errs['state']:.2e} (tol {c_tol:g})")
        if not (errs["params"] <= 1e-6 and errs["state"] <= c_tol):
            fail(f"zoo (b) {tag}: card and CPU disagree ({errs})")
        out["card_vs_cpu"][tag] = errs

    # (c) the engines through run_simulation
    for tag, over in ZOO_ENGINES:
        args = sp_args(fedml_tpu_torch, **dict(SP_FEMNIST_CNN, comm_round=2,
                                               **over))
        t0 = time.time()
        params = fedml_tpu_torch.run_simulation(backend="sp", args=args)
        torch.cuda.synchronize()
        dt = time.time() - t0
        ds, n_out = data.load(args)
        m = model.create(args, n_out)
        start = m.init(rng.purpose_key(rng.root_key(args.random_seed),
                                       "init"))
        loss, acc = LocalTrainer(m, args, "fedavg").evaluate(
            params, *ds.test_batches())
        moved = all(not torch.equal(v.cpu(), start[k])
                    for k, v in params.items())
        finite = all(torch.isfinite(v).all() for v in params.values())
        say("zoo", f"(c) {tag} via run_simulation: 2 rounds in {dt:.2f} s "
                   f"({ds.num_clients} clients); test loss {loss:.4f}, "
                   f"accuracy {acc:.4f}; params moved {moved} [{smi}]")
        if not (moved and finite and loss == loss and
                abs(loss) < float("inf")):
            fail(f"zoo (c) {tag}: loss {loss}, params moved {moved}, "
                 f"finite {finite}")
        out["engines"][tag] = {"seconds": dt, "test_loss": loss,
                               "test_acc": acc}
    return out


#: host-side CUDA runtime calls that put work on the card (kernel and
#: graph launches, copies, fills), as torch.profiler names them
HOST_LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch",
                     "cudaMemcpy", "cudaMemset")


def sync_time(torch, fn):
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return time.time() - t0, out


def run_unfused(api, start, stop):
    return [api.train_one_round(r) for r in range(start, stop)]


def run_blocks(api, start, stop):
    out, r = [], start
    while r < stop:
        k, ms = api.train_block(r)
        out.append(ms)
        r += k
    return out


def block_losses(torch, blocks):
    return torch.cat([ms["train_loss"].reshape(-1, ms["train_loss"].shape[-1])
                      for ms in blocks], dim=-1).cpu()


def fused_vs_unfused(torch, fedml_tpu_torch, phase, cfg, k, rounds, timed,
                     smi):
    """The same ``rounds`` rounds unfused and in blocks of ``k`` from the
    same seed.  Each engine warms up for the first block's ``k`` rounds
    (where the fused one captures its graphs); the next ``timed`` rounds
    (whole blocks) are timed, ended by a synchronise; the rest (a ragged
    tail) runs untimed.  Per-round losses, params, server state and table
    rows are held fused ≡ unfused to ``FUSED_TOL``; then each engine's
    launches a round are counted on a profiled pass over the first
    block's rounds (the state goes on: a counting run only)."""
    rec = {"round_block": k, "rounds": rounds, "timed_rounds": timed}
    apis = {}
    for mode, rb in (("unfused", 1), ("fused", k)):
        api = apis[mode] = build_sp(sp_args(
            fedml_tpu_torch, **dict(cfg, comm_round=rounds, round_block=rb)))
        run = run_unfused if rb == 1 else run_blocks
        torch.cuda.reset_peak_memory_stats()
        t_warm, first = sync_time(torch, lambda: run(api, 0, k))
        dt, mid = sync_time(torch, lambda: run(api, k, k + timed))
        last = run(api, k + timed, rounds)
        if rb == 1:
            losses = torch.stack([m["train_loss"] for m in first + mid
                                  + last])
            allocated = first[0]["allocated_steps"]
        else:
            losses = block_losses(torch, first + mid + last).reshape(-1)
        torch.cuda.synchronize()
        rec[mode] = {"s_per_round": dt / timed, "warm_s": t_warm,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                     "losses": losses.cpu().tolist()}
    u, f = apis["unfused"], apis["fused"]
    got, ref = state_tensors(f), state_tensors(u)
    err = max(max_err(got[key], v) for key, v in ref.items())
    loss_err = max(abs(a - b) for a, b in zip(rec["fused"]["losses"],
                                              rec["unfused"]["losses"]))
    say("fusion", f"{phase}: fused vs unfused after {rounds} rounds: params, "
                  f"state and table max abs diff {err:.2e}, per-round losses "
                  f"{loss_err:.2e} (tol {FUSED_TOL:g}) [{smi}]")
    if not (err <= FUSED_TOL and loss_err <= FUSED_TOL):
        fail(f"{phase}: fused and unfused rounds disagree ({err:.2e}, "
             f"{loss_err:.2e} > {FUSED_TOL:g})")
    n_prof = min(k, 2)
    rec["unfused"].update(profile_rounds(
        torch, lambda: run_unfused(u, 0, n_prof), n_prof))
    rec["fused"].update(profile_rounds(torch, lambda: run_blocks(f, 0, k),
                                       k))
    rec["fused"]["graphs_captured"] = f._block_fn.captures
    if not f._block_fn.captures:
        fail(f"{phase}: the fused rounds captured no CUDA graph")
    rec.update(max_abs_err=err, loss_max_abs_err=loss_err,
               allocated_steps=allocated,
               fused_speedup=rec["unfused"]["s_per_round"]
               / rec["fused"]["s_per_round"])
    uu, ff = rec["unfused"], rec["fused"]
    say("fusion", f"{phase}: K {k}, {timed} timed rounds after a warm block "
                  f"of {k} ({rounds} in all): unfused "
                  f"{uu['s_per_round']:.4f} s/round, fused "
                  f"{ff['s_per_round']:.4f} s/round (speedup "
                  f"{rec['fused_speedup']:.2f}x; warm block "
                  f"{uu['warm_s']:.2f} / {ff['warm_s']:.2f} s, "
                  f"{ff['graphs_captured']} graph(s) captured); host launch "
                  f"calls a round {uu['host_launches']:.0f} unfused, "
                  f"{ff['host_launches']:.0f} fused; device kernels a round "
                  f"{uu['device_kernels']:.0f} / {ff['device_kernels']:.0f}; "
                  f"peak {uu['peak_gib']:.3f} / {ff['peak_gib']:.3f} GiB "
                  f"[{smi}]")
    return rec


#: fused ≡ unfused on the card (in practice bitwise: the device policy
#: keeps cuDNN deterministic, and a graph replays the eager round's kernels)
FUSED_TOL = 1e-6
#: phase 7 (e): the rounds of the two runs with cuDNN free (reported)
FREE_ROUNDS = 4
#: phase 7 (d): the population's client learning rates; member 0 runs the
#: static rate, so it is phase 7 (b)'s FedAvg run
POP_CLIENT_LR = [0.06, 0.03, 0.1, 0.02]
#: phase 7 (d): member 0 ≡ the single run on cnn_web, whose rounds do not
#: amplify rounding (see fusion_phase)
POP_SMALL = dict(dataset="synthetic", num_classes=10, input_shape=(28, 28, 1),
                 train_size=512, test_size=128, model="cnn_web",
                 client_num_in_total=8, client_num_per_round=4,
                 batch_size=16, learning_rate=0.05, partition_method="hetero",
                 partition_alpha=0.3, momentum=0.9, random_seed=3,
                 comm_round=3)


#: phase 7 (c): ``tests/test_e2e_sp.py::test_cohort_bucketing_matches_
#: unbucketed``'s skewed split
BUCKET_SMALL = dict(dataset="synthetic", num_classes=4, input_shape=(10,),
                    train_size=1200, test_size=120, model="lr",
                    client_num_in_total=24, client_num_per_round=12,
                    comm_round=4, batch_size=8, learning_rate=0.2,
                    partition_method="hetero", partition_alpha=0.15,
                    random_seed=5)


def check_policy(torch, phase):
    b = torch.backends
    if b.cudnn.allow_tf32 or b.cuda.matmul.allow_tf32 or \
            not b.cudnn.deterministic or b.cudnn.benchmark:
        fail(f"{phase}: TF32 on, or cuDNN not deterministic, or benchmark "
             "mode on")


def fusion_phase(torch, fedml_tpu_torch, smi):
    """Phase 7."""
    from fedml_tpu_torch.core import federated
    out = {}
    # the device policy (get_device): TF32 off, deterministic cuDNN
    build_sp(sp_args(fedml_tpu_torch, **dict(SP_LR_BENCH, comm_round=1)))
    check_policy(torch, "fusion")
    # (a) lr at bench.py --fused's shape: 256 clients a round, K 1 and 8
    out["lr_bench"] = fused_vs_unfused(
        torch, fedml_tpu_torch, "(a) lr", SP_LR_BENCH, 8, 17, 8, smi)
    # (b) the FEMNIST CNN, FedAvg and SCAFFOLD (its table in the graph):
    # a warm block, 8 timed rounds, a ragged tail of 1 (9 after the warm)
    for alg in ("fedavg", "scaffold"):
        out[f"femnist_cnn_{alg}"] = fused_vs_unfused(
            torch, fedml_tpu_torch, f"(b) FEMNIST CNN {alg}",
            dict(SP_FEMNIST_CNN, federated_optimizer=alg), 8, 17, 8, smi)

    # (c) cohort bucketing on the FEMNIST CNN at a skewed split (α 0.3);
    # the JAX test's own skewed lr split
    t_c = time.time()
    rec = {}
    for alpha in (0.3,):
        for mode, on in (("unbucketed", False), ("bucketed", True)):
            api = build_sp(sp_args(fedml_tpu_torch, **dict(
                SP_FEMNIST_CNN, comm_round=3, partition_alpha=alpha,
                cohort_bucketing=on)))
            torch.cuda.reset_peak_memory_stats()
            api.train_one_round(0)
            dt, ms = sync_time(torch, lambda: run_unfused(api, 1, 3))
            loss, acc = api.evaluate()
            rec[f"femnist_a{alpha}_{mode}"] = {
                "s_per_round": dt / 2, "allocated_steps": [
                    int(m["allocated_steps"]) for m in ms],
                "total_steps": [float(m["total_steps"]) for m in ms],
                "test_loss": loss, "test_acc": acc,
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        u, b = (rec[f"femnist_a{alpha}_{m}"]
                for m in ("unbucketed", "bucketed"))
        say("fusion", f"(c) bucketing, FEMNIST CNN FedAvg, α {alpha}: "
                      f"unbucketed {u['s_per_round']:.4f} s/round, bucketed "
                      f"{b['s_per_round']:.4f} s/round; allocated steps "
                      f"{u['allocated_steps']} vs {b['allocated_steps']}, "
                      f"real {u['total_steps']} vs {b['total_steps']}; test "
                      f"loss {u['test_loss']:.6f} vs {b['test_loss']:.6f} "
                      f"(reported); peak {u['peak_gib']:.3f} / "
                      f"{b['peak_gib']:.3f} GiB [{smi}]")
        # a bucket's cohort pads to a power of two; on the skewed split
        # every timed round allocates fewer steps
        if u["total_steps"] != b["total_steps"] or not all(
                x < y for x, y in zip(b["allocated_steps"],
                                      u["allocated_steps"])):
            fail(f"(c) α {alpha}: bucketed rounds do not do the unbucketed "
                 f"rounds' real work over fewer steps: {u}, {b}")
    # the eval bar on the JAX test's own split (lr, 24 clients, α 0.15),
    # whose rounds do not amplify rounding as the CNN's do
    small = {}
    for mode, on in (("unbucketed", False), ("bucketed", True)):
        api = small[mode] = build_sp(sp_args(fedml_tpu_torch, **dict(
            BUCKET_SMALL, cohort_bucketing=on)))
        small[mode + "_m"] = run_unfused(api, 0, 4)
    (l0, a0), (l1, a1) = (small[m].evaluate()
                          for m in ("unbucketed", "bucketed"))
    steps_eq = all(float(x["total_steps"]) == float(y["total_steps"]) and
                   y["allocated_steps"] < x["allocated_steps"] for x, y in
                   zip(small["unbucketed_m"], small["bucketed_m"]))
    rec["lr_skewed"] = {"test_loss_diff": abs(l0 - l1),
                        "test_acc_diff": abs(a0 - a1)}
    say("fusion", f"(c) bucketing on the JAX test's split (lr, α 0.15, 4 "
                  f"rounds): test loss {l0:.6f} vs {l1:.6f} (tol 2e-4), "
                  f"accuracy {a0:.4f} vs {a1:.4f} (tol 2e-2); same real "
                  f"steps over fewer allocated: {steps_eq} [{smi}]")
    if not (steps_eq and abs(l0 - l1) < 2e-4 and abs(a0 - a1) < 2e-2):
        fail("(c) bucketed lr rounds disagree with the unbucketed ones")
    rec["seconds"] = time.time() - t_c
    say("fusion", f"(c) took {rec['seconds']:.1f} s")
    out["bucketing"] = rec

    # (d) a client-lr population of 4 on the FEMNIST CNN, unfused and fused
    # at K 4 over 9 rounds (4 + 4 + 1), beside (b)'s single FedAvg run
    rec = {"client_lr": POP_CLIENT_LR}
    pops = {}
    for mode, rb in (("unfused", 1), ("fused", 4)):
        api = pops[mode] = build_sp(sp_args(fedml_tpu_torch, **dict(
            SP_FEMNIST_CNN, comm_round=9, round_block=rb,
            population_axes={"client_lr": POP_CLIENT_LR})))
        run = run_unfused if rb == 1 else run_blocks
        torch.cuda.reset_peak_memory_stats()
        t_warm, _ = sync_time(torch, lambda: run(api, 0, 4))
        dt, _ = sync_time(torch, lambda: run(api, 4, 8))
        run(api, 8, 9)
        rec[mode] = {"s_per_round": dt / 4, "s_per_member_round":
                     dt / 4 / len(POP_CLIENT_LR), "warm_s": t_warm,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    err_fu = max(max_err(pops["fused"].state.global_params[k], v)
                 for k, v in pops["unfused"].state.global_params.items())
    # member 0 runs (b)'s single FedAvg rounds, batched with three other
    # members: the grouped convolutions sum in another order, and the
    # FEMNIST CNN's ReLU/max-pool sites amplify that chaotically within a
    # round, so there the difference is reported; the 1e-6 bar is held on
    # cnn_web's small rounds
    single = build_sp(sp_args(fedml_tpu_torch, **dict(SP_FEMNIST_CNN,
                                                      comm_round=9)))
    run_unfused(single, 0, 9)
    m0 = federated.population_member(pops["unfused"].state.global_params, 0)
    femnist_m0 = max(max_err(m0[k], v)
                     for k, v in single.state.global_params.items())
    small = {}
    for tag, over in (("single", {}), ("population", dict(
            population_axes={"client_lr": [0.05, 0.02, 0.1, 0.01]}))):
        api = small[tag] = build_sp(sp_args(fedml_tpu_torch,
                                            **dict(POP_SMALL, **over)))
        run_unfused(api, 0, 3)
    m0 = federated.population_member(small["population"].state.global_params,
                                     0)
    err_m0 = max(max_err(m0[k], v)
                 for k, v in small["single"].state.global_params.items())
    single_s = out["femnist_cnn_fedavg"]["unfused"]["s_per_round"]
    rec.update(member0_max_abs_err=err_m0, fused_max_abs_err=err_fu,
               femnist_member0_max_abs_err=femnist_m0,
               single_s_per_round=single_s)
    say("fusion", f"(d) population of {len(POP_CLIENT_LR)} (client_lr "
                  f"{POP_CLIENT_LR}), FEMNIST CNN FedAvg, 4 timed rounds "
                  f"after 4: unfused {rec['unfused']['s_per_round']:.4f} "
                  f"s/round ({rec['unfused']['s_per_member_round']:.4f} a "
                  f"member), fused K 4 {rec['fused']['s_per_round']:.4f} "
                  f"s/round ({rec['fused']['s_per_member_round']:.4f} a "
                  f"member); the single run (b) {single_s:.4f} s/round; peak "
                  f"{rec['unfused']['peak_gib']:.3f} / "
                  f"{rec['fused']['peak_gib']:.3f} GiB [{smi}]")
    say("fusion", f"(d) fused vs unfused population after 9 rounds "
                  f"{err_fu:.2e} (tol {FUSED_TOL:g}); member 0 vs the single "
                  f"run: cnn_web 3 rounds {err_m0:.2e} (tol {FUSED_TOL:g}), "
                  f"FEMNIST 9 rounds {femnist_m0:.2e} (reported) [{smi}]")
    if not (err_m0 <= FUSED_TOL and err_fu <= FUSED_TOL):
        fail(f"(d) population disagrees: member 0 {err_m0:.2e}, fused "
             f"{err_fu:.2e}")
    out["population"] = rec

    # (e) why the policy keeps cuDNN deterministic: the same 4 FEMNIST
    # rounds twice with cuDNN free to pick its algorithms (reported), then
    # the policy over (d)'s 9 rounds (held bitwise to (d)'s single run)
    runs = []
    for det, n in ((False, FREE_ROUNDS), (False, FREE_ROUNDS), (True, 9)):
        torch.backends.cudnn.deterministic = det
        api = build_sp(sp_args(fedml_tpu_torch, **dict(SP_FEMNIST_CNN,
                                                       comm_round=n)))
        torch.backends.cudnn.deterministic = det   # get_device set it
        run_unfused(api, 0, n)
        runs.append(api.state.global_params)
    check_policy(torch, "fusion (e)")
    free = max(max_err(runs[0][k], v) for k, v in runs[1].items())
    pinned = max(max_err(runs[2][k], v) for k, v in single.state
                 .global_params.items())
    say("fusion", f"(e) two runs of the same {FREE_ROUNDS} FEMNIST rounds: "
                  f"{free:.2e} apart with cuDNN free to pick its algorithms; "
                  f"9 rounds {pinned:.2e} apart under the policy "
                  f"(deterministic) [{smi}]")
    if pinned != 0.0:
        fail(f"(e) deterministic cuDNN runs differ by {pinned:.2e}")
    out["reproducibility"] = {"cudnn_free_max_abs_err": free,
                              "cudnn_deterministic_max_abs_err": pinned}
    return out


#: phase 8: the realtext_docs row of tools/run_baseline_rows.py, the text
#: transformer at its full default width (dim 256, 4 layers, 8 heads, FFN
#: 512) on the committed real text shard; 24 fused rounds (the accuracy
#: bar) and 8 unfused (held bitwise to the fused run's first block), then
#: 1 more unfused round and a whole block of 8 fused under the profiler (a
#: 2-round tail block under the profiler read 383 of the 384 K1–K3 a round
#: on one H100)
TEXT_REALTEXT = dict(
    dataset="realtext", model="text_transformer", seq_len=128,
    vocab_size=8192, data_cache_dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "data_shards",
        "realtext"),
    client_num_in_total=10, client_num_per_round=5, batch_size=16,
    learning_rate=3e-3, client_optimizer="adam", clip_grad_norm=1.0,
    partition_method="hetero", partition_alpha=0.5, sp_client_mode="vmap",
    comm_round=32)
TEXT_ROUNDS, TEXT_BLOCK, TEXT_ACC_BAR = 24, 8, 0.6
#: the unfused run's rounds: the fused run's first block, which it must
#: equal bitwise (the fused rounds go on to the accuracy bar)
TEXT_UNFUSED_ROUNDS = 8
#: phase 8 (e): tests/test_model_zoo_ext.py's text config (seq 32, vocab
#: 512, dim 64, 2 layers, 4 heads), 2 SGD rounds card vs CPU
TEXT_SMALL = dict(dataset="20news", model="distilbert", seq_len=32,
                  vocab_size=512, model_dim=64, model_layers=2,
                  model_heads=4, model_ffn_dim=128, text_class_signal=0.5,
                  text_keyword_width=1.0, train_size=600, test_size=120,
                  client_num_in_total=6, client_num_per_round=3,
                  batch_size=20, learning_rate=0.1, partition_method="homo",
                  comm_round=2)
TEXT_CARD_CPU_TOL = 1e-5
#: phase 9: the cifar100_resnet18 row of tools/run_baseline_rows.py
#: (FedProx μ 0.1) at full width on the port's synthetic CIFAR-100
#: stand-in (50,000 / 10,000)
RESNET_CIFAR100 = dict(dataset="cifar100", model="resnet18_gn",
                       federated_optimizer="FedProx", fedprox_mu=0.1,
                       client_num_in_total=32, client_num_per_round=4,
                       batch_size=20, learning_rate=0.05,
                       partition_method="hetero", partition_alpha=0.5,
                       comm_round=3)


def profile_rounds(torch, run, rounds):
    """``run()`` (``rounds`` rounds) under ``torch.profiler``: host launch
    calls and device kernels a round, the device's busy seconds a round
    (the union of its kernels' intervals), and the flash-attention
    kernels' count and device seconds a round.  CUDA activity only: it
    records the runtime's launch calls as well as the kernels, and leaves
    out the aten operators, which took a 10^5-launch LSTM round ~100 s to
    read back (the counts are the same either way)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.time()
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    wall = time.time() - t0
    host = dev = flash = 0
    flash_us = 0.0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dev += ev.count
            if "flash_" in ev.key:
                flash += ev.count
                flash_us += getattr(ev, "self_device_time_total", 0) or 0
        elif ev.key.startswith(HOST_LAUNCH_CALLS):
            host += ev.count
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy = busy_us / 1e6 / rounds
    return {"host_launches": host / rounds, "device_kernels": dev / rounds,
            "profiled_s_per_round": wall / rounds, "busy_s": busy,
            "flash_kernels": flash / rounds,
            "flash_device_s": flash_us / 1e6 / rounds,
            "flash_share_of_busy": flash_us / 1e6 / rounds / busy
            if busy else None}


def text_phase(torch, fedml_tpu_torch, att, smi):
    """Phase 8."""
    from fedml_tpu_torch import data, model
    from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI

    out = {}
    rounds, k = TEXT_ROUNDS, TEXT_BLOCK
    apis = {}
    for mode, rb in (("unfused", 1), ("fused", k)):
        t0 = time.time()
        api = apis[mode] = build_sp(sp_args(
            fedml_tpu_torch, **dict(TEXT_REALTEXT, round_block=rb)))
        mod = api.model.module
        if (mod.tok_embed.weight.shape, mod.n_layers,
                mod.layer_0.n_heads, mod.layer_0.ff_up.weight.shape[0]) != \
                ((8192, 256), 4, 8, 512):
            fail("(a) not the text model at its full width")
        n_params = sum(v.numel() for v in api.state.global_params.values())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rec = {"round_block": rb, "build_s": time.time() - t0}
        if rb == 1:
            # the main path, the kernels' counts zeroed just before it and
            # read just after: once per layer per step for the whole cohort
            att.reset_launch_counts()
            seconds, losses, steps, samples = [], [], 0, []
            for r in range(TEXT_UNFUSED_ROUNDS):
                dt, m = sync_time(torch, lambda: api.train_one_round(r))
                seconds.append(dt)
                losses.append(float(m["train_loss"]))
                steps += int(m["allocated_steps"]) // api.clients_per_round
                samples.append(float(m["total_steps"]) * api.batch_size)
            rec["test_loss"], rec["test_acc"] = api.evaluate()
            torch.cuda.synchronize()
            launches = {f.__name__.replace("flash_attention", "flash"):
                        f.launches for f in att.KERNELS}
            layers, n_eval = mod.n_layers, api._test[0].shape[0]
            expect = {"flash_fwd": layers * (steps + n_eval),
                      "flash_bwd_dq": layers * steps,
                      "flash_bwd_dkv": layers * steps}
            say("text", f"(a) {n_params:,} parameters; unfused "
                        f"{TEXT_UNFUSED_ROUNDS} rounds: {steps} padded steps of 5 clients × 16 "
                        f"sequences, {n_eval} eval batches; launches "
                        f"{launches}, expected {expect} (once per layer per "
                        f"step for the whole cohort, K1 also per eval "
                        f"batch)")
            if launches != expect:
                fail(f"(a) launch counts {launches} != expected {expect}")
            out["launches"] = launches
            rec.update(s_per_round=sum(seconds[1:]) / (len(seconds) - 1),
                       samples_per_s=sum(samples[1:]) / sum(seconds[1:]),
                       first_round_s=seconds[0], round_losses=losses)
        else:
            blocks, seconds = [], []
            for r in range(0, rounds, k):
                dt, ms = sync_time(torch, lambda: api.train_block(r))
                seconds.append(dt)
                blocks.append(ms[1])
                if r + k == TEXT_UNFUSED_ROUNDS:
                    snap = {key: v.clone()
                            for key, v in state_tensors(api).items()}
            rec["test_loss"], rec["test_acc"] = api.evaluate()
            real = sum(float(b["total_steps"].sum()) for b in blocks[1:])
            rec.update(s_per_round=sum(seconds[1:]) / (rounds - k),
                       samples_per_s=real * api.batch_size
                       / sum(seconds[1:]),
                       warm_block_s=seconds[0],
                       round_losses=block_losses(torch, blocks)
                       .reshape(-1).tolist(),
                       graphs_captured=api._block_fn.captures)
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        n_r = TEXT_UNFUSED_ROUNDS if rb == 1 else rounds
        say("text", f"(b) {mode}: {rec['s_per_round']:.4f} s/round after "
                    f"the first {'round' if rb == 1 else 'block'} "
                    f"({rec['samples_per_s']:.0f} real samples/s), test "
                    f"loss {rec['test_loss']:.4f}, accuracy "
                    f"{rec['test_acc']:.4f} after {n_r} rounds"
                    f"{'' if rb == 1 else f' (bar {TEXT_ACC_BAR})'}, peak "
                    f"{rec['peak_gib']:.3f} GiB [{smi}]")
        if rb > 1 and not rec["test_acc"] > TEXT_ACC_BAR:
            fail(f"(b) {mode}: realtext accuracy {rec['test_acc']:.4f} "
                 f"after {rounds} rounds")
        out[mode] = rec
    u, f = apis["unfused"], apis["fused"]
    if not f._block_fn.captures:
        fail("(c) the fused text rounds captured no CUDA graph")
    ref = state_tensors(u)
    err = max(max_err(snap[key], v) for key, v in ref.items())
    del snap
    loss_err = max(abs(a - b) for a, b in zip(
        out["fused"]["round_losses"], out["unfused"]["round_losses"]))
    say("text", f"(c) fused (K {k}, {f._block_fn.captures} graph(s)) vs "
                f"unfused after {TEXT_UNFUSED_ROUNDS} rounds: params and "
                f"server state "
                f"max abs diff {err:.2e}, per-round losses "
                f"{loss_err:.2e} (tol {FUSED_TOL:g})")
    if not (err <= FUSED_TOL and loss_err <= FUSED_TOL):
        fail(f"(c) fused and unfused text rounds disagree ({err:.2e}, "
             f"{loss_err:.2e})")
    out.update(fused_max_abs_err=err, fused_loss_max_abs_err=loss_err)
    # (d) a profiled pass of each engine (the state goes on: counting only)
    n_u = TEXT_UNFUSED_ROUNDS
    out["unfused"].update(profile_rounds(
        torch, lambda: run_unfused(u, n_u, n_u + 1), 1))
    out["fused"].update(profile_rounds(
        torch, lambda: run_blocks(f, rounds, rounds + k), k))
    for mode in ("unfused", "fused"):
        rec = out[mode]
        say("text", f"(d) {mode}: {rec['host_launches']:.0f} host launch "
                    f"calls and {rec['device_kernels']:.0f} device kernels "
                    f"a round ({rec['flash_kernels']:.0f} of them K1–K3); "
                    f"device busy {rec['busy_s']:.4f} s of "
                    f"{rec['profiled_s_per_round']:.4f} s a profiled round "
                    f"({100 * rec['busy_s'] / rec['profiled_s_per_round']:.1f}"
                    f"%), K1–K3 {rec['flash_device_s']:.4f} s "
                    f"({100 * (rec['flash_share_of_busy'] or 0):.1f}% of "
                    f"busy) [{smi}]")
    if out["fused"]["flash_kernels"] < 3 * mod.n_layers:
        fail("(d) the fused text rounds ran no flash-attention kernel "
             "inside their graphs")
    del apis, u, f

    # (e) card ≡ CPU on the small config from the same weights (both draw
    # them on the CPU from the seed), TF32 off
    args = sp_args(fedml_tpu_torch, **TEXT_SMALL)
    ds, n_out = data.load(args)
    card, cpu = [FedAvgAPI(args, d, ds, model.create(args, n_out))
                 for d in ("cuda", "cpu")]
    for r in range(TEXT_SMALL["comm_round"]):
        card.train_one_round(r)
        cpu.train_one_round(r)
    err = max(max_err(card.state.global_params[key].cpu(), v)
              for key, v in cpu.state.global_params.items())
    say("text", f"(e) small config, 2 SGD rounds card vs CPU from the same "
                f"weights: params max abs diff {err:.2e} (tol "
                f"{TEXT_CARD_CPU_TOL:g})")
    if not err <= TEXT_CARD_CPU_TOL:
        fail(f"(e) card and CPU disagree on the small text rounds "
             f"({err:.2e})")
    out["card_vs_cpu"] = err
    return out


def resnet_phase(torch, fedml_tpu_torch, smi):
    """Phase 9."""
    t0 = time.time()
    api = build_sp(sp_args(fedml_tpu_torch, **RESNET_CIFAR100))
    p = api.state.global_params
    if (tuple(p["Conv_0.weight"].shape), tuple(p["Dense_0.weight"].shape)) \
            != ((64, 3, 3, 3), (100, 512)):
        fail("(a) not resnet18_gn at full width on 100 classes")
    n_params = sum(v.numel() for v in p.values())
    say("resnet", f"resnet18_gn, {n_params:,} parameters, FedProx μ 0.1, "
                  f"{api.dataset.provenance} CIFAR-100 "
                  f"{api.dataset.train_data_num:,} / "
                  f"{api.dataset.test_data_num:,}, 32 clients (α 0.5), 4 a "
                  f"round, batch 20; built in {time.time() - t0:.1f} s")
    rec = timed_rounds(torch, api, "resnet", 2, smi)
    rec["n_params"] = n_params
    return rec


#: phase 10 (a): the FedAvg paper's Shakespeare settings (100 clients, 10
#: a round, batch 10, lr 1.47, one epoch) with the char-LSTM at its full
#: width on the synthetic Markov-chain stand-in at the reference
#: cardinality (16,000 / 2,000 windows of 80; the LM loader splits homo)
ZOO_SHAKESPEARE_RNN = dict(dataset="shakespeare", model="rnn",
                           client_num_in_total=100,
                           client_num_per_round=10, batch_size=10,
                           learning_rate=1.47, partition_method="homo",
                           sp_client_mode="vmap")
#: phase 10 (b): Stack Overflow next-word prediction at full width (vocab
#: 10,004, seq 20) on the synthetic stand-in (50,000 / 5,000)
ZOO_STACKOVERFLOW_NWP = dict(dataset="stackoverflow_nwp",
                             model="rnn_stackoverflow",
                             client_num_in_total=100,
                             client_num_per_round=10, batch_size=16,
                             learning_rate=1.0, partition_method="homo",
                             sp_client_mode="vmap")
#: phase 10 (c): tag prediction at the reference's widths (500 tags, 10,000
#: features: a 5.0 M-parameter LR) at the loader's cap of 5,000 / 500
ZOO_TAGPRED = dict(dataset="stackoverflow_lr", model="lr", tag_count=500,
                   feature_dim=10000, client_num_in_total=100,
                   client_num_per_round=10, batch_size=16,
                   learning_rate=0.5, partition_method="homo")
#: phase 10 (d): synthetic tabular LR on uci (14 features, 2 classes,
#: 30,000 / 5,000)
ZOO_UCI = dict(dataset="uci", model="lr", input_shape=(14,),
               client_num_in_total=100, client_num_per_round=10,
               batch_size=10, learning_rate=0.1, partition_method="hetero",
               partition_alpha=0.5)
#: phase 10 (e): the vision models on the synthetic CIFAR-10 stand-in at
#: 32 px, train_size cut to 2,000 of 50,000 (test 500 of 10,000)
ZOO_VISION = dict(dataset="cifar10", train_size=2000, test_size=500,
                  client_num_in_total=20, client_num_per_round=4,
                  batch_size=20, learning_rate=0.05,
                  partition_method="homo")
#: phase 10 (f): card ≡ CPU at small sizes, 2 f32 rounds from the same
#: weights (the CPU tests' configurations)
ZOO_CARD_CPU = {
    "rnn": dict(model="rnn", dataset="shakespeare", seq_len=10,
                train_size=120, test_size=24, batch_size=5,
                learning_rate=0.5),
    "rnn_stackoverflow": dict(model="rnn_stackoverflow",
                              dataset="stackoverflow_nwp", seq_len=6,
                              train_size=64, test_size=16, batch_size=5,
                              learning_rate=0.5),
    "lr_tag_prediction": dict(model="lr", dataset="stackoverflow_lr",
                              train_size=200, test_size=40, tag_count=20,
                              feature_dim=50, batch_size=8,
                              learning_rate=0.5),
    "mobilenet": dict(model="mobilenet", dataset="cifar10", train_size=32,
                      test_size=8, batch_size=4, learning_rate=0.05,
                      partition_method="homo"),
}
ZOO_CARD_CPU_TOL = 1e-6
#: phase 10 (a)/(b): rounds a block (and the unfused rounds before it)
LM_BLOCK = 4


def finite(*xs):
    return all(x == x and abs(x) < float("inf") for x in xs)


def lm_rounds(torch, fedml_tpu_torch, tag, cfg, k, smi):
    """Phase 10 (a)/(b): ``k`` unfused rounds (round 0 warm), then blocks
    of ``k`` as CUDA graphs (the first warm, where the graphs are
    captured; the second timed); fused ≡ unfused after the first block;
    one more round of each under the profiler (the fused one a tail block
    of one round, which replays the same graph: a block of ``k`` rounds of
    ~10^5 kernels each takes minutes to read back)."""
    rec = {"round_block": k}
    t0 = time.time()
    steps = rec["step_s"] = {}   # where the phase's seconds go

    def step(name):
        nonlocal t0
        steps[name] = time.time() - t0
        t0 = time.time()

    u = build_sp(sp_args(fedml_tpu_torch, **dict(cfg, comm_round=k + 1)))
    check_policy(torch, "models")   # get_device set it
    n_params = sum(v.numel() for v in u.state.global_params.values())
    say("models", f"{tag}: {u.model.module.__class__.__name__}, "
                  f"{n_params:,} parameters, {u.dataset.provenance} "
                  f"{u.dataset.train_data_num:,} / "
                  f"{u.dataset.test_data_num:,} of seq "
                  f"{u.dataset.train_x.shape[1]}, "
                  f"{u.dataset.num_clients} clients, "
                  f"{u.clients_per_round} a round, batch {u.batch_size}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seconds, losses = [], []
    for r in range(k):
        dt, m = sync_time(torch, lambda: u.train_one_round(r))
        seconds.append(dt)
        losses.append(float(m["train_loss"]))
    step("unfused_build_and_rounds")
    test_loss, test_acc = u.evaluate()
    step("unfused_eval")
    rec["unfused"] = {"s_per_round": sum(seconds[1:]) / (k - 1),
                      "first_round_s": seconds[0], "round_losses": losses,
                      "allocated_steps": int(m["allocated_steps"]),
                      "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                      "test_loss": test_loss, "test_acc": test_acc}
    f = build_sp(sp_args(fedml_tpu_torch, **dict(cfg, comm_round=2 * k + 1,
                                                  round_block=k)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_warm, first = sync_time(torch, lambda: f.train_block(0))
    snap = {key: v.clone() for key, v in state_tensors(f).items()}
    dt, second = sync_time(torch, lambda: f.train_block(k))
    f_losses = block_losses(torch, [first[1], second[1]]).reshape(-1)
    step("fused_build_and_blocks")
    test_f = f.evaluate()
    step("fused_eval")
    rec["fused"] = {"s_per_round": dt / k, "warm_block_s": t_warm,
                    "round_losses": f_losses.tolist(),
                    "graphs_captured": f._block_fn.captures,
                    "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                    "test_loss": test_f[0], "test_acc": test_f[1]}
    err = max(max_err(snap[key], v) for key, v in state_tensors(u).items())
    loss_err = max(abs(a - b) for a, b in zip(losses, f_losses.tolist()))
    rec.update(n_params=n_params, fused_max_abs_err=err,
               fused_loss_max_abs_err=loss_err)
    step("compare")
    rec["unfused"].update(profile_rounds(
        torch, lambda: run_unfused(u, k, k + 1), 1))
    step("unfused_profile")
    rec["fused"].update(profile_rounds(
        torch, lambda: run_blocks(f, 2 * k, 2 * k + 1), 1))
    step("fused_profile")
    captures = f._block_fn.captures
    uu, ff = rec["unfused"], rec["fused"]
    for mode, rr in (("unfused", uu), ("fused", ff)):
        say("models", f"{tag} {mode}: {rr['s_per_round']:.4f} s/round "
                      f"(after a warm {'round' if mode == 'unfused' else 'block'}"
                      f"); {rr['host_launches']:.0f} host launch calls and "
                      f"{rr['device_kernels']:.0f} device kernels a round, "
                      f"device busy {rr['busy_s']:.4f} s of "
                      f"{rr['profiled_s_per_round']:.4f} s a profiled round "
                      f"({100 * rr['busy_s'] / rr['profiled_s_per_round']:.1f}"
                      f"%); peak {rr['peak_gib']:.3f} GiB; test loss "
                      f"{rr['test_loss']:.4f}, accuracy {rr['test_acc']:.4f} "
                      f"after {k if mode == 'unfused' else 2 * k} rounds "
                      f"(round 0's train loss {losses[0]:.4f}) [{smi}]")
    say("models", f"{tag}: seconds by step "
                  f"{ {n: round(v, 1) for n, v in steps.items()} }")
    say("models", f"{tag}: fused (K {k}, {ff['graphs_captured']} graph(s)) "
                  f"vs unfused after {k} rounds: params max abs diff "
                  f"{err:.2e}, per-round losses {loss_err:.2e} (tol "
                  f"{FUSED_TOL:g}); fused speedup "
                  f"{uu['s_per_round'] / ff['s_per_round']:.2f}x")
    if not finite(*losses, *f_losses.tolist(), test_loss, test_f[0]):
        fail(f"{tag}: a non-finite loss")
    if not (test_loss < losses[0] and test_f[0] < losses[0]):
        fail(f"{tag}: the test loss ({test_loss:.4f} unfused, "
             f"{test_f[0]:.4f} fused) did not fall below round 0's "
             f"{losses[0]:.4f}")
    if not (err <= FUSED_TOL and loss_err <= FUSED_TOL):
        fail(f"{tag}: fused and unfused rounds disagree ({err:.2e}, "
             f"{loss_err:.2e} > {FUSED_TOL:g})")
    if not ff["graphs_captured"] or captures != ff["graphs_captured"]:
        fail(f"{tag}: the fused rounds captured {captures} CUDA graph(s) "
             f"({ff['graphs_captured']} in the timed blocks)")
    return rec


def models_phase(torch, fedml_tpu_torch, smi):
    """Phase 10."""
    from fedml_tpu_torch import data, model
    from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI

    out = {}
    t0 = time.time()
    out["shakespeare_rnn"] = lm_rounds(torch, fedml_tpu_torch, "(a) rnn",
                                       ZOO_SHAKESPEARE_RNN, LM_BLOCK, smi)
    say("models", f"(a) took {time.time() - t0:.1f} s")
    t0 = time.time()
    out["stackoverflow_nwp"] = lm_rounds(
        torch, fedml_tpu_torch, "(b) rnn_stackoverflow",
        ZOO_STACKOVERFLOW_NWP, LM_BLOCK, smi)
    say("models", f"(b) took {time.time() - t0:.1f} s")

    # (c) tag prediction and (d) tabular LR: one warm round, then timed
    for key, tag, cfg, timed in (("tag_prediction", "(c) lr tag prediction",
                                  ZOO_TAGPRED, 3),
                                 ("uci", "(d) lr uci", ZOO_UCI, 3)):
        t0 = time.time()
        api = build_sp(sp_args(fedml_tpu_torch, **dict(cfg,
                                                       comm_round=timed + 1)))
        n_params = sum(v.numel() for v in api.state.global_params.values())
        say("models", f"{tag}: {api.model.task}, {n_params:,} parameters, "
                      f"{api.dataset.provenance} {api.dataset.train_x.shape}"
                      f" / {api.dataset.test_data_num:,}; built in "
                      f"{time.time() - t0:.1f} s")
        rec = out[key] = timed_rounds(torch, api, f"models {tag[:3]}", timed,
                                      smi)
        rec["n_params"] = n_params
        metric = "exact match" if api.model.task == "tag_prediction" \
            else "accuracy"
        say("models", f"{tag}: test {'BCE' if metric == 'exact match' else 'loss'}"
                      f" {rec['test_loss']:.4f}, {metric} "
                      f"{rec['test_acc']:.4f} (round 0's train loss "
                      f"{rec['round_losses'][0]:.4f})")
        if not rec["test_loss"] < rec["round_losses"][0]:
            fail(f"{tag}: the test loss did not fall below round 0's")
        del api

    # (e) one round of each vision model after a warm one
    out["vision"] = {}
    for name in ("vgg11", "mobilenet", "efficientnet"):
        t0 = time.time()
        api = build_sp(sp_args(fedml_tpu_torch, **dict(ZOO_VISION, model=name,
                                                       comm_round=2)))
        n_params = sum(v.numel() for v in api.state.global_params.values())
        say("models", f"(e) {name}: {n_params:,} parameters, CIFAR-10 "
                      f"stand-in cut to {api.dataset.train_data_num:,} / "
                      f"{api.dataset.test_data_num:,} of 50,000 / 10,000 "
                      f"at 32 px; built in {time.time() - t0:.1f} s")
        rec = out["vision"][name] = timed_rounds(torch, api,
                                                 f"models e {name}", 1, smi)
        rec["n_params"] = n_params
        del api

    # (f) card ≡ CPU at small sizes from the same weights, TF32 off
    out["card_vs_cpu"] = {}
    for tag, cfg in ZOO_CARD_CPU.items():
        args = sp_args(fedml_tpu_torch, **dict(
            dict(client_num_in_total=4, client_num_per_round=2,
                 comm_round=2, random_seed=0), **cfg))
        ds, n_out = data.load(args)
        card, cpu = [FedAvgAPI(args, d, ds, model.create(args, n_out))
                     for d in ("cuda", "cpu")]
        cpu.state = cpu.state.replace(global_params={
            k: v.cpu() for k, v in card.state.global_params.items()})
        for r in range(2):
            card.train_one_round(r)
            cpu.train_one_round(r)
        err = max(max_err(card.state.global_params[k].cpu(), v)
                  for k, v in cpu.state.global_params.items())
        (lc, ac), (lp, ap) = card.evaluate(), cpu.evaluate()
        say("models", f"(f) {tag}: 2 f32 rounds card vs CPU from the same "
                      f"weights, params max abs diff {err:.2e} (tol "
                      f"{ZOO_CARD_CPU_TOL:g}); test loss {lc:.6f} vs "
                      f"{lp:.6f}, accuracy {ac:.4f} vs {ap:.4f}")
        if not err <= ZOO_CARD_CPU_TOL:
            fail(f"(f) {tag}: card and CPU disagree ({err:.2e})")
        out["card_vs_cpu"][tag] = err
    return out


#: phase 11 (a)–(d): the four engines ``run_simulation`` dispatches, each at
#: the JAX package's default widths; data and rounds cut (PERF.md §4)
ENGINE_FEDNAS = dict(dataset="cifar10", model="darts",
                     federated_optimizer="FedNAS", train_size=2000,
                     test_size=500, client_num_in_total=10,
                     client_num_per_round=4, batch_size=16,
                     learning_rate=0.05)
ENGINE_FEDSEG = dict(dataset="fets2021", model="unet",
                     input_shape=(64, 64, 4), federated_optimizer="FedSeg",
                     client_num_in_total=10, client_num_per_round=4,
                     batch_size=8, learning_rate=0.1)
ENGINE_FEDGKT = dict(dataset="cifar10", model="lr",
                     federated_optimizer="FedGKT", train_size=2000,
                     test_size=500, client_num_in_total=4, batch_size=32,
                     learning_rate=0.03)
ENGINE_FEDGAN = dict(dataset="mnist", model="lr",
                     federated_optimizer="FedGAN", train_size=2000,
                     test_size=500, client_num_in_total=4,
                     client_num_per_round=2, batch_size=32,
                     learning_rate=2e-4)
#: phase 11 (e): split learning and the centralized baseline on the MNIST
#: stand-in cut to 2,000 / 500
ENGINE_MNIST = dict(dataset="mnist", model="lr", train_size=2000,
                    test_size=500, client_num_in_total=1,
                    partition_method="homo", batch_size=32,
                    learning_rate=0.1)
#: phase 11 (f): card ≡ CPU at the CPU tests' sizes, 2 f32 rounds from the
#: same weights (and FedGAN's same z)
ENGINE_CARD_CPU = {
    "fednas": dict(dataset="synthetic", num_classes=3, input_shape=(8, 8, 1),
                   model="darts", federated_optimizer="FedNAS",
                   client_num_in_total=4, client_num_per_round=2,
                   batch_size=4, train_size=64, test_size=16,
                   learning_rate=0.05, partition_method="homo"),
    "fedseg": dict(dataset="fets2021", input_shape=(16, 16, 1), model="unet",
                   federated_optimizer="FedSeg", client_num_in_total=4,
                   client_num_per_round=2, batch_size=4, train_size=48,
                   test_size=40, learning_rate=0.1, partition_method="homo"),
    "fedgkt": dict(dataset="synthetic", num_classes=3, input_shape=(8, 8, 1),
                   model="lr", federated_optimizer="FedGKT",
                   client_num_in_total=3, batch_size=8, train_size=96,
                   test_size=32, learning_rate=0.05, partition_method="homo"),
    "fedgan": dict(dataset="synthetic", num_classes=3, input_shape=(8, 8, 1),
                   model="lr", federated_optimizer="FedGAN",
                   client_num_in_total=4, client_num_per_round=2,
                   batch_size=8, train_size=96, test_size=32,
                   learning_rate=2e-4, partition_method="homo"),
}
#: card ≡ CPU limits: 1e-6, wider only where Adam normalises f32 rounding
#: noise into steps of up to lr (FedGKT's server head at 1e-3, FedGAN's
#: nets at 2e-4); the measured values are in PERF.md §6
ENGINE_CARD_CPU_TOL = {"fedgkt": 1e-4, "fedgan": 1e-4}
#: the engines' weights, by attribute (FedGKT's clients' nets come after
#: the first round)
ENGINE_WEIGHTS = ("params", "g_params", "d_params", "_init_e", "_init_h",
                  "s_params", "client_params", "server_params")


def engine_weights(api):
    """Every weight tensor an engine holds, by dotted name."""
    out = {}
    for attr in ENGINE_WEIGHTS + ("c_params",):
        v = getattr(api, attr, None)
        if attr == "c_params" and v:
            for c, nets in v.items():
                for i, net in enumerate(nets):
                    out.update({f"c{c}.{i}.{k}": t for k, t in net.items()})
        elif isinstance(v, dict):
            out.update({f"{attr}.{k}": t for k, t in v.items()})
    for i, p in enumerate(getattr(api, "parties", ())):
        out[f"party{i}.w"] = p.w
    return out


def split_modules(torch, d):
    """``tests/test_algorithms.py::test_split_nn``'s bottom (Dense 32 +
    ReLU over the flattened image) and top (Dense 10)."""
    nn = torch.nn

    class Bottom(nn.Module):
        def __init__(self):
            super().__init__()
            self.Dense_0 = nn.Linear(d, 32)

        def forward(self, x):
            return torch.relu(self.Dense_0(x.reshape(x.shape[0], -1)))

    class Top(nn.Module):
        def __init__(self):
            super().__init__()
            self.Dense_0 = nn.Linear(32, 10)

        def forward(self, h):
            return self.Dense_0(h)

    return Bottom(), Top()


def engine_rounds(torch, tag, api, attr, timed, smi):
    """One warm round (``train()`` with ``attr`` set to 1), then ``timed``
    rounds in one timed ``train()``, then one more under the profiler:
    seconds a round, the profile and every ``train()``'s output."""
    outs = []
    setattr(api, attr, 1)
    t_warm, out = sync_time(torch, api.train)
    outs.append(out)
    setattr(api, attr, timed)
    torch.cuda.reset_peak_memory_stats()
    dt, out = sync_time(torch, api.train)
    outs.append(out)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    setattr(api, attr, 1)
    prof = profile_rounds(torch, lambda: outs.append(api.train()), 1)
    rec = {"s_per_round": dt / timed, "warm_round_s": t_warm,
           "timed_rounds": timed, "peak_gib": peak}
    rec.update(prof)
    say("engines", f"{tag}: {rec['s_per_round']:.4f} s/round over {timed} "
                   f"after a warm round ({t_warm:.2f} s); device busy "
                   f"{prof['busy_s']:.4f} s of {prof['profiled_s_per_round']:.4f}"
                   f" s a profiled round "
                   f"({100 * prof['busy_s'] / prof['profiled_s_per_round']:.1f}"
                   f"%), {prof['host_launches']:.0f} host launch calls and "
                   f"{prof['device_kernels']:.0f} device kernels a round; "
                   f"peak {peak:.3f} GiB [{smi}]")
    return rec, outs


def engines_phase(torch, fedml_tpu_torch, smi):
    """Phase 11."""
    import numpy as np
    from fedml_tpu_torch import data, device, model
    from fedml_tpu_torch.core.mpc.secagg import dequantize
    from fedml_tpu_torch.data.data_loader import load_vertical
    from fedml_tpu_torch.runner import FedMLRunner
    from fedml_tpu_torch.simulation.centralized_trainer import \
        CentralizedTrainer
    from fedml_tpu_torch.simulation.sp.split_nn import SplitNNAPI
    from fedml_tpu_torch.simulation.sp.turboaggregate import \
        TurboAggregateAPI
    from fedml_tpu_torch.simulation.sp.vertical_fl import VerticalFLAPI

    def build(cfg, dev=None):
        args = sp_args(fedml_tpu_torch, **cfg)
        dataset, out_dim = data.load(args)
        return FedMLRunner(args, dev or device.get_device(args), dataset,
                           model.create(args, out_dim)).runner.fl_trainer

    out = {}
    # (a) FedNAS on the DARTS supernet
    t0 = time.time()
    api = build(ENGINE_FEDNAS)
    check_policy(torch, "engines")
    start = {k: v.clone() for k, v in api.params.items()}
    n = sum(v.numel() for v in api.params.values())
    say("engines", f"(a) fednas: DARTSNetwork (channels 16, steps 3), "
                   f"{n:,} parameters, CIFAR-10 stand-in "
                   f"{api.dataset.train_data_num:,} / "
                   f"{api.dataset.test_data_num:,} at 32 px, 10 clients, 4 a "
                   f"round, batch 16; built in {time.time() - t0:.1f} s")
    rec, outs = engine_rounds(torch, "(a) fednas", api, "rounds", 2, smi)
    hist = [h for o in outs for h in o["history"]]
    geno = outs[-1]["genotype"]
    rec.update(history=hist, genotype=geno, n_params=n)
    moved = float((api.params["alphas_normal"] - start["alphas_normal"])
                  .abs().max())
    say("engines", f"(a) fednas: losses {[round(h['train_loss'], 4) for h in hist]}"
                   f" (weights) {[round(h['val_loss'], 4) for h in hist]} "
                   f"(alphas); alphas moved {moved:.2e}; genotype {geno}")
    if not finite(*[h[k] for h in hist for k in ("train_loss", "val_loss")]):
        fail("(a) fednas: a non-finite loss")
    if not moved > 0 or "none" in geno["alphas_normal"] + geno["alphas_reduce"]:
        fail("(a) fednas: the alphas did not move, or the genotype has none")
    out["fednas"] = rec
    del api

    # (b) FedSeg on the UNet; the last cohort's updates go to (e)'s
    # TurboAggregate
    t0 = time.time()
    api = build(ENGINE_FEDSEG)
    n = sum(v.numel() for v in api.params.values())
    say("engines", f"(b) fedseg: UNetSmall (base 16), {n:,} parameters, "
                   f"fets2021 {api.dataset.provenance} "
                   f"{api.dataset.train_x.shape} / "
                   f"{api.dataset.test_data_num:,}, 4 classes, 10 clients, "
                   f"4 a round, batch 8; built in {time.time() - t0:.1f} s")
    cohort = []
    local_train = api.local_train

    def recording(params, xb, yb):
        if not cohort or cohort[0][0] is not params:
            cohort.clear()
        p, ls = local_train(params, xb, yb)
        cohort.append((params, p))
        return p, ls

    api.local_train = recording
    rec, outs = engine_rounds(torch, "(b) fedseg", api, "rounds", 2, smi)
    hist = [h for o in outs for h in o["history"]]
    rec.update(history=hist, n_params=n)
    say("engines", f"(b) fedseg: losses "
                   f"{[round(h['train_loss'], 4) for h in hist]}, mIoU "
                   f"{[round(h['miou'], 4) for h in hist]}")
    if not finite(*[h["train_loss"] for h in hist]) or \
            not hist[-1]["miou"] > hist[0]["miou"]:
        fail("(b) fedseg: a non-finite loss, or mIoU not above round 0's")
    out["fedseg"] = rec
    # the last cohort's flat updates, each pre-scaled by its sample weight
    last_r = len(outs[-1]["history"]) - 1
    members = np.random.default_rng(api.seed + last_r).choice(
        api.dataset.num_clients, size=min(api.clients_per_round,
                                          api.dataset.num_clients),
        replace=False)
    w = np.array([len(api.dataset.client_idxs[int(c)]) for c in members],
                 np.float64)
    w /= w.sum()
    glob = torch.cat([v.reshape(-1) for v in cohort[0][0].values()])
    flat = [wi * (torch.cat([v.reshape(-1) for v in p.values()]) - glob)
            .double().cpu().numpy() for wi, (_, p) in zip(w, cohort)]
    seg_delta = (torch.cat([v.reshape(-1) for v in api.params.values()])
                 - glob).double().cpu().numpy()
    del api

    # (c) FedGKT with the default nets
    t0 = time.time()
    api = build(ENGINE_FEDGKT)
    say("engines", f"(c) fedgkt: ClientExtractor + ClientHead, ServerHead "
                   f"(width 256, depth 3), CIFAR-10 stand-in "
                   f"{api.dataset.train_data_num:,} / "
                   f"{api.dataset.test_data_num:,}, 4 clients, batch 32; "
                   f"built in {time.time() - t0:.1f} s")
    rec, outs = engine_rounds(torch, "(c) fedgkt", api, "rounds", 2, smi)
    hist = [h for o in outs for h in o["history"]]
    acc = api.evaluate()
    rec.update(history=hist, test_acc=acc)
    say("engines", f"(c) fedgkt: client loss "
                   f"{[round(h['client_loss'], 4) for h in hist]}, server "
                   f"loss {[round(h['server_loss'], 4) for h in hist]}; "
                   f"accuracy (client 0's extractor → server head) {acc:.4f}")
    if not finite(*[h[k] for h in hist for k in ("client_loss",
                                                 "server_loss")]) or \
            not hist[2]["server_loss"] < hist[0]["server_loss"]:
        fail("(c) fedgkt: a non-finite loss, or the server loss did not fall")
    out["fedgkt"] = rec
    del api

    # (d) FedGAN with the default generator and discriminator
    t0 = time.time()
    api = build(ENGINE_FEDGAN)
    say("engines", f"(d) fedgan: Generator + Discriminator (base 64, latent "
                   f"64), MNIST stand-in {api.images.shape}, 4 clients, 2 a "
                   f"round, batch 32; built in {time.time() - t0:.1f} s")
    rec, outs = engine_rounds(torch, "(d) fedgan", api, "rounds", 1, smi)
    hist = [h for o in outs for h in o["history"]]
    samples = api.sample(16, seed=1)
    rec.update(history=hist, sample_range=[float(samples.min()),
                                           float(samples.max())])
    say("engines", f"(d) fedgan: D loss "
                   f"{[round(h['d_loss'], 4) for h in hist]}, G loss "
                   f"{[round(h['g_loss'], 4) for h in hist]}; 16 samples "
                   f"{samples.shape} in [{samples.min():.3f}, "
                   f"{samples.max():.3f}]")
    if not finite(*[h[k] for h in hist for k in ("d_loss", "g_loss")]) or \
            samples.shape != (16, 28, 28, 1) or \
            not (np.abs(samples) <= 1.0).all():
        fail("(d) fedgan: a non-finite loss, or samples outside [-1, 1]")
    out["fedgan"] = rec
    del api

    # (e) split learning, vertical FL, TurboAggregate and the centralized
    # trainer, through their classes on the card
    args = sp_args(fedml_tpu_torch, **ENGINE_MNIST)
    ds, _ = data.load(args)
    api = SplitNNAPI(args, ds, *split_modules(torch, 28 * 28))
    acc0 = api.evaluate()
    rec, outs = engine_rounds(torch, "(e) split_nn", api, "comm_rounds", 1,
                              smi)
    acc = api.evaluate()
    rec.update(first_loss=outs[0][0], last_loss=outs[-1][-1], acc0=acc0,
               test_acc=acc)
    say("engines", f"(e) split_nn: 2,000 MNIST-stand-in images of client 0 a"
                   f" round, batch 32; loss {outs[0][0]:.4f} → "
                   f"{outs[-1][-1]:.4f}, accuracy {acc0:.4f} → {acc:.4f}")
    if not (outs[-1][-1] < outs[0][0] and acc > max(acc0, 0.4)):
        fail("(e) split_nn: did not learn")
    out["split_nn"] = rec

    vargs = fedml_tpu_torch.load_arguments().update(
        dataset="nus_wide", train_size=5000, batch_size=64, comm_round=1,
        learning_rate=0.1, random_seed=0)
    feats, labels, classes = load_vertical(vargs)
    api = VerticalFLAPI(vargs, [f[:4000] for f in feats], labels[:4000],
                        [f[4000:] for f in feats], labels[4000:], classes)
    acc0 = api.evaluate()
    rec, outs = engine_rounds(torch, "(e) vertical_fl", api, "rounds", 2,
                              smi)
    acc = api.evaluate()
    rec.update(acc0=acc0, test_acc=acc, last_loss=outs[-1][-1])
    say("engines", f"(e) vertical_fl: NUS-WIDE widths "
                   f"{[f.shape[1] for f in feats]} (synthetic), 4,000 / "
                   f"1,000 rows, batch 64; loss {outs[0][0]:.4f} → "
                   f"{outs[-1][-1]:.4f}, accuracy {acc0:.4f} → {acc:.4f}")
    if not acc > max(acc0, 0.6):
        fail("(e) vertical_fl: did not learn")
    out["vertical_fl"] = rec

    t0 = time.time()
    turbo = TurboAggregateAPI(n_clients=len(flat), n_groups=3, seed=0)
    total = turbo.aggregate(flat)
    t_turbo = time.time() - t0
    exact = np.abs(total - np.sum(flat, axis=0)).max()
    vs_engine = np.abs(total - seg_delta).max()
    masked = np.abs(dequantize(turbo.observed_partials[0])
                    - np.sum([flat[c] for c in turbo.groups[0]], 0)).max()
    say("engines", f"(e) turboaggregate: {len(flat)} flat updates of "
                   f"{len(flat[0]):,} from (b)'s last cohort in "
                   f"{len(turbo.groups)} ring groups, {t_turbo:.3f} s on the "
                   f"host; sum error {exact:.2e} (fixed-point step "
                   f"{2 ** -16:.1e}), vs the engine's own aggregate "
                   f"{vs_engine:.2e}; the first group's partial is masked "
                   f"(differs by up to {masked:.2e})")
    if not (exact <= len(flat) * 2 ** -16 and vs_engine <= 1e-4
            and masked > 1.0):
        fail("(e) turboaggregate: the sum is not exact, or not masked")
    out["turboaggregate"] = {"sum_err": float(exact),
                             "vs_engine_err": float(vs_engine),
                             "host_s": t_turbo, "n": len(flat[0])}

    cargs = sp_args(fedml_tpu_torch, **dict(ENGINE_MNIST, epochs=1))
    ds, out_dim = data.load(cargs)
    api = CentralizedTrainer(ds, model.create(cargs, out_dim), None, cargs)
    rec, _ = engine_rounds(torch, "(e) centralized lr", api, "epochs", 2,
                           smi)
    hist = api.history
    rec["history"] = hist
    say("engines", f"(e) centralized lr: train loss "
                   f"{[round(h['train_loss'], 4) for h in hist]}, test "
                   f"accuracy {hist[-1]['test_acc']:.4f}")
    if not hist[-1]["train_loss"] < hist[0]["train_loss"]:
        fail("(e) centralized: the train loss did not fall")
    out["centralized"] = rec
    del api

    # (f) card ≡ CPU from the same weights (and z), TF32 off
    out["card_vs_cpu"] = {}
    for tag, cfg in ENGINE_CARD_CPU.items():
        cfg = dict(cfg, comm_round=2, random_seed=0)
        card = build(cfg)
        cpu = build(cfg, torch.device("cpu"))
        for attr in ENGINE_WEIGHTS:
            if hasattr(card, attr):
                setattr(cpu, attr, {k: v.cpu() for k, v in
                                    getattr(card, attr).items()})
        if tag == "fedgan":
            zs, draw = [], card.client_noise
            card.client_noise = lambda s, b: zs.append(draw(s, b)) or zs[-1]
            cpu.client_noise = lambda s, b: zs.pop(0).cpu()
        hc, hp = card.train()["history"], cpu.train()["history"]
        out["card_vs_cpu"][tag] = engine_card_cpu(torch, tag, card, cpu, hc,
                                                  hp)
    for tag in ("split_nn", "vertical_fl", "centralized"):
        args = sp_args(fedml_tpu_torch, **dict(ENGINE_MNIST, train_size=256,
                                               test_size=64, comm_round=1,
                                               epochs=2))
        ds, out_dim = data.load(args)
        if tag == "split_nn":
            card, cpu = (SplitNNAPI(args, ds, *split_modules(torch, 784),
                                    device=d) for d in (None, "cpu"))
        elif tag == "vertical_fl":
            vargs = fedml_tpu_torch.load_arguments().update(
                dataset="nus_wide", train_size=400, batch_size=64,
                comm_round=2, learning_rate=0.1, random_seed=0)
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
        for attr in ENGINE_WEIGHTS:
            if hasattr(card, attr):
                setattr(cpu, attr, {k: v.cpu() for k, v in
                                    getattr(card, attr).items()})
        lc, lp = card.train(), cpu.train()
        hc = lc if tag != "centralized" else [h["train_loss"] for h in lc]
        hp = lp if tag != "centralized" else [h["train_loss"] for h in lp]
        out["card_vs_cpu"][tag] = engine_card_cpu(
            torch, tag, card, cpu, [{"loss": v} for v in hc],
            [{"loss": v} for v in hp])
    return out


def engine_card_cpu(torch, tag, card, cpu, hc, hp):
    """Phase 11 (f): the weights and history of a card run against the CPU
    run from the same start, held to ``ENGINE_CARD_CPU_TOL``."""
    wc, wp = engine_weights(card), engine_weights(cpu)
    if wc.keys() != wp.keys() or not wc:
        fail(f"(f) {tag}: the card and CPU runs hold different weights")
    err = max(max_err(wc[k].cpu(), v) for k, v in wp.items())
    h_err = max(abs(a[k] - b[k]) for a, b in zip(hc, hp) for k in a
                if k != "round")
    tol = ENGINE_CARD_CPU_TOL.get(tag, 1e-6)
    say("engines", f"(f) {tag}: card vs CPU from the same weights, "
                   f"{len(wc)} weight tensors max abs diff {err:.2e}, "
                   f"history {h_err:.2e} (tol {tol:g})")
    if not (err <= tol and h_err <= tol):
        fail(f"(f) {tag}: card and CPU disagree ({err:.2e}, {h_err:.2e})")
    return {"weights": err, "history": h_err, "tol": tol}


#: phase 12: Llama-2-7B widths (the model's own: dim 4096, 32 heads, ffn
#: 11008, bf16) over a 32,000-token vocabulary at seq 1024; depth cut per
#: path
LLM_SEQ, LLM_VOCAB = 1024, 32000
#: (a): CausalLMTrainer, LoRA rank 8, 4 layers; 16 windows make 8
#: micro-steps an epoch, so the 6-update budget ends inside epoch 1
LLM_TRAINER = dict(llm_n_layers=4, lora_rank=8, batch_size=2,
                   gradient_accumulation_steps=2, lr_scheduler_type="cosine",
                   warmup_steps=2, max_grad_norm=1.0, max_steps=6, epochs=2,
                   learning_rate=1e-3)
#: (b): the same trainer dense (f32 masters), 2 layers, 4 steps
LLM_DENSE = dict(llm_n_layers=2, lora_rank=0, batch_size=2, max_steps=4,
                 epochs=1, learning_rate=1e-4)
#: (c)/(d)/(e): FedLLMAPI rounds, 2 layers, 2 clients × 2 steps of batch 2
LLM_ROUND = dict(llm_n_layers=2, lora_rank=8, lora_alpha=16.0,
                 client_num_in_total=2, client_num_per_round=2, comm_round=1,
                 batch_size=2, llm_max_local_steps=2, learning_rate=1e-3)
#: (c): streaming_xent at N 2048 tokens; chunk 5000 pads the last chunk
LLM_XENT_N, LLM_XENT_CHUNKS = 2048, (8192, 5000)
#: (f): the hub's tiny_llama at its own width (TINY: dim 64, 4 heads, 2 KV
#: heads, f32) on synthetic Shakespeare, and llama at 7B widths, 1 layer
LLM_HUB_TINY = dict(model="tiny_llama", dataset="shakespeare", seq_len=64,
                    client_num_in_total=10, client_num_per_round=4,
                    batch_size=8, learning_rate=0.1, train_size=640,
                    test_size=200, partition_method="homo")
LLM_HUB_LLAMA = dict(model="llama", dataset="shakespeare", seq_len=256,
                     llm_n_layers=1, client_num_in_total=2,
                     client_num_per_round=2, batch_size=4,
                     learning_rate=0.01, train_size=16, test_size=4,
                     partition_method="homo", comm_round=1)
#: (g): the CPU tests' sizes and tolerances (tests/test_torch_{llm_trainer,
#: xent,moe,llm_paths}.py): trainer losses 1e-5 and adapters 1e-4 (Adam at
#: lr 1e-3), streaming loss 2e-6 and grads 1e-6 + 1e-5 rel, MoE 1e-5 (aux
#: 1e-6), the hub's sp rounds 1e-5
LLM_SMALL_TRAINER = dict(model="tiny_llama", dataset="shakespeare",
                         seq_len=16, batch_size=4, learning_rate=1e-3,
                         random_seed=9, lora_rank=4, partition_method="homo",
                         train_size=12, test_size=8, client_num_in_total=2,
                         client_num_per_round=2, epochs=3,
                         gradient_accumulation_steps=2, max_grad_norm=0.5,
                         warmup_steps=1, lr_scheduler_type="cosine",
                         max_steps=3, weight_decay=0.01)
LLM_SMALL_HUB = dict(model="tiny_llama", dataset="shakespeare", seq_len=16,
                     client_num_in_total=4, client_num_per_round=2,
                     comm_round=2, batch_size=4, learning_rate=0.1,
                     train_size=48, test_size=8, random_seed=3,
                     partition_method="homo")
#: (c)/(d): the bf16 bound of a kernel-free comparison: both sides round
#: their outputs to bf16, so an element may differ by an ulp (2^-8 of its
#: size); held per tensor against 1e-2 of its largest entry
LLM_BF16_REL = 1e-2
#: (c): streaming vs the dense f32 logits of the same bf16 operands: the
#: mean loss, and each of the first LLM_XENT_TOKENS tokens' NLL (the card's
#: f32 GEMMs sum in an order of their own shape's choosing); a control with
#: the chunk products left in bf16 must break the per-token limit
LLM_XENT_LOSS_TOL, LLM_XENT_TOKEN_TOL, LLM_XENT_TOKENS = 1e-5, 1e-4, 256
#: (c) round, streaming vs dense loss from the same weights: {dtype: (one
#: step's loss, its adapter gradients of their largest entries, the
#: rounds' losses, the rounds' adapter updates' norm)}.  f32 is the
#: witness: its gradients differ by f32 rounding only (3.9e-6 on an H100).
#: In bf16 the gradient goes back through the bf16 residual stream, where
#: a last-bit difference of the f32 dh flips bf16 roundings (7.5e-3).  In
#: both, Adam's first steps are ±lr wherever a gradient is non-zero, so a
#: near-zero entry whose sign differs moves by 2·lr: the update bounds are
#: about twice the readings of these correct runs (1.7e-3 in f32, 9.8e-2
#: in bf16; PERF.md §6)
LLM_STREAM_TOL = {"bfloat16": (1e-5, LLM_BF16_REL, 1e-3, 0.2),
                  "float32": (1e-5, 1e-4, 1e-5, 4e-3)}


def launch_counts(att):
    return {f.__name__.replace("flash_attention", "flash"): f.launches
            for f in att.KERNELS}


def counted(torch, att, fn):
    """``fn()`` with K1–K3's counts set to 0 just before it and read just
    after: (its result, {kernel: launches})."""
    torch.cuda.synchronize()
    att.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, launch_counts(att)


def expect_launches(layers, k1, k23):
    return {"flash_fwd": layers * k1, "flash_bwd_dq": layers * k23,
            "flash_bwd_dkv": layers * k23}


def check_launches(tag, got, want):
    say("llm", f"{tag}: launches {got}, expected {want}")
    if got != want:
        fail(f"{tag}: launch counts {got} != expected {want}")


def peak_gib(torch):
    return torch.cuda.max_memory_allocated() / 2 ** 30


def llm_args(fedml_tpu_torch, **over):
    cfg = dict(model="llama", dataset="shakespeare", seq_len=LLM_SEQ,
               random_seed=0, partition_method="homo")
    cfg.update(over)
    return fedml_tpu_torch.init(fedml_tpu_torch.load_arguments().update(
        **cfg), should_init_logs=False)


def lm_dataset(train_n, test_n, clients):
    """Synthetic Markov-chain windows of ``LLM_SEQ`` tokens (the LM loaders'
    generator, seed 0) over 512 of the ``LLM_VOCAB`` ids, placed by a seeded
    permutation (text uses a small part of a 32k vocabulary too), split
    evenly over ``clients``; the model's vocabulary is ``LLM_VOCAB``."""
    import numpy as np
    from fedml_tpu_torch.data.federated_dataset import build_federated
    from fedml_tpu_torch.data.synthetic import synthetic_lm_tokens

    ids = np.random.default_rng(0).permutation(LLM_VOCAB)[:512]
    tx, ty, vx, vy = (ids[a] for a in synthetic_lm_tokens(
        train_n, test_n, 512, LLM_SEQ, 0))
    return build_federated(tx, ty, vx, vy, LLM_VOCAB, clients, "homo", 0.5,
                           0, provenance="synthetic")


def rel_err(got, ref):
    ref = ref.float()
    return ((got.float() - ref).abs().max() /
            ref.abs().max().clamp_min(1e-30)).item()


def llm_trainer_phase(torch, fedml_tpu_torch, att, smi, out):
    """Phase 12 (a) and (b)."""
    import tempfile
    from fedml_tpu_torch.llm.trainer import CausalLMTrainer

    # (a) LoRA-only, 4 layers
    ds = lm_dataset(16, 4, 1)
    with tempfile.TemporaryDirectory() as ckdir:
        args = llm_args(fedml_tpu_torch, output_dir=ckdir, **LLM_TRAINER)
        t0 = time.time()
        tr = CausalLMTrainer(args, ds, device="cuda")
        cfg, layers = tr.cfg, tr.cfg.n_layers
        say("llm", f"(a) CausalLMTrainer LoRA rank {cfg.lora_rank}: dim "
                   f"{cfg.dim}, {cfg.n_heads} heads, ffn {cfg.ffn_dim}, "
                   f"vocab {cfg.vocab_size}, {cfg.dtype}, {layers} layers, "
                   f"seq {LLM_SEQ}; built in {time.time() - t0:.1f} s")
        base = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
        torch.cuda.reset_peak_memory_stats()
        micro_s, step = [], tr._step

        def timed_step(x, y):
            t1 = time.time()
            loss = step(x, y)
            torch.cuda.synchronize()
            micro_s.append(time.time() - t1)
            return loss

        tr._step = timed_step

        def run():
            nll0 = tr.evaluate()
            t1 = time.time()
            hist = tr.train()["history"]
            torch.cuda.synchronize()
            return nll0, time.time() - t1, hist, tr.evaluate()

        (nll0, train_s, hist, nll1), launches = counted(torch, att, run)
        del tr._step                 # the wrapper held the trainer alive
        micro = tr.global_step
        n_eval = 2 * len(ds.test_batches(tr.batch_size)[0])
        rec = {"layers": layers, "micro_steps": micro,
               "updates": tr.counts["updates"], "eval_nll_before": nll0,
               "eval_nll_after": nll1, "history": hist,
               "step_losses": tr.step_losses, "train_s": train_s,
               "micro_step_s": micro_s, "s_per_micro_step":
               sorted(micro_s)[len(micro_s) // 2],
               "peak_gib": peak_gib(torch), "launches": launches}
        rec["tokens_per_s"] = (tr.batch_size * LLM_SEQ
                               / rec["s_per_micro_step"])
        say("llm", f"(a) {micro} micro-steps ({tr.counts['updates']} "
                   f"updates, accumulation 2, cosine after warmup 2, clip "
                   f"1.0) in {train_s:.2f} s with the epochs' checkpoints: "
                   f"median {rec['s_per_micro_step']:.4f} s a micro-step "
                   f"(the first {micro_s[0]:.3f} s), "
                   f"{rec['tokens_per_s']:.0f} train tokens/s; eval NLL "
                   f"{nll0:.4f} -> {nll1:.4f}; peak {rec['peak_gib']:.2f} "
                   f"GiB [{smi}]")
        check_launches("(a) trainer", launches,
                       expect_launches(layers, 2 * micro + n_eval, micro))
        if not (finite(nll0, nll1, *tr.step_losses) and nll1 < nll0):
            fail(f"(a) eval NLL did not fall: {nll0} -> {nll1}")
        for n, p in tr.model.named_parameters():
            if not torch.equal(p, base[n]):
                fail(f"(a) base weight {n} changed")
        del base
        n_b = [k for k in tr.lora if k.endswith("/B")]
        moved = [k for k in n_b if tr.lora[k].abs().max().item() > 0]
        if len(moved) != len(n_b):
            fail(f"(a) only {len(moved)} of {len(n_b)} B adapters non-zero")
        tr.save_checkpoint()
        tr.close()
        del tr
        torch.cuda.empty_cache()
        again = CausalLMTrainer(args, ds, device="cuda")
        if not again.resume_from_checkpoint():
            fail("(a) no checkpoint to resume from")
        nll2 = again.evaluate()
        again.close()
        del again
        rec["resumed_eval_nll"] = nll2
        say("llm", f"(a) base bitwise unchanged; {len(n_b)}/{len(n_b)} B "
                   f"adapters non-zero; checkpoint -> new trainer -> resume: "
                   f"eval NLL {nll2:.6f} (before the save {nll1:.6f})")
        if abs(nll2 - nll1) > 1e-6 * max(1.0, abs(nll1)):
            fail(f"(a) resumed eval NLL {nll2} != {nll1}")
        out["trainer_lora"] = rec
    torch.cuda.empty_cache()

    # (b) dense, f32 masters, 2 layers
    ds = lm_dataset(8, 4, 1)
    args = llm_args(fedml_tpu_torch, **LLM_DENSE)
    tr = CausalLMTrainer(args, ds, device="cuda")
    layers = tr.cfg.n_layers
    before = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    n_params = sum(p.numel() for p in before.values())
    torch.cuda.reset_peak_memory_stats()

    def run_dense():
        nll0 = tr.evaluate()
        t1 = time.time()
        tr.train()
        torch.cuda.synchronize()
        return nll0, time.time() - t1, tr.evaluate()

    (nll0, train_s, nll1), launches = counted(torch, att, run_dense)
    steps = tr.global_step
    n_eval = 2 * len(ds.test_batches(tr.batch_size)[0])
    still = [n for n, p in tr.model.named_parameters()
             if torch.equal(p, before[n])]
    rec = {"layers": layers, "params": n_params, "steps": steps,
           "step_losses": tr.step_losses, "eval_nll_before": nll0,
           "eval_nll_after": nll1, "s_per_step": train_s / steps,
           "peak_gib": peak_gib(torch), "launches": launches,
           "dtypes": sorted({str(p.dtype) for p in tr.model.parameters()})}
    say("llm", f"(b) dense trainer, {layers} layers, {n_params:,} f32 "
               f"master params: {steps} AdamW steps, "
               f"{rec['s_per_step']:.4f} s a step, losses "
               f"{[round(x, 4) for x in tr.step_losses]}, eval NLL "
               f"{nll0:.4f} -> {nll1:.4f}; {len(still)} params unmoved; "
               f"peak {rec['peak_gib']:.2f} GiB [{smi}]")
    check_launches("(b) dense trainer", launches,
                   expect_launches(layers, 2 * steps + n_eval, steps))
    if rec["dtypes"] != ["torch.float32"]:
        fail(f"(b) not f32 masters: {rec['dtypes']}")
    if still or not (finite(nll0, nll1) and nll1 < nll0):
        fail(f"(b) unmoved params {still[:3]} or NLL {nll0} -> {nll1}")
    out["trainer_dense"] = rec
    del tr, before
    torch.cuda.empty_cache()


def llm_xent_phase(torch, fedml_tpu_torch, smi, out):
    """Phase 12 (c), the loss alone: streaming_xent against causal_nll on
    the dense f32 logits of the same bf16 h and w: loss, each token's NLL,
    dh and dw, peak memory of each; and the control, each chunk product
    left in bf16, which must break the per-token limit."""
    import torch.nn.functional as F
    from fedml_tpu_torch.llm.model import causal_nll
    from fedml_tpu_torch.ops import xent as xent_mod
    from fedml_tpu_torch.ops.xent import streaming_xent

    d = 4096
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    h = torch.randn(LLM_XENT_N, d, generator=gen, device="cuda").to(
        torch.bfloat16)
    w = (torch.randn(d, LLM_VOCAB, generator=gen, device="cuda")
         * d ** -0.5).to(torch.bfloat16)
    t = torch.randint(0, LLM_VOCAB, (LLM_XENT_N,), generator=gen,
                      device="cuda")

    def run(loss_fn):
        hh = h.detach().requires_grad_(True)
        ww = w.detach().requires_grad_(True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.time()
        loss = loss_fn(hh, ww)
        dh, dw = torch.autograd.grad(loss, (hh, ww))
        torch.cuda.synchronize()
        return {"loss": loss.detach(), "dh": dh, "dw": dw,
                "s": time.time() - t0,
                "peak_gib": (torch.cuda.max_memory_allocated() - base)
                / 2 ** 30}

    n_tok = LLM_XENT_TOKENS
    with torch.no_grad():
        ref_tok = F.cross_entropy(h[:n_tok].float() @ w.float(), t[:n_tok],
                                  reduction="none").double()

    def token_err(chunk):
        """Max over the first tokens of |streaming NLL − dense NLL|, one
        token a call."""
        with torch.no_grad():
            got = torch.stack([streaming_xent(h[i:i + 1], w, t[i:i + 1],
                                              chunk)
                               for i in range(n_tok)]).double()
        return (got - ref_tok).abs().max().item()

    f32_logits = xent_mod._chunk_logits

    def bf16_logits(h2f, w_, base, chunk):
        logits, wc = f32_logits(h2f, w_, base, chunk)
        lb = (h2f.bfloat16() @ wc.bfloat16()).float()
        return torch.where(logits == xent_mod.NEG_INF, logits, lb), wc

    run(lambda a, b: causal_nll(a.float() @ b.float(), t))   # warm
    dense = run(lambda a, b: causal_nll(a.float() @ b.float(), t))
    rec = {"n": LLM_XENT_N, "d": d, "v": LLM_VOCAB,
           "dense": {"loss": dense["loss"].item(), "s": dense["s"],
                     "peak_gib": dense["peak_gib"]}}
    say("llm", f"(c) dense logits N {LLM_XENT_N} D {d} V {LLM_VOCAB} bf16: "
               f"loss {rec['dense']['loss']:.6f}, fwd+bwd "
               f"{dense['s'] * 1e3:.1f} ms, peak above inputs "
               f"{dense['peak_gib']:.3f} GiB [{smi}]")
    for chunk in LLM_XENT_CHUNKS:
        run(lambda a, b: streaming_xent(a, b, t, chunk))          # warm
        got = run(lambda a, b: streaming_xent(a, b, t, chunk))
        errs = {"loss": abs(got["loss"].item() - dense["loss"].item()),
                "token": token_err(chunk),
                "dh": rel_err(got["dh"], dense["dh"]),
                "dw": rel_err(got["dw"], dense["dw"])}
        xent_mod._chunk_logits = bf16_logits
        try:
            with torch.no_grad():
                c_loss = streaming_xent(h, w, t, chunk).item()
            ctrl = {"loss": abs(c_loss - dense["loss"].item()),
                    "token": token_err(chunk)}
        finally:
            xent_mod._chunk_logits = f32_logits
        rec[f"chunk_{chunk}"] = dict(errs, control=ctrl, s=got["s"],
                                     peak_gib=got["peak_gib"])
        say("llm", f"(c) streaming chunk {chunk}: loss diff "
                   f"{errs['loss']:.2e} (tol {LLM_XENT_LOSS_TOL:g}), "
                   f"per-token NLL over {n_tok} tokens {errs['token']:.2e} "
                   f"(tol {LLM_XENT_TOKEN_TOL:g}); control, products left "
                   f"in bf16: loss {ctrl['loss']:.2e}, per-token "
                   f"{ctrl['token']:.2e} (must exceed "
                   f"{LLM_XENT_TOKEN_TOL:g}); dh {errs['dh']:.2e} and dw "
                   f"{errs['dw']:.2e} of their largest entries (tol "
                   f"{LLM_BF16_REL:g}), fwd+bwd {got['s'] * 1e3:.1f} ms, "
                   f"peak above inputs {got['peak_gib']:.3f} GiB "
                   f"({got['peak_gib'] / max(dense['peak_gib'], 1e-9):.2f}x "
                   "dense) "
                   f"[{smi}]")
        if not (errs["loss"] <= LLM_XENT_LOSS_TOL
                and errs["token"] <= LLM_XENT_TOKEN_TOL
                and errs["dh"] <= LLM_BF16_REL
                and errs["dw"] <= LLM_BF16_REL):
            fail(f"(c) streaming chunk {chunk} disagrees with dense: {errs}")
        if ctrl["token"] <= LLM_XENT_TOKEN_TOL:
            fail(f"(c) chunk {chunk}: the bf16-product control passes the "
                 f"per-token limit ({ctrl}): the check cannot see it")
    out["xent"] = rec


def copy_llm_weights(torch, dst, src):
    """``src``'s base weights and global adapters into ``dst``."""
    with torch.no_grad():
        for p, q in zip(dst.model.parameters(), src.model.parameters()):
            p.copy_(q)
    dst.global_lora = {k: v.clone() for k, v in src.global_lora.items()}


def stream_vs_dense_round(torch, att, dense, stream, x, y, dtype, smi):
    """Phase 12 (c) round: ``stream`` (the streaming loss) against ``dense``
    from the same weights: one round of each (counted for launches), then
    one loss and its adapter gradients at the dense round's adapters (B
    non-zero), all held to ``LLM_STREAM_TOL[dtype]``."""
    copy_llm_weights(torch, stream, dense)
    start = {k: v.detach().clone() for k, v in dense.global_lora.items()}
    layers = dense.cfg.n_layers
    rec = {}
    for tag, api in (("dense", dense), ("streaming", stream)):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        m, launches = counted(torch, att, lambda: api.train_one_round(0))
        rec[tag] = {"loss": m["train_loss"], "steps": m["steps"],
                    "s": time.time() - t0, "peak_gib": peak_gib(torch),
                    "launches": launches}
        if dtype == "bfloat16":
            check_launches(f"(c) {tag}-loss round", launches,
                           expect_launches(layers, 2 * m["steps"],
                                           m["steps"]))
    grads = {}
    for tag, api in (("dense", dense), ("streaming", stream)):
        lora = {k: v.detach().clone().requires_grad_(True)
                for k, v in dense.global_lora.items()}
        loss = api.loss(lora, x, y)
        grads[tag] = (loss.item(), torch.autograd.grad(
            loss, list(lora.values())))
    lerr = abs(grads["streaming"][0] - grads["dense"][0])
    gerr = max(rel_err(a, b) for a, b in zip(grads["streaming"][1],
                                             grads["dense"][1]))
    upd = lambda api: torch.cat([(api.global_lora[k] - start[k]).flatten()
                                 for k in sorted(start)])
    ud, us = upd(dense), upd(stream)
    urel = ((us - ud).norm() / ud.norm()).item()
    dl = abs(rec["streaming"]["loss"] - rec["dense"]["loss"])
    err = max(max_err(stream.global_lora[k], v)
              for k, v in dense.global_lora.items())
    rec.update(grad_loss_diff=lerr, grad_rel_diff=gerr, loss_diff=dl,
               update_rel_norm_diff=urel, adapter_max_abs_diff=err)
    tol = LLM_STREAM_TOL[dtype]
    say("llm", f"(c) FedLLMAPI round, {dtype}, {layers} layers, 2 clients: "
               f"one loss + adapter gradients, streaming (chunk "
               f"{stream.xent_chunk}) vs dense: loss {lerr:.2e} (tol "
               f"{tol[0]:g}), gradients {gerr:.2e} of their largest entries "
               f"(tol {tol[1]:g}); the rounds: loss "
               f"{rec['dense']['loss']:.6f} vs "
               f"{rec['streaming']['loss']:.6f} (diff {dl:.2e}, tol "
               f"{tol[2]:g}), adapter updates' norm differs by {urel:.2e} of "
               f"the dense one (tol {tol[3]:g}), adapters max abs diff "
               f"{err:.2e}; {rec['dense']['s']:.2f} / "
               f"{rec['streaming']['s']:.2f} s, peak "
               f"{rec['dense']['peak_gib']:.2f} / "
               f"{rec['streaming']['peak_gib']:.2f} GiB [{smi}]")
    if not (finite(rec["dense"]["loss"], rec["streaming"]["loss"])
            and lerr <= tol[0] and gerr <= tol[1] and dl <= tol[2]
            and urel <= tol[3]):
        fail(f"(c) {dtype} streaming and dense rounds disagree ({lerr:.2e}, "
             f"{gerr:.2e}, {dl:.2e}, {urel:.2e})")
    return rec


def llm_round_phase(torch, fedml_tpu_torch, att, smi, out):
    """Phase 12 (c) round, (d) MoE and (e) remat."""
    import dataclasses
    from fedml_tpu_torch.llm.fedllm import FedLLMAPI
    from fedml_tpu_torch.llm.model import causal_nll
    from fedml_tpu_torch.llm.moe import moe_per_token

    ds = lm_dataset(8, 4, 2)
    x = torch.as_tensor(ds.train_x[:2], device="cuda")
    y = torch.as_tensor(ds.train_y[:2], device="cuda")
    rec = {}
    for dtype in ("float32", "bfloat16"):
        if dtype == "bfloat16":
            del dense, stream
            torch.cuda.empty_cache()
        dense = FedLLMAPI(llm_args(fedml_tpu_torch, model_dtype=dtype,
                                   **LLM_ROUND), ds, "cuda")
        stream = FedLLMAPI(llm_args(fedml_tpu_torch, model_dtype=dtype,
                                    streaming_xent_chunk=8192, **LLM_ROUND),
                           ds, "cuda")
        rec[dtype] = stream_vs_dense_round(torch, att, dense, stream, x, y,
                                           dtype, smi)
    layers = dense.cfg.n_layers
    rec = dict(rec.pop("bfloat16"), layers=layers, chunk=stream.xent_chunk,
               float32=rec["float32"])
    pc, launches = counted(torch, att, stream.evaluate_per_client)
    rec["per_client"] = {k: (v.tolist() if hasattr(v, "tolist") else v)
                         for k, v in pc.items()}
    say("llm", f"(f) FedLLMAPI.evaluate_per_client: NLL per client "
               f"{[round(x, 4) for x in pc['per_client_nll'].tolist()]}, "
               f"mean {pc['nll_mean']:.4f}, max {pc['nll_max']:.4f}, p90 "
               f"{pc['nll_p90']:.4f}; K1 launches {launches['flash_fwd']}")
    if not finite(*pc["per_client_nll"].tolist()):
        fail("(f) FedLLMAPI per-client NLL not finite")
    out["streaming_round"] = rec

    # (e) remat "dots" / "full" / "none": one loss + adapter gradients
    x = torch.as_tensor(ds.train_x[:2], device="cuda")
    y = torch.as_tensor(ds.train_y[:2], device="cuda")
    rem = {}
    for mode in ("none", "full", "dots"):
        dense.model.cfg = dataclasses.replace(dense.cfg, remat=mode)
        lora = {k: v.detach().requires_grad_(True)
                for k, v in dense.global_lora.items()}

        def step():
            loss = causal_nll(dense.model(x, lora), y)
            return loss.detach(), torch.autograd.grad(loss,
                                                      list(lora.values()))

        step()                                                     # warm
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        (loss, grads), launches = counted(torch, att, step)
        rem[mode] = {"loss": loss, "grads": grads, "s": time.time() - t0,
                     "peak_gib": peak_gib(torch), "launches": launches}
        check_launches(f"(e) remat {mode}", launches, expect_launches(
            layers, 1 if mode == "none" else 2, 1))
    dense.model.cfg = dense.cfg
    rec_e = {}
    for mode, r in rem.items():
        gerr = max(rel_err(a, b) for a, b in zip(r["grads"],
                                                 rem["none"]["grads"]))
        lerr = abs(r["loss"].item() - rem["none"]["loss"].item())
        rec_e[mode] = {"loss": r["loss"].item(), "s": r["s"],
                       "peak_gib": r["peak_gib"], "loss_diff": lerr,
                       "grad_rel_diff": gerr, "launches": r["launches"]}
        say("llm", f"(e) remat {mode}: loss {r['loss'].item():.6f} (diff "
                   f"{lerr:.1e}), adapter grads {gerr:.1e} of their largest "
                   f"entries from 'none' (tol 1e-6), step {r['s']:.3f} s, "
                   f"peak {r['peak_gib']:.2f} GiB [{smi}]")
        if lerr > 1e-6 or gerr > 1e-6:
            fail(f"(e) remat {mode} changes the numbers ({lerr}, {gerr})")
    out["remat"] = rec_e
    del dense, stream
    torch.cuda.empty_cache()

    # (d) MoE: 8 experts top-2
    api = FedLLMAPI(llm_args(fedml_tpu_torch, n_experts=8, moe_top_k=2,
                             **LLM_ROUND), ds, "cuda")
    moe = api.model.layer_0.moe_mlp
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    xm = torch.randn((2, LLM_SEQ, api.cfg.dim), generator=gen,
                     device="cuda").to(api.cfg.dtype)
    with torch.no_grad():
        got = moe(xm)
    ref = moe_per_token(moe, xm)
    merr = rel_err(got, ref)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    m, launches = counted(torch, att, lambda: api.train_one_round(0))
    rec_d = {"experts": 8, "top_k": 2, "capacity": moe.capacity(
        2 * LLM_SEQ), "vs_per_token_rel": merr, "loss": m["train_loss"],
        "steps": m["steps"], "s": time.time() - t0,
        "peak_gib": peak_gib(torch), "launches": launches}
    say("llm", f"(d) MoEMLP (E 8, top-2, capacity {rec_d['capacity']} of "
               f"{2 * LLM_SEQ} tokens) vs its plain per-token version: "
               f"{merr:.2e} of the largest entry (tol {LLM_BF16_REL:g}); "
               f"FedLLMAPI MoE round, {layers} layers: loss "
               f"{m['train_loss']:.4f}, {rec_d['s']:.2f} s, peak "
               f"{rec_d['peak_gib']:.2f} GiB [{smi}]")
    check_launches("(d) MoE round", launches,
                   expect_launches(layers, 2 * m["steps"], m["steps"]))
    if merr > LLM_BF16_REL or not finite(m["train_loss"]):
        fail(f"(d) MoE: plain version {merr:.2e} or loss {m['train_loss']}")
    out["moe"] = rec_d
    del api, moe
    torch.cuda.empty_cache()


def llm_hub_phase(torch, fedml_tpu_torch, att, smi, out):
    """Phase 12 (f): the sp hub's LLM names."""
    rounds, k = 16, 8
    cfg = dict(LLM_HUB_TINY, comm_round=rounds, frequency_of_the_test=10 ** 9)
    # the counted run: run_simulation as a user calls it, unfused, every
    # round evaluated at rounds 0 and 15
    args = sp_args(fedml_tpu_torch, **cfg)
    stager = build_sp(sp_args(fedml_tpu_torch, **cfg))
    steps = sum(stager._stage_round_arrays(r)[4] for r in range(rounds))
    n_eval = 2 * len(stager.dataset.test_batches()[0])
    layers = stager.model.module.cfg.n_layers
    del stager
    t0 = time.time()
    params, launches = counted(torch, att, lambda: fedml_tpu_torch
                               .run_simulation(backend="sp", args=args))
    rec = {"layers": layers, "padded_steps": steps,
           "run_simulation_s": time.time() - t0, "launches": launches}
    check_launches(f"(f) tiny_llama run_simulation, {rounds} rounds "
                   f"unfused (vmapped cohort: once a layer a step)",
                   launches, expect_launches(layers, steps + n_eval, steps))
    if not all(torch.isfinite(v).all() for v in params.values()):
        fail("(f) tiny_llama params not finite")
    rec["fusion"] = fused_vs_unfused(torch, fedml_tpu_torch,
                                     "(f) tiny_llama", cfg, k, rounds, k, smi)
    api = build_sp(sp_args(fedml_tpu_torch, **dict(cfg, comm_round=2)))
    api.train()
    pc = api.evaluate_per_client(batch_size=64)
    rec["per_client"] = {key: (v.tolist() if hasattr(v, "tolist") else v)
                         for key, v in pc.items()}
    say("llm", f"(f) FedAvgAPI.evaluate_per_client over "
               f"{len(pc['per_client_acc'])} clients: accuracy mean "
               f"{pc['acc_mean']:.4f}, std {pc['acc_std']:.4f}, min "
               f"{pc['acc_min']:.4f}, p10 {pc['acc_p10']:.4f}")
    if not finite(*pc["per_client_loss"].tolist()):
        fail("(f) per-client losses not finite")
    del api

    # llama at 7B widths, 1 layer, one round
    largs = sp_args(fedml_tpu_torch, **LLM_HUB_LLAMA)
    api = build_sp(largs)
    mcfg = api.model.module.cfg
    n_params = sum(v.numel() for v in api.state.global_params.values())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    m, launches = counted(torch, att, lambda: api.train_one_round(0))
    lsteps = int(m["allocated_steps"]) // api.clients_per_round
    rec["llama"] = {"dim": mcfg.dim, "layers": mcfg.n_layers,
                    "params": n_params, "loss": float(m["train_loss"]),
                    "s": time.time() - t0, "peak_gib": peak_gib(torch),
                    "padded_steps": lsteps, "launches": launches}
    say("llm", f"(f) llama at dim {mcfg.dim}, {mcfg.n_layers} layer, "
               f"{n_params:,} f32 params, 2 clients vmapped, seq "
               f"{LLM_HUB_LLAMA['seq_len']}: loss "
               f"{rec['llama']['loss']:.4f}, {rec['llama']['s']:.2f} s, "
               f"peak {rec['llama']['peak_gib']:.2f} GiB [{smi}]")
    check_launches("(f) llama round", launches,
                   expect_launches(mcfg.n_layers, lsteps, lsteps))
    if not finite(rec["llama"]["loss"]):
        fail("(f) llama round loss not finite")
    del api
    torch.cuda.empty_cache()
    out["hub"] = rec


def llm_card_cpu_phase(torch, fedml_tpu_torch, smi, out):
    """Phase 12 (g): card ≡ CPU at the CPU tests' sizes, f32, TF32 off."""
    import numpy as np
    from fedml_tpu_torch import data, model
    from fedml_tpu_torch.llm.moe import MoEMLP
    from fedml_tpu_torch.llm.trainer import CausalLMTrainer
    from fedml_tpu_torch.ops.xent import streaming_xent
    from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI

    rec = {}
    args = fedml_tpu_torch.init(fedml_tpu_torch.load_arguments().update(
        **LLM_SMALL_TRAINER), should_init_logs=False)
    ds, _ = data.load(args)
    cpu = CausalLMTrainer(args, ds, device="cpu")
    card = CausalLMTrainer(args, ds, device="cuda")
    with torch.no_grad():
        for p, q in zip(card.model.parameters(), cpu.model.parameters()):
            p.copy_(q)
    card.lora = {k: v.to("cuda") for k, v in cpu.lora.items()}
    cpu.train()
    card.train()
    lerr = max(abs(a - b) for a, b in zip(card.step_losses, cpu.step_losses))
    aerr = max(max_err(card.lora[k].cpu(), v) for k, v in cpu.lora.items())
    rec["trainer"] = {"loss": lerr, "adapters": aerr}
    ok = lerr <= 1e-5 and aerr <= 1e-4

    rng = np.random.default_rng(0)
    h = torch.tensor(rng.standard_normal((2, 12, 24)).astype(np.float32))
    w = torch.tensor((0.3 * rng.standard_normal((24, 70))).astype(np.float32))
    t = torch.tensor(rng.integers(0, 70, size=(2, 12)))
    res = {}
    for dev in ("cpu", "cuda"):
        hh = h.to(dev).requires_grad_(True)
        ww = w.to(dev).requires_grad_(True)
        loss = streaming_xent(hh, ww, t.to(dev), 16)
        res[dev] = (loss.item(), *[g.cpu() for g in torch.autograd.grad(
            loss, (hh, ww))])
    card_res = res["cuda"]
    xerr = {"loss": abs(res["cpu"][0] - card_res[0]),
            "dh": max_err(card_res[1], res["cpu"][1]),
            "dw": max_err(card_res[2], res["cpu"][2])}
    rec["xent"] = xerr
    ok &= xerr["loss"] <= 2e-6 and all(
        (card_res[i] - res["cpu"][i]).abs().le(
            1e-6 + 1e-5 * res["cpu"][i].abs()).all() for i in (1, 2))

    gen = torch.Generator().manual_seed(1)
    m_cpu = MoEMLP(16, 32, 4, 2)
    with torch.no_grad():
        for p in m_cpu.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    m_card = MoEMLP(16, 32, 4, 2).to("cuda")
    m_card.load_state_dict(m_cpu.state_dict())
    x = torch.randn((2, 8, 16), generator=gen)
    (o1, a1), (o2, a2) = m_cpu.forward_with_aux(x), \
        m_card.forward_with_aux(x.to("cuda"))
    rec["moe"] = {"out": max_err(o2.detach().cpu(), o1.detach()),
                  "aux": abs(a1.item() - a2.item())}
    ok &= rec["moe"]["out"] <= 1e-5 and rec["moe"]["aux"] <= 1e-6

    hargs = sp_args(fedml_tpu_torch, **LLM_SMALL_HUB)
    hds, n_out = data.load(hargs)
    apis = [FedAvgAPI(hargs, d, hds, model.create(hargs, n_out))
            for d in ("cuda", "cpu")]
    for r in range(LLM_SMALL_HUB["comm_round"]):
        for api in apis:
            api.train_one_round(r)
    herr = max(max_err(apis[0].state.global_params[k].cpu(), v)
               for k, v in apis[1].state.global_params.items())
    rec["hub"] = herr
    ok &= herr <= 1e-5
    say("llm", f"(g) card ≡ CPU, f32, TF32 off: trainer step losses "
               f"{lerr:.2e} (tol 1e-5) and adapters {aerr:.2e} (tol 1e-4); "
               f"streaming loss {xerr['loss']:.2e} (tol 2e-6), dh "
               f"{xerr['dh']:.2e}, dw {xerr['dw']:.2e} (tol 1e-6 + 1e-5 "
               f"rel); MoE {rec['moe']['out']:.2e} (tol 1e-5), aux "
               f"{rec['moe']['aux']:.2e} (tol 1e-6); tiny_llama sp rounds "
               f"{herr:.2e} (tol 1e-5)")
    if not ok:
        fail(f"(g) card and CPU disagree: {rec}")
    out["card_vs_cpu"] = rec


def llm_phase(torch, fedml_tpu_torch, att, smi):
    """Phase 12."""
    out = {}
    t0 = time.time()
    for name, fn in (("trainer", llm_trainer_phase),
                     ("rounds", llm_round_phase), ("hub", llm_hub_phase)):
        t1 = time.time()
        fn(torch, fedml_tpu_torch, att, smi, out)
        out.setdefault("seconds", {})[name] = time.time() - t1
    t1 = time.time()
    llm_xent_phase(torch, fedml_tpu_torch, smi, out)
    out["seconds"]["xent"] = time.time() - t1
    t1 = time.time()
    llm_card_cpu_phase(torch, fedml_tpu_torch, smi, out)
    out["seconds"]["card_vs_cpu"] = time.time() - t1
    out["seconds"]["all"] = time.time() - t0
    return out


# -- phase 13: the mesh engine ------------------------------------------------

#: phase 13 (a): the FEMNIST CNN rounds, each algorithm under both merge
#: layouts and every collective precision, beside the sp engine's.  FedOpt
#: runs its default server Adam at server_lr 0.01: at the default 1.0 its
#: first step moves every weight by about 1, and the CNN's loss read
#: 4.7e26 after one round (NaN at int8) in a CPU rehearsal
MESH_ALGS = {"FedAvg": {}, "SCAFFOLD": {}, "FedOpt": {"server_lr": 0.01}}
MESH_LAYOUTS = ("replicated", "scatter")
MESH_PRECISIONS = ("fp32", "bf16", "int8")
#: phase 13 (a): run_simulation on lr through each backend name
MESH_LR = dict(dataset="synthetic", num_classes=10, input_shape=(28, 28, 1),
               train_size=6000, test_size=1000, model="lr",
               client_num_in_total=100, client_num_per_round=10,
               batch_size=10, learning_rate=0.03, partition_method="homo",
               comm_round=2)
#: mesh ≡ sp on one card: the f32 rounds, and the quantized ones given the
#: same noise (the mesh's reducers normalise the weights first, as the sp
#: engine does, so a world of 1 sums in the sp engine's order)
MESH_TOL = 1e-6
#: the text transformer trains with Adam: held as phase 8 (e) holds it
MESH_TEXT_TOL = 1e-5
#: the LoRA parity limit (phase 4's card vs CPU)
MESH_LORA_TOL = 1e-4
#: seconds the process group's teardown may take
TEARDOWN_LIMIT = 60


def card_noise(torch):
    """``quant_noise`` drawing from seeded generators on the card: the same
    tensors for the sp engine and every shard of the mesh."""
    def hook(r, shard, slot, kind, shape):
        g = torch.Generator(device="cuda")
        g.manual_seed(1000 * r + slot)
        if kind == "uniform":
            return torch.rand(shape, generator=g, device="cuda")
        return torch.randint(0, 1 << 16, shape, generator=g, device="cuda",
                             dtype=torch.int64)
    return hook


def two_rounds(torch, api, after_first=None):
    """A warm round and a timed one: (losses, seconds of the second,
    ``after_first(api)`` read between them)."""
    losses = [float(api.train_one_round(0)["train_loss"])]
    first = after_first(api) if after_first else None
    torch.cuda.synchronize()
    t0 = time.time()
    losses.append(float(api.train_one_round(1)["train_loss"]))
    torch.cuda.synchronize()
    return losses, time.time() - t0, first


def params_err(a, b):
    return max(max_err(a[k], b[k]) for k in b)


def mesh_phase(torch, fedml_tpu_torch, att, smi):
    """Phase 13."""
    from fedml_tpu_torch import data, model
    from fedml_tpu_torch.core.mesh import make_mesh
    from fedml_tpu_torch.llm.configurations import (
        build_fedllm, llama2_7b_round_arguments)
    from fedml_tpu_torch.simulation.mesh.engine import MeshFedAvgAPI
    from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    out = {"seconds": {}}
    t_all = time.time()

    # (a) run_simulation through each backend name, on lr
    t1 = time.time()
    ref = fedml_tpu_torch.run_simulation(
        backend="sp", args=sp_args(fedml_tpu_torch, **MESH_LR))
    for b in ("mesh", "MPI", "NCCL"):
        got = fedml_tpu_torch.run_simulation(
            backend=b, args=sp_args(fedml_tpu_torch, **MESH_LR))
        err = params_err(got, ref)
        say("mesh", f"run_simulation(backend={b!r}) on lr: params vs sp "
                    f"{err:.2e} (tol {MESH_TOL:g})")
        if err > MESH_TOL:
            fail(f"mesh: backend {b!r} disagrees with sp ({err:.2e})")
    if not (dist.is_initialized() and dist.get_world_size() == 1
            and "nccl" in str(dist.get_backend()).lower()):
        fail("mesh: the process group is not a world of 1 over NCCL")
    out["process_group"] = {"backend": str(dist.get_backend()),
                            "world": dist.get_world_size()}
    check_policy(torch, "mesh")

    # (a) the FEMNIST CNN grid
    args0 = sp_args(fedml_tpu_torch, **SP_FEMNIST_CNN)
    dataset, out_dim = data.load(args0)
    cnn = model.create(args0, out_dim)
    grid = out["femnist"] = {}
    for alg, extra in MESH_ALGS.items():
        for prec in MESH_PRECISIONS:
            cfg = dict(SP_FEMNIST_CNN, federated_optimizer=alg,
                       collective_precision=prec, **extra)
            sp = FedAvgAPI(sp_args(fedml_tpu_torch, **cfg), dev, dataset,
                           cnn)
            sp.quant_noise = card_noise(torch) if prec != "fp32" else None
            # the quantized sp engine's fp32 master after round 0
            sp_losses, sp_s, sp_master = two_rounds(
                torch, sp, lambda a: a.flat.unflatten(a.state.master_flat)
                if prec != "fp32" else None)
            for lay in MESH_LAYOUTS:
                api = MeshFedAvgAPI(sp_args(fedml_tpu_torch, backend="mesh",
                                            update_sharding=lay, **cfg),
                                    dev, dataset, cnn)
                api.quant_noise = sp.quant_noise
                # the replicated layout quantizes only the numerator (it has
                # no broadcast): after round 0 its fp32 params are the sp
                # engine's master, the same noise given; later rounds start
                # from different copies (fp32 here, the quantized broadcast
                # there), so round 0 is the exact check
                partial = prec != "fp32" and lay == "replicated"
                losses, s, first = two_rounds(
                    torch, api, lambda a: {k: v.clone() for k, v in
                                           a.state.global_params.items()}
                    if partial else None)
                api._stager.close()
                if partial:
                    err = params_err(first, sp_master)
                    loss_err = abs(losses[0] - sp_losses[0])
                else:
                    err = params_err(api.state.global_params,
                                     sp.state.global_params)
                    loss_err = max(abs(a - b)
                                   for a, b in zip(losses, sp_losses))
                ok = err <= MESH_TOL and loss_err <= MESH_TOL and all(
                    x == x and abs(x) < float("inf") for x in losses)
                key = f"{alg}/{lay}/{prec}"
                grid[key] = {"losses": losses, "s_per_round": s,
                             "sp_s_per_round": sp_s, "params_err": err,
                             "loss_err": loss_err,
                             "compared": "round 0 vs the sp master"
                             if partial else "2 rounds"}
                say("mesh", f"FEMNIST CNN {key}: losses {losses[0]:.4f} "
                            f"{losses[1]:.4f}; vs sp "
                            f"({grid[key]['compared']}) params {err:.2e}, "
                            f"losses {loss_err:.2e} (tol {MESH_TOL:g}); "
                            f"{s:.4f} s a round, sp {sp_s:.4f} [{smi}]")
                if not ok:
                    fail(f"mesh: {key} disagrees with the sp engine")
                del api
            del sp
    out["seconds"]["femnist"] = time.time() - t1

    # (b) the text transformer at realtext: mesh ≡ sp, same launches
    t1 = time.time()
    text = out["text"] = {}
    runs = {}
    for name, over in (("sp", {}), ("mesh", {"backend": "mesh"})):
        api = build_sp(sp_args(fedml_tpu_torch, **dict(
            TEXT_REALTEXT, comm_round=2, **over)))
        att.reset_launch_counts()
        losses, s, _ = two_rounds(torch, api)
        launches = {f.__name__.replace("flash_attention", "flash"):
                    f.launches for f in att.KERNELS}
        runs[name] = api
        text[name] = {"losses": losses, "s_per_round": s,
                      "launches": launches}
        if name == "mesh":
            api._stager.close()
    err = params_err(runs["mesh"].state.global_params,
                     runs["sp"].state.global_params)
    text["params_err"] = err
    say("mesh", f"text (realtext, 2 rounds): mesh vs sp params {err:.2e} "
                f"(tol {MESH_TEXT_TOL:g}); launches mesh "
                f"{text['mesh']['launches']}, sp {text['sp']['launches']}; "
                f"{text['mesh']['s_per_round']:.4f} s a round, sp "
                f"{text['sp']['s_per_round']:.4f} [{smi}]")
    if err > MESH_TEXT_TOL:
        fail(f"mesh: text rounds disagree with sp ({err:.2e})")
    if text["mesh"]["launches"] != text["sp"]["launches"] or \
            not all(text["mesh"]["launches"].values()):
        fail("mesh: the text rounds' K1-K3 launches differ from sp's")
    del runs
    out["seconds"]["text"] = time.time() - t1

    # (c) FedLLMAPI(mesh=...) at the LoRA slice's widths, 2 layers
    t1 = time.time()
    lora = out["lora"] = {}
    apis = {}
    for name, mesh in (("single", None), ("mesh", make_mesh(client=1))):
        args = llama2_7b_round_arguments(2)
        args.update(comm_round=1)
        api = apis[name] = build_fedllm(args, device="cuda", mesh=mesh)
        att.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        m = api.train_one_round(0)
        torch.cuda.synchronize()
        lora[name] = {"loss": m["train_loss"], "steps": m["steps"],
                      "seconds": time.time() - t0,
                      "launches": {f.__name__.replace("flash_attention",
                                                      "flash"): f.launches
                                   for f in att.KERNELS}}
    err = params_err(apis["mesh"].global_lora, apis["single"].global_lora)
    lora["adapters_err"] = err
    say("mesh", f"FedLLMAPI(mesh=make_mesh(client=1)), Llama-2-7B widths, "
                f"2 layers: adapters vs single device {err:.2e} (tol "
                f"{MESH_LORA_TOL:g}); loss {lora['mesh']['loss']:.4f} vs "
                f"{lora['single']['loss']:.4f}; launches "
                f"{lora['mesh']['launches']} vs {lora['single']['launches']};"
                f" {lora['mesh']['seconds']:.2f} s vs "
                f"{lora['single']['seconds']:.2f} s [{smi}]")
    if err > MESH_LORA_TOL or lora["mesh"]["launches"] != \
            lora["single"]["launches"] or \
            not all(lora["mesh"]["launches"].values()):
        fail("mesh: the LoRA mesh round disagrees with the single-device "
             "round")
    del apis
    torch.cuda.empty_cache()
    out["seconds"]["lora"] = time.time() - t1

    # (d) round_block on the mesh: the merge's NCCL calls in the graph
    t1 = time.time()
    fused = out["fused"] = {}
    k, rounds = 4, 8
    cfg = dict(SP_FEMNIST_CNN, federated_optimizer="SCAFFOLD",
               backend="mesh", update_sharding="scatter", comm_round=rounds)
    apis = {}
    for name, rb in (("unfused", 1), ("fused", k)):
        api = apis[name] = build_sp(sp_args(fedml_tpu_torch, round_block=rb,
                                            **cfg))
        run = run_unfused if rb == 1 else run_blocks
        run(api, 0, k)
        dt, _ = sync_time(torch, lambda: run(api, k, rounds))
        fused[name] = {"s_per_round": dt / (rounds - k)}
        api._stager.close()
        if api._block_stager is not None:
            api._block_stager.close()
    u, f = apis["unfused"], apis["fused"]
    us, fs = u.full_state(), f.full_state()
    err = max(params_err(fs.global_params, us.global_params),
              max_err(fs.c_server, us.c_server),
              params_err(f.full_client_table(), u.full_client_table()))
    captures = f._block_fn.captures
    # the graphs hold the NCCL communicator the teardown destroys
    f._block_fn.release()
    fused.update(max_abs_err=err, graphs_captured=captures)
    say("mesh", f"round_block {k} on the mesh (FEMNIST SCAFFOLD, scatter, "
                f"{rounds} rounds): fused vs unfused params, c_server and "
                f"table {err:.2e} (tol {FUSED_TOL:g}); {captures} graph(s) "
                f"captured; {fused['unfused']['s_per_round']:.4f} vs "
                f"{fused['fused']['s_per_round']:.4f} s a round [{smi}]")
    if err > FUSED_TOL or not captures:
        fail("mesh: fused and unfused mesh rounds disagree, or no graph")
    out["seconds"]["fused"] = time.time() - t1
    out["seconds"]["all"] = time.time() - t_all
    return out


# -- 14. serving ----------------------------------------------------------
SERVE_SLOTS = 8
SERVE_BUF = 1024
SERVE_REQUESTS = 16
SERVE_NEW = 64
SERVE_PROMPTS = (32, 900)        # byte-tokenized prompt lengths, spread
SERVE_PAGE = 16
SERVE_CHUNK = 64
SERVE_ADAPTERS = 8
SERVE_LORA_RANK = 8
#: phases 14-15's depth cap: the run's 1200 s leave room for phase 20 only
#: with serving cut from 32 layers to 16 (widths and checks unchanged;
#: PERF.md §4)
SERVE_LAYERS = 16
SERVE_ADAPTER_NEW = 16
#: (d): new tokens of the prefix-sharing and parked-pool checks (a check
#: of pages, not of throughput: the 16-request run times the engine)
SERVE_SHORT_NEW = 16
SERVE_GEN_BUF = 256              # (a): the plain step re-runs this buffer
SERVE_GEN_NEW = 32
#: (b): requests whose engine stream is also held to ``generate``'s (the
#: witness scores every token of every request's stream)
SERVE_GEN_REFS = 2
SERVE_INT8_NEW = 16
SERVE_TINY_TOL = 1e-5
#: an int8 code that parts from the CPU's at a rounding tie moves one K or V
#: entry by one step: the logits of that row are then held to this
SERVE_INT8_TIE_TOL = 1e-3
#: int8 KV against native: relative error of one layer's attention output
SERVE_INT8_ATTN_TOL = 5e-2
#: every greedy token of every stream below is held to the f32 witness (the
#: same weights upcast to f32, exactly, through the plain forward with TF32
#: off), teacher-forced on that stream: the witness's logit of the token
#: must lie within the limit of its top logit.  The limit is this factor
#: times the largest logit distance of the bf16 plain forward (a path this
#: phase does not test) from the witness: a bf16 path within that distance
#: of the witness gives its greedy token a witness gap of at most twice it.
#: Two paths' logit difference on identical inputs is held to the same
#: limit, and a stream scored against another request's prompt must fail it
SERVE_TIE_FACTOR = 2.0
#: the share of the control's tokens that must fail the limit
SERVE_CONTROL_MIN = 0.5


def serve_prompts(np, tok, n, lo, hi, seed):
    """``n`` byte-tokenized prompts of ``lo..hi`` tokens (BOS included),
    printable ASCII from a seeded generator, lengths spread evenly and
    shuffled."""
    rng = np.random.default_rng(seed)
    lengths = rng.permutation(np.linspace(lo, hi, n).astype(int))
    return [tok.encode("".join(chr(c) for c in rng.integers(32, 127, m - 1)))
            for m in lengths]


def logits_gap(a, b):
    return (a.float() - b.float()).abs().max().item()


def decode_logits(torch, model, ids, dev, lora=None, **cache_kw):
    """Teacher-forced logits of one row over ``ids`` by the decode path."""
    cache = model.init_cache(1, dev, **cache_kw)
    with torch.no_grad():
        return model(torch.tensor([ids], device=dev), lora, decode=True,
                     start_pos=0, cache=cache)[0]


class Witness:
    """The f32 witness of a bf16 model: its weights upcast to f32 (exact)
    in a model of the same widths, run by the plain forward (no cache,
    blockwise attention) with TF32 off."""

    def __init__(self, torch, lm, model, dev):
        import dataclasses
        self.torch, self.dev = torch, dev
        cfg = dataclasses.replace(model.cfg, dtype=torch.float32)
        with torch.device("meta"):
            self.model = lm.LlamaLM(cfg)
        self.model.load_state_dict(
            {k: v.float() for k, v in model.state_dict().items()},
            assign=True)
        self.gaps = {}

    def logits(self, ids, lora=None):
        torch = self.torch
        lora = {k: v.float() for k, v in lora.items()} if lora else None
        with torch.no_grad():
            return self.model(torch.tensor([ids], device=self.dev), lora)[0]

    def stream_gaps(self, prompt, toks, lora=None, key=None):
        """Teacher-forced on ``toks``: the witness's top logit less its logit
        of each token, at the position that chose it."""
        memo = (tuple(prompt), tuple(toks), key)
        if memo not in self.gaps:
            torch = self.torch
            logits = self.logits(prompt + toks[:-1], lora)[len(prompt) - 1:]
            chosen = logits.gather(
                -1, torch.tensor(toks, device=self.dev)[:, None])[:, 0]
            self.gaps[memo] = (logits.max(-1).values - chosen).tolist()
        return self.gaps[memo]


def check_streams(wit, limit, out, tag, prompts, want, got, loras=None):
    """Every token of both streams of each request within ``limit`` of the
    witness's top logit, teacher-forced on its own stream (so tokens after
    a parting are checked too); records each parting with both tokens'
    witness gaps, and fails on a token off the limit.  ``loras``: one
    (name, adapter) a request, or None."""
    parted, worst, n = 0, 0.0, 0
    for r, (p, w, g) in enumerate(zip(prompts, want, got)):
        key = loras[r][0] if loras else None
        lora = loras[r][1] if loras else None
        gw = wit.stream_gaps(p, w, lora, key)
        gg = wit.stream_gaps(p, g, lora, key)
        for name, gaps, toks in (("reference", gw, w), ("tested", gg, g)):
            j = max(range(len(gaps)), key=gaps.__getitem__)
            if gaps[j] > limit:
                fail(f"serving {tag}: request {r}'s {name} stream's token "
                     f"{j} ({toks[j]}) is {gaps[j]:.3e} under the witness's "
                     f"top logit, limit {limit:.3e}")
        worst = max(worst, *gw, *gg)
        n += len(g)
        if w == g:
            continue
        i = next((j for j in range(min(len(w), len(g))) if w[j] != g[j]),
                 None)
        if i is None:
            fail(f"serving {tag}: request {r} lengths {len(g)} vs {len(w)}")
        parted += 1
        out["ties"].append({"path": tag, "request": r, "step": i,
                            "want": w[i], "got": g[i], "gap_want": gw[i],
                            "gap_got": gg[i], "limit": limit})
        say("serving", f"{tag}: request {r} parts at token {i} ({g[i]} for "
                       f"{w[i]}): witness gaps {gw[i]:.3e} and {gg[i]:.3e}, "
                       f"limit {limit:.3e}")
    say("serving", f"{tag}: {len(want) - parted}/{len(want)} requests equal "
                   f"token for token, {parted} parted at near ties; all "
                   f"{n} tested tokens (and the reference's) within "
                   f"{worst:.3e} of the witness's top logit, limit "
                   f"{limit:.3e}")
    return parted


def run_engine(torch, eng, prompts, new, adapters=None):
    """All requests submitted at once, each drained on its own thread:
    (tokens, wall seconds to the last token, seconds to each first
    token)."""
    adapters = adapters or [None] * len(prompts)
    outs = [[] for _ in prompts]
    first = [None] * len(prompts)
    torch.cuda.synchronize()
    t0 = time.time()
    qs = [eng.submit(p, max_new_tokens=new, adapter=a)
          for p, a in zip(prompts, adapters)]

    def drain(i, q):
        while True:
            t = q.get(timeout=600)
            if t is None:
                return
            if first[i] is None:
                first[i] = time.time() - t0
            outs[i].append(t)

    threads = [threading.Thread(target=drain, args=(i, q), daemon=True)
               for i, q in enumerate(qs)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
        if th.is_alive():
            fail("serving: an engine request did not finish in 900 s")
    return outs, time.time() - t0, first


def saturated_adapters(torch, model, n, dev):
    """``n`` LoRA adapters with A ~ N(0, 1/in) and B ~ N(0, 1/(4r)), both
    non-zero (a zero B would let a wrong-row gather pass), from seeds."""
    out = []
    for i in range(n):
        g = torch.Generator(device=dev)
        g.manual_seed(100 + i)
        lora = {}
        for k, shape in model.lora_shapes().items():
            fan = shape[0] if k.endswith("/A") else 4 * shape[0]
            lora[k] = torch.randn(shape, generator=g, device=dev) * fan ** -0.5
        out.append(lora)
    return out


class IdTokenizer:
    """The byte tokenizer's encoding; decodes every id as ``" <id>"``, so
    a random model's tokens (mostly past the 256 bytes) show as text."""

    eos_id = 257

    def encode(self, text):
        return [256] + list(text.encode("utf-8"))

    def decode(self, ids):
        return "".join(f" {int(i)}" for i in ids)


def serve_http(port, path, payload):
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def serving_tiny_card_vs_cpu(torch, lm, out):
    """(g): TINY in f32, the dense, int8 and paged decode paths' logits on
    the card against the CPU's from the same weights, prefill + 4 steps."""
    import dataclasses
    errs = {}
    for kv in ("native", "int8"):
        for paged in (False, True):
            over = dict(kv_cache_dtype=kv)
            if paged:
                over.update(kv_page_tokens=8, kv_pool_pages=12)
            cfg = dataclasses.replace(lm.TINY, max_seq_len=64, **over)
            cpu = lm.LlamaLM(cfg)
            cpu.init_weights(torch.Generator().manual_seed(7))
            card = lm.LlamaLM(cfg).cuda()
            card.load_state_dict(cpu.state_dict())
            gen = torch.Generator().manual_seed(8)
            toks = torch.randint(0, cfg.vocab_size, (2, 20), generator=gen)
            bt = torch.tensor([[3, 1, 7, 6], [2, 5, 4, 9]])
            caches = {m: m.init_cache(2) for m in (cpu, card)}
            worst, tie = 0.0, False
            for s0, s1 in ((0, 16), (16, 17), (17, 18), (18, 19), (19, 20)):
                got = {}
                for m, dev in ((cpu, "cpu"), (card, "cuda")):
                    kw = {"block_tables": bt.to(dev),
                          "start_pos": torch.full((2,), s0, device=dev)} \
                        if paged else {"start_pos": s0}
                    with torch.no_grad():
                        got[dev] = m(toks[:, s0:s1].to(dev), decode=True,
                                     cache=caches[m], **kw).cpu()
                if kv == "int8":
                    tie = tie or any(
                        not torch.equal(a[k].cpu(), b[k].cpu())
                        for a, b in zip(caches[cpu].layers,
                                        caches[card].layers)
                        for k in ("k", "v"))
                worst = max(worst, logits_gap(got["cuda"], got["cpu"]))
            tol = SERVE_INT8_TIE_TOL if tie else SERVE_TINY_TOL
            name = f"{kv}{'_paged' if paged else ''}"
            errs[name] = worst
            say("serving", f"(g) TINY f32 {name}: card vs CPU decode logits "
                           f"max abs diff {worst:.2e} (tol {tol:g}"
                           f"{'; an int8 code parted at a rounding tie' if tie else ''})")
            if worst > tol:
                fail(f"serving (g): {name} card and CPU disagree")
    out["card_vs_cpu"] = errs


def serving_phase(torch, fedml_tpu_torch, att, smi, layers):
    """Phase 14."""
    import dataclasses

    import numpy as np

    from fedml_tpu_torch.core.memory_estimate import (
        estimate_paged_serving_memory, estimate_serving_memory)
    from fedml_tpu_torch.llm import model as lm
    from fedml_tpu_torch.serving import ContinuousBatchingEngine
    from fedml_tpu_torch.serving.templates import openai_compat as oc

    dev = torch.device("cuda", 0)
    out = {"seconds": {}, "ties": [], "layers": layers}
    # the streams and the paths' logit differences, held to the witness
    # once every engine has stopped
    checks, deltas = [], {}
    t_phase = time.time()
    cfg = dataclasses.replace(lm.LLAMA2_7B, n_layers=layers,
                              lora_rank=SERVE_LORA_RANK, attn_impl="blockwise")
    with torch.device(dev):
        model = lm.LlamaLM(cfg)
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    say("serving", f"Llama-2-7B widths (dim {cfg.dim}, {cfg.n_heads} heads, "
                   f"{cfg.n_kv_heads} KV heads, ffn {cfg.ffn_dim}, vocab "
                   f"{cfg.vocab_size}, bf16, max_seq_len {cfg.max_seq_len}), "
                   f"depth {layers} of 32, {n_params / 1e9:.2f} B params, "
                   f"random weights from seed 0 [{smi}]")
    tok = oc.ByteTokenizer()

    # (a) generate: KV-cached decode against the plain full-buffer step
    t0 = time.time()
    prompt = serve_prompts(np, tok, 1, 64, 64, 1)[0]
    apply_fn = lambda params, tokens: model(tokens)
    times = {}
    for name, kw in (("cached", {"model": model}),
                     ("plain", {"device": dev})):
        oc.generate(apply_fn, None, prompt, max_new_tokens=2,
                    buf_len=SERVE_GEN_BUF, **kw)          # warm
        torch.cuda.synchronize()
        t1 = time.time()
        toks = oc.generate(apply_fn, None, prompt,
                           max_new_tokens=SERVE_GEN_NEW,
                           buf_len=SERVE_GEN_BUF, **kw)
        torch.cuda.synchronize()
        times[name] = ((time.time() - t1) * 1e3 / len(toks), toks)
    with torch.no_grad():
        ids = prompt + times["plain"][1]
        plain = model(torch.tensor([ids], device=dev))[0]
    deltas["(a) plain step vs decode"] = logits_gap(
        plain, decode_logits(torch, model, ids, dev, page_tokens=0))
    checks.append(("generate", "(a) generate vs plain step", [prompt],
                   [times["plain"][1]], [times["cached"][1]]))
    out["generate"] = {"ms_per_token": times["cached"][0],
                       "plain_ms_per_token": times["plain"][0],
                       "logit_delta": deltas["(a) plain step vs decode"]}
    say("serving", f"(a) generate: {times['cached'][0]:.1f} ms/token cached "
                   f"vs {times['plain'][0]:.1f} ms/token re-running the "
                   f"{SERVE_GEN_BUF}-token buffer [{smi}]")
    out["seconds"]["a"] = time.time() - t0

    # (b) the dense engine: the first requests against generate, horizon
    # 4 ≡ 1
    t0 = time.time()
    prompts = serve_prompts(np, tok, SERVE_REQUESTS, *SERVE_PROMPTS, 2)
    refs = [oc.generate(None, None, p, max_new_tokens=SERVE_NEW,
                        buf_len=SERVE_BUF, model=model)
            for p in prompts[:SERVE_GEN_REFS]]
    # the batched step against one-row steps on identical inputs
    ids = prompts[0][:64]
    with torch.no_grad():
        one = decode_logits(torch, model, ids, dev, page_tokens=0)
        cache = model.init_cache(SERVE_SLOTS, dev, page_tokens=0)
        many = model(torch.tensor([ids] * SERVE_SLOTS, device=dev),
                     decode=True, start_pos=0, cache=cache)
        del cache
    delta_b = max(logits_gap(many[i], one) for i in range(SERVE_SLOTS))
    deltas["(b) 8 rows vs 1"] = delta_b
    engines = {}
    for horizon in (1, 4):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eng = ContinuousBatchingEngine(model, None, slots=SERVE_SLOTS,
                                       buf_len=SERVE_BUF, horizon=horizon)
        got, wall, first = run_engine(torch, eng, prompts, SERVE_NEW)
        peak = torch.cuda.max_memory_allocated()
        ticks = eng.kv_stats()["ticks"]
        rec = {"horizon": horizon, "wall_s": wall, "ticks": ticks,
               "tokens": sum(map(len, got)),
               "tokens_per_s": sum(map(len, got)) / wall,
               "ttft_s_median": float(np.median(first)),
               "ttft_s_first_wave_max": max(first[:SERVE_SLOTS]),
               "ttft_s_max": max(first), "peak_gib": peak / 2 ** 30}
        if horizon == 1:
            est = estimate_serving_memory(
                n_params=n_params, n_slots=SERVE_SLOTS,
                cache_bytes=eng._caches.nbytes(), vocab_size=cfg.vocab_size,
                horizon=horizon, param_bytes=2)
            rec["estimate_gib"] = est["total_gib"]
            rec["cache_gib"] = eng._caches.nbytes() / 2 ** 30
            _, fn, args = eng.step_programs()[0]
            with torch.no_grad():
                fn(*args)
                sec, _ = sync_time(torch, lambda: [fn(*args)
                                                   for _ in range(5)])
                prof = profile_rounds(torch, lambda: fn(*args), 1)
            rec["step_ms"] = sec * 1e3 / 5
            rec["step_launches"] = prof["host_launches"]
            rec["step_kernels"] = prof["device_kernels"]
            rec["step_busy_ms"] = prof["busy_s"] * 1e3
            # the least time: the weights (of the embedding table only
            # the slots' rows), and every slot's whole max_seq_len cache
            # (K and V), read once a step
            embed = model.tok_embed.embedding.numel()
            step_bytes = 2 * (n_params - embed + SERVE_SLOTS * cfg.dim) \
                + eng._caches.nbytes()
            rec["step_bound_ms"] = step_bytes / PEAK_BYTES * 1e3
            del fn, args                # they hold the engine's cache
        eng.stop()
        del eng
        torch.cuda.empty_cache()
        engines[horizon] = (got, rec)
        say("serving", f"(b) dense engine, {SERVE_SLOTS} slots, buf_len "
                       f"{SERVE_BUF}, horizon {horizon}: {SERVE_REQUESTS} "
                       f"requests x {SERVE_NEW} tokens in {wall:.2f} s = "
                       f"{rec['tokens_per_s']:.1f} tokens/s; time to first "
                       f"token median {rec['ttft_s_median']:.3f} s, first "
                       f"wave max {rec['ttft_s_first_wave_max']:.3f} s; "
                       f"{ticks} step calls; peak {rec['peak_gib']:.2f} GiB"
                       f" [{smi}]")
    b1 = engines[1][1]
    say("serving", f"(b) decode step (8 slots, horizon 1): {b1['step_ms']:.2f}"
                   f" ms, {b1['step_launches']:.0f} host launch calls, "
                   f"{b1['step_kernels']:.0f} device kernels, device busy "
                   f"{b1['step_busy_ms']:.2f} ms; bound {b1['step_bound_ms']:.2f}"
                   f" ms (weights, {SERVE_SLOTS} embedding rows and "
                   f"{SERVE_SLOTS} whole caches at "
                   f"{PEAK_BYTES / 1e12:.2f} TB/s) [{smi}]")
    say("serving", f"(b) peak {b1['peak_gib']:.2f} GiB vs "
                   f"estimate_serving_memory {b1['estimate_gib']:.2f} GiB "
                   f"(caches {b1['cache_gib']:.2f} GiB)")
    base = engines[1][0]    # the streams (c), (e) and the control read
    checks.append(("dense_engine", "(b) engine vs generate",
                   prompts[:SERVE_GEN_REFS], refs,
                   base[:SERVE_GEN_REFS]))
    checks.append(("dense_engine", "(b) horizon 4 vs 1", prompts,
                   engines[1][0], engines[4][0]))
    out["dense_engine"] = {"h1": engines[1][1], "h4": engines[4][1],
                           "logit_delta": delta_b}
    out["seconds"]["b"] = time.time() - t0

    # (c) int8 KV against native, on the same weights
    t0 = time.time()
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    with torch.device("meta"):
        model8 = lm.LlamaLM(cfg8)
    model8.load_state_dict(model.state_dict(), assign=True)
    with torch.no_grad():
        x = model.tok_embed(torch.tensor([prompts[1]], device=dev))
        x = model.layer_0.attn_norm(x)
        pos = torch.arange(x.shape[1], device=dev)
        o = {}
        for name, m in (("native", model), ("int8", model8)):
            c = m.init_cache(1, dev, page_tokens=0)
            ctx = lm._DecodeCtx(pos, 0, c, None, m.cfg, 1, x.shape[1])
            o[name] = m.layer_0.attention(x, pos, None, c.layers[0],
                                          ctx).float()
    attn_err = ((o["int8"] - o["native"]).norm()
                / o["native"].norm()).item()
    n8 = SERVE_SLOTS // 2
    toks8 = [oc.generate(None, None, p, max_new_tokens=SERVE_INT8_NEW,
                         buf_len=SERVE_BUF, model=model8)
             for p in prompts[:n8]]
    same = sum(a == b[:SERVE_INT8_NEW] for a, b in zip(toks8, base[:n8]))
    first_same = sum(a[:1] == b[:1] for a, b in zip(toks8, base[:n8]))
    out["int8"] = {"attn_rel_err": attn_err, "requests_equal": same,
                   "first_token_equal": first_same, "requests": n8}
    say("serving", f"(c) int8 KV: layer-0 attention output relative error "
                   f"{attn_err:.3e} (tol {SERVE_INT8_ATTN_TOL:g}); greedy "
                   f"tokens equal to native on {same}/{n8} requests over "
                   f"{SERVE_INT8_NEW} tokens, first token on {first_same}/{n8}")
    if not attn_err < SERVE_INT8_ATTN_TOL:
        fail("serving (c): int8 KV attention error above its tolerance")
    del model8
    out["seconds"]["c"] = time.time() - t0

    # (d) the paged engine: against the dense engine, prefix pages shared,
    # every page free after the drain, a parked request completes
    t0 = time.time()
    with torch.no_grad():
        ids = prompts[0][:200]
        dense_l = decode_logits(torch, model, ids, dev, page_tokens=0)
        pool = model.init_cache(0, dev, page_tokens=SERVE_PAGE,
                                pool_pages=1 + SERVE_BUF // SERVE_PAGE)
        bt = torch.arange(1, 1 + SERVE_BUF // SERVE_PAGE,
                          device=dev)[None]
        paged_l = model(torch.tensor([ids], device=dev), decode=True,
                        start_pos=torch.zeros(1, dtype=torch.long,
                                              device=dev),
                        cache=pool, block_tables=bt)[0]
        del pool
    deltas["(d) paged vs dense"] = logits_gap(paged_l, dense_l)
    torch.cuda.reset_peak_memory_stats()
    eng = ContinuousBatchingEngine(model, None, slots=SERVE_SLOTS,
                                   buf_len=SERVE_BUF,
                                   kv_page_tokens=SERVE_PAGE,
                                   prefill_chunk_tokens=SERVE_CHUNK,
                                   prefix_cache_slots=SERVE_SLOTS)
    got, wall, first = run_engine(torch, eng, prompts, SERVE_NEW)
    peak = torch.cuda.max_memory_allocated()
    pool_bytes = eng._pool.nbytes()
    hd = cfg.dim // cfg.n_heads
    est = estimate_paged_serving_memory(
        n_params=n_params, n_slots=SERVE_SLOTS, pool_bytes=pool_bytes,
        block_table_bytes=eng._btabs.nbytes,
        window_bytes=2 * 2 * SERVE_SLOTS * cfg.n_kv_heads
        * eng.max_blocks * SERVE_PAGE * hd * 2,
        vocab_size=cfg.vocab_size, param_bytes=2)
    checks.append(("paged_engine", "(d) paged vs dense engine", prompts,
                   engines[1][0], got))
    shared0 = eng.kv_stats()["pages_shared"]
    first_p = eng.generate(prompts[0], max_new_tokens=SERVE_SHORT_NEW)
    again = eng.generate(prompts[0], max_new_tokens=SERVE_SHORT_NEW)
    kv = eng.kv_stats()
    checks.append(("paged_engine", "(d) prefix pages shared", [prompts[0]],
                   [first_p], [again]))
    if not kv["pages_shared"] > shared0:
        fail("serving (d): no prefix page was shared")
    eng.prefix_cache.clear()
    kv_after = eng.kv_stats()
    if kv_after["pages_free"] != kv_after["pool_pages"] - 1:
        fail(f"serving (d): {kv_after['pages_free']} pages free of "
             f"{kv_after['pool_pages'] - 1} after the drain")
    rec = {"wall_s": wall, "tokens_per_s": sum(map(len, got)) / wall,
           "ttft_s_median": float(np.median(first)),
           "peak_gib": peak / 2 ** 30, "estimate_gib": est["total_gib"],
           "pool_gib": pool_bytes / 2 ** 30,
           "pool_pages": kv["pool_pages"], "pages_shared": kv["pages_shared"],
           "prefill_chunks": kv["prefill_chunks"], "ticks": kv["ticks"],
           "logit_delta": deltas["(d) paged vs dense"]}
    _, fn, args = eng.step_programs()[0]
    with torch.no_grad():
        fn(*args)
        sec, _ = sync_time(torch, lambda: [fn(*args) for _ in range(5)])
    rec["step_ms"] = sec * 1e3 / 5
    del fn, args
    eng.stop()
    del eng
    torch.cuda.empty_cache()
    # a pool for about one and a half of the longest requests: the rest park
    long = sorted(prompts, key=len)[-3:]
    need = -(-min(len(long[-1]) + SERVE_SHORT_NEW, SERVE_BUF) // SERVE_PAGE)
    eng = ContinuousBatchingEngine(model, None, slots=3, buf_len=SERVE_BUF,
                                   kv_page_tokens=SERVE_PAGE,
                                   kv_pool_pages=1 + need + need // 2,
                                   prefill_chunk_tokens=SERVE_CHUNK)
    parked, _, _ = run_engine(torch, eng, long, SERVE_SHORT_NEW)
    kv = eng.kv_stats()
    eng.stop()
    del eng
    # the dense engine's streams, as far as the parked requests decode
    ref_long = [engines[1][0][prompts.index(p)][:SERVE_SHORT_NEW]
                for p in long]
    checks.append(("paged_engine", "(d) parked vs dense", long, ref_long,
                   parked))
    if not kv["pool"]["exhausted"] > 0:
        fail("serving (d): the small pool never ran dry")
    if kv["pages_free"] != kv["pool_pages"] - 1:
        fail("serving (d): pages left held after the parked drain")
    rec["parked_exhausted"] = kv["pool"]["exhausted"]
    out["paged_engine"] = rec
    say("serving", f"(d) paged engine ({SERVE_PAGE}-token pages, "
                   f"{SERVE_CHUNK}-token chunks, {rec['pool_pages']} pages "
                   f"= {rec['pool_gib']:.2f} GiB): {wall:.2f} s = "
                   f"{rec['tokens_per_s']:.1f} tokens/s, TTFT median "
                   f"{rec['ttft_s_median']:.3f} s, step {rec['step_ms']:.2f} "
                   f"ms, {rec['prefill_chunks']} chunks; "
                   f"{rec['pages_shared']} prefix pages shared, every page "
                   f"free after the drain; a pool of {1 + need + need // 2} "
                   f"pages ran dry {rec['parked_exhausted']} times and its "
                   f"parked requests completed; peak {rec['peak_gib']:.2f} "
                   f"GiB vs estimate {rec['estimate_gib']:.2f} GiB [{smi}]")
    out["seconds"]["d"] = time.time() - t0

    # (e) the adapter bank: 8 saturated adapters mixed with base traffic
    t0 = time.time()
    loras = saturated_adapters(torch, model, SERVE_ADAPTERS, dev)
    names = [f"a{i}" for i in range(SERVE_ADAPTERS)]
    # even requests on an adapter (each adapter twice), odd ones base
    mix = [names[(i // 2) % SERVE_ADAPTERS] if i % 2 == 0 else None
           for i in range(SERVE_REQUESTS)]
    lora_of = lambda a: loras[names.index(a)] if a else None
    refs_e = [oc.generate(None, None, p, max_new_tokens=SERVE_ADAPTER_NEW,
                          buf_len=SERVE_BUF, model=model, lora=lora_of(a))
              for p, a in zip(prompts, mix)]
    # grouped (3-D) adapters on 8 identical rows against the 2-D apply
    with torch.no_grad():
        ids = prompts[0][:64]
        one = decode_logits(torch, model, ids, dev, loras[0], page_tokens=0)
        cache = model.init_cache(SERVE_SLOTS, dev, page_tokens=0)
        grouped = {k: v[None].expand(SERVE_SLOTS, *v.shape)
                   for k, v in loras[0].items()}
        many = model(torch.tensor([ids] * SERVE_SLOTS, device=dev), grouped,
                     decode=True, start_pos=0, cache=cache)
        del cache
    deltas["(e) grouped adapters vs 2-D"] = max(
        logits_gap(many[i], one) for i in range(SERVE_SLOTS))
    eng = ContinuousBatchingEngine(model, None, slots=SERVE_SLOTS,
                                   buf_len=SERVE_BUF,
                                   adapter_slots=SERVE_ADAPTERS + 1)
    for name, lora in zip(names, loras):
        eng.registry.register(name, lora)
    got, wall, _ = run_engine(torch, eng, prompts, SERVE_ADAPTER_NEW, mix)
    eng.stop()
    del eng
    torch.cuda.empty_cache()
    moved = sum(a != b for a, b in zip(
        refs_e[::2], [r[:SERVE_ADAPTER_NEW] for r in base[::2]]))
    if moved < SERVE_ADAPTERS // 2:
        fail(f"serving (e): only {moved} adapter streams differ from base")
    checks.append(("adapters", "(e) adapter bank vs generate", prompts,
                   refs_e, got, [(a, lora_of(a)) for a in mix]))
    out["adapters"] = {"wall_s": wall, "tokens_per_s": sum(map(len, got))
                       / wall, "adapter_streams_off_base": moved,
                       "logit_delta": deltas["(e) grouped adapters vs 2-D"]}
    say("serving", f"(e) adapter bank: {SERVE_ADAPTERS} rank-"
                   f"{SERVE_LORA_RANK} adapters + base in one batch, "
                   f"{SERVE_REQUESTS} requests x {SERVE_ADAPTER_NEW} tokens "
                   f"in {wall:.2f} s; {moved}/{SERVE_REQUESTS // 2} adapter "
                   f"streams differ from base [{smi}]")
    out["seconds"]["e"] = time.time() - t0

    # (f) the server over loopback HTTP, against the engine; every token id
    # renders as text, so the SSE stream's pieces must join to the chat
    # reply of the same greedy request
    t0 = time.time()
    srv = oc.OpenAICompatServer(None, None, tokenizer=IdTokenizer(),
                                model=model, batch_slots=4,
                                buf_len=SERVE_GEN_BUF,
                                adapters={"a0": loras[0]}, adapter_slots=3)
    port = srv.start()
    chat_req = {"messages": [{"role": "user", "content": "hello"}],
                "max_tokens": 16}
    try:
        code, body = serve_http(port, "/v1/completions",
                                {"prompt": "Federated serving",
                                 "max_tokens": 16})
        comp = json.loads(body)
        code2, body2 = serve_http(port, "/v1/chat/completions", chat_req)
        chat = json.loads(body2)
        code3, body3 = serve_http(port, "/v1/chat/completions",
                                  dict(chat_req, stream=True))
        code4, _ = serve_http(port, "/v1/completions",
                              {"prompt": "x", "model": "nope"})
        code5, body5 = serve_http(port, "/v1/completions",
                                  {"prompt": "Federated serving",
                                   "max_tokens": 16, "model": "a0"})
    finally:
        srv.stop()
    chunks = [x for x in body3.split("\n\n") if x]
    streamed = "".join(
        json.loads(c[len("data: "):])["choices"][0]["delta"]["content"]
        for c in chunks[:-1] if c.startswith("data: {"))
    text = chat["choices"][0]["message"]["content"] if code2 == 200 else None
    ok = (code == 200 and comp["object"] == "text_completion"
          and len(comp["choices"][0]["text"].split()) == 16
          and code2 == 200 and chat["object"] == "chat.completion"
          and chat["choices"][0]["message"]["role"] == "assistant"
          and code3 == 200 and chunks[-1] == "data: [DONE]"
          and len(chunks) > 1 and streamed == text
          and code4 == 404 and code5 == 200
          and json.loads(body5)["choices"][0]["text"]
          != comp["choices"][0]["text"])
    out["server"] = {"completion": code, "chat": code2, "stream": code3,
                     "stream_chunks": len(chunks) - 1,
                     "stream_equals_chat": streamed == text,
                     "unknown_adapter": code4, "adapter": code5}
    say("serving", f"(f) server over loopback: completions {code} (16 "
                   f"tokens), chat {code2}, SSE stream {code3} with "
                   f"{len(chunks) - 1} chunks and [DONE] joining to the chat "
                   f"reply: {streamed == text}; model=a0 {code5} (other "
                   f"text than base), unknown adapter {code4}")
    if not ok:
        fail(f"serving (f): server responses {out['server']}")
    out["seconds"]["f"] = time.time() - t0

    # every stream of (a)-(e), token by token, against the f32 witness
    t0 = time.time()
    wit = Witness(torch, lm, model, dev)
    eps = 0.0
    longest = max(range(SERVE_REQUESTS), key=lambda r: len(prompts[r]))
    for ids in (prompt + times["plain"][1], prompts[longest] + base[longest]):
        with torch.no_grad():
            plain = model(torch.tensor([ids], device=dev))[0]
        eps = max(eps, logits_gap(plain, wit.logits(ids)))
    limit = SERVE_TIE_FACTOR * eps
    say("serving", f"witness: the bf16 plain forward sits within {eps:.3e} "
                   f"of the f32 witness's logits (over {len(ids)} and "
                   f"{len(prompt) + len(times['plain'][1])} positions); limit "
                   f"{SERVE_TIE_FACTOR} x that = {limit:.3e}")
    for name, delta in deltas.items():
        say("serving", f"{name}: logit difference on identical inputs "
                       f"{delta:.3e} (limit {limit:.3e})")
        if delta > limit:
            fail(f"serving {name}: the paths differ by {delta:.3e}, more "
                 f"than the limit {limit:.3e} bf16 rounding explains")
    for section, *check in checks:
        parted = check_streams(wit, limit, out, *check)
        out[section]["parted"] = out[section].get("parted", 0) + parted
    # the control: request 1's stream scored after request 0's prompt
    wrong = wit.stream_gaps(prompts[0], base[1])
    share = sum(g > limit for g in wrong) / len(wrong)
    out["witness"] = {"plain_vs_witness": eps, "limit": limit,
                      "deltas": deltas, "control_off_limit": share,
                      "control_gap_median": float(np.median(wrong)),
                      "streams": len(wit.gaps)}
    say("serving", f"witness control: another request's stream fails the "
                   f"limit on {share:.0%} of its {len(wrong)} tokens (witness "
                   f"gap median {np.median(wrong):.3e}); {len(wit.gaps)} "
                   f"distinct streams checked in {time.time() - t0:.1f} s")
    if share < SERVE_CONTROL_MIN:
        fail(f"serving: the limit {limit:.3e} passes {1 - share:.0%} of a "
             "wrong stream's tokens")
    del wit
    torch.cuda.empty_cache()
    out["seconds"]["witness"] = time.time() - t0

    # the P·V product: bf16 inputs, f32 accumulation, one cast, as computed
    # (cuBLAS with an f32 output) against a bf16 matmul with the reduced-
    # precision-reduction flag at its default and off
    g = torch.Generator(device=dev).manual_seed(3)
    probs = torch.softmax(torch.randn(SERVE_SLOTS, cfg.n_kv_heads, 1,
                                      cfg.max_seq_len, generator=g,
                                      device=dev), -1).to(torch.bfloat16)
    v = torch.randn(SERVE_SLOTS, cfg.n_kv_heads, cfg.max_seq_len, hd,
                    generator=g, device=dev).to(torch.bfloat16)
    exact = torch.matmul(probs.double(), v.double()).to(torch.bfloat16)
    ours = lm._acc_f32(probs, v).to(torch.bfloat16)
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    default_mm = torch.matmul(probs, v)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    strict_mm = torch.matmul(probs, v)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
    pv = {"f32_out_vs_f64": int((ours != exact).sum()),
          "bf16_default_vs_f64": int((default_mm != exact).sum()),
          "bf16_strict_vs_f64": int((strict_mm != exact).sum()),
          "elements": exact.numel()}
    out["pv_bits"] = pv
    say("serving", f"P.V bits at the decode shape: bf16 elements off the "
                   f"f64 product rounded once: f32-output cuBLAS (the port) "
                   f"{pv['f32_out_vs_f64']}, bf16 matmul with reduced-"
                   f"precision reduction {'on' if flag else 'off'} (default) "
                   f"{pv['bf16_default_vs_f64']}, off "
                   f"{pv['bf16_strict_vs_f64']}, of {pv['elements']}")
    del probs, v, exact, ours, default_mm, strict_mm
    torch.cuda.empty_cache()
    # phase 15 goes on with this model, the prompts and the dense engine's
    # streams (popped by main before the JSON line)
    out["_carry"] = {"model": model, "prompts": prompts, "base": base,
                     "engine_h1": engines[1][1]}

    # (g) card ≡ CPU on TINY in f32
    t0 = time.time()
    serving_tiny_card_vs_cpu(torch, lm, out)
    out["seconds"]["g"] = time.time() - t0
    out["seconds"]["phase"] = time.time() - t_phase
    return out


# -- 15. serving's remainder ---------------------------------------------
SPEC_K = 4
SPEC_DRAFT_LAYERS = 2
SPEC_NEW = 64                    # (b): tokens of the one request
SPEC_SERVER_SLOTS = 2
SPEC_CACHE_ROWS = 3              # (e): bank rows, the zero row included
SPEC_CACHE_ADAPTERS = 4
SPEC_CACHE_MIX = ["a0", "a1", "a2", "a3", "a0", None, "a2", "a1"]
SPEC_TINY_NEW = 20


class _DequantizedView:
    """The model as the int8 path sees it: its weights dequantized to the
    compute type one at a time (the f32 witness upcasts each as it goes,
    so no second bf16 copy of the model is held)."""

    def __init__(self, model, qparams, dequantize):
        self.cfg = model.cfg
        self._model, self._pairs = model, qparams.pairs()
        self._deq = dequantize

    def state_dict(self):
        model, pairs, deq = self._model, self._pairs, self._deq

        class _Items:
            def items(self):
                for k, v in model.state_dict().items():
                    yield k, (deq(*pairs[k], model.cfg.dtype)
                              if k in pairs else v)
        return _Items()


def witness_limit(torch, wit, forward, seqs):
    """``SERVE_TIE_FACTOR`` times the largest logit distance of the tested
    weights' plain forward from the witness over ``seqs``."""
    eps = 0.0
    for ids in seqs:
        with torch.no_grad():
            got = forward(ids)
        eps = max(eps, logits_gap(got, wit.logits(ids)))
    return eps, SERVE_TIE_FACTOR * eps


def serving_tiny_spec_card_vs_cpu(torch, lm, out):
    """(f): TINY in f32, speculative decode (a misaligned draft and the
    target's int8 tree) against plain greedy on the card and on the CPU,
    from the same weights."""
    import dataclasses

    from fedml_tpu_torch.llm.quantization import quantize_params_int8
    from fedml_tpu_torch.serving import speculative_generate
    from fedml_tpu_torch.serving.templates import openai_compat as oc

    cfg = dataclasses.replace(lm.TINY, max_seq_len=64, attn_impl="blockwise")
    streams = {}
    for dev in ("cpu", "cuda"):
        t, d = lm.LlamaLM(cfg), lm.LlamaLM(cfg)
        t.init_weights(torch.Generator().manual_seed(7))
        d.init_weights(torch.Generator().manual_seed(9))
        t, d = t.to(dev), d.to(dev)
        q, _ = quantize_params_int8(t)
        prompt = list(range(3, 19))
        greedy = oc.generate(None, None, prompt, max_new_tokens=SPEC_TINY_NEW,
                             buf_len=48, model=t)
        spec, st = speculative_generate(t, None, d, None, prompt,
                                        max_new_tokens=SPEC_TINY_NEW,
                                        buf_len=48, k=SPEC_K)
        spec8, st8 = speculative_generate(t, None, t, q, prompt,
                                          max_new_tokens=SPEC_TINY_NEW,
                                          buf_len=48, k=SPEC_K)
        if not spec == spec8 == greedy:
            fail(f"serving_spec (f) {dev}: speculative tokens differ from "
                 "plain greedy")
        streams[dev] = (greedy, st["accepted"], st8["accepted"])
    same = streams["cpu"] == streams["cuda"]
    say("serving_spec", f"(f) TINY f32: speculative (misaligned draft, int8 "
                        f"draft) tokens equal plain greedy on the CPU and on "
                        f"the card; card ≡ CPU tokens and acceptance: {same}")
    if not same:
        fail("serving_spec (f): card and CPU speculative streams differ")
    out["card_vs_cpu"] = {"tokens_equal": same,
                          "accepted": streams["cuda"][1:]}


def serving_rest_phase(torch, fedml_tpu_torch, att, smi, carry):
    """Phase 15: the int8 weight-only tree, speculative decode, the
    speculative engine, the server with a draft, the adapter cache mode, on
    phase 14's model, prompts and dense-engine streams."""
    import dataclasses

    import numpy as np

    from fedml_tpu_torch.llm import model as lm
    from fedml_tpu_torch.llm.quantization import (dequantize_weight,
                                                  make_quantized_apply,
                                                  quantization_error,
                                                  quantize_params_int8)
    from fedml_tpu_torch.serving import (ContinuousBatchingEngine,
                                         SpeculativeBatchingEngine,
                                         speculative_generate)
    from fedml_tpu_torch.serving.templates import openai_compat as oc

    dev = torch.device("cuda", 0)
    model, prompts, base = carry["model"], carry["prompts"], carry["base"]
    cfg = model.cfg
    out = {"seconds": {}, "ties": [], "peak_gib": {}}
    checks, checks8, deltas = [], [], {}
    t_phase = time.time()
    tok = oc.ByteTokenizer()

    def sub_start():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return time.time()

    def sub_end(name, t0):
        torch.cuda.synchronize()
        out["peak_gib"][name] = torch.cuda.max_memory_allocated() / 2 ** 30
        out["seconds"][name] = time.time() - t0

    # (a) the int8 weight-only tree: bytes, error, the plain engine
    t0 = sub_start()
    qp, qst = quantize_params_int8(model)
    qerr = quantization_error(model, qp)
    say("serving_spec", f"(a) int8 weight-only tree: {qst['quantized_bytes'] / 2 ** 30:.2f}"
                        f" GiB against {qst['dense_bytes'] / 2 ** 30:.2f} GiB "
                        f"bf16 (ratio {qst['ratio']:.3f}); quantization error "
                        f"max {qerr['max_rel_err']:.3e}, mean "
                        f"{qerr['mean_rel_err']:.3e} of each leaf's max "
                        f"magnitude [{smi}]")
    eng = ContinuousBatchingEngine(model, qp, slots=SERVE_SLOTS,
                                   buf_len=SERVE_BUF)
    got8, wall, first = run_engine(torch, eng, prompts, SERVE_NEW)
    ticks = eng.kv_stats()["ticks"]
    _, fn, args = eng.step_programs()[0]
    with torch.no_grad():
        fn(*args)
        sec, _ = sync_time(torch, lambda: [fn(*args) for _ in range(5)])
        prof = profile_rounds(torch, lambda: fn(*args), 1)
    embed_q = qp["tok_embed.embedding.__q8__.q"].numel()
    step_bytes = qst["quantized_bytes"] - embed_q + SERVE_SLOTS * cfg.dim \
        + eng._caches.nbytes()
    del fn, args
    eng.stop()
    del eng
    torch.cuda.empty_cache()
    ref8 = [oc.generate(None, qp, p, max_new_tokens=SERVE_NEW,
                        buf_len=SERVE_BUF, model=model) for p in prompts[:1]]
    checks8.append(("int8", "(a) int8 engine vs int8 generate", prompts[:1],
                    ref8, got8[:1]))
    checks8.append(("int8", "(a) int8 engine streams", prompts, got8, got8))
    h1 = carry["engine_h1"]
    rec = {"bytes": qst["quantized_bytes"], "bf16_bytes": qst["dense_bytes"],
           "max_rel_err": qerr["max_rel_err"],
           "mean_rel_err": qerr["mean_rel_err"], "wall_s": wall,
           "ticks": ticks, "tokens_per_s": sum(map(len, got8)) / wall,
           "ttft_s_median": float(np.median(first)),
           "step_ms": sec * 1e3 / 5,
           "step_launches": prof["host_launches"],
           "step_kernels": prof["device_kernels"],
           "step_busy_ms": prof["busy_s"] * 1e3,
           "step_bound_ms": step_bytes / PEAK_BYTES * 1e3,
           "streams_equal_bf16": sum(a == b for a, b in zip(got8, base))}
    out["int8"] = rec
    say("serving_spec", f"(a) plain engine on the int8 tree, {SERVE_SLOTS} "
                        f"slots: {SERVE_REQUESTS} x {SERVE_NEW} tokens in "
                        f"{wall:.2f} s = {rec['tokens_per_s']:.1f} tokens/s "
                        f"(bf16, phase 14 (b): {h1['tokens_per_s']:.1f}); "
                        f"TTFT median {rec['ttft_s_median']:.3f} s "
                        f"({h1['ttft_s_median']:.3f}); decode step "
                        f"{rec['step_ms']:.2f} ms ({h1['step_ms']:.2f}), "
                        f"{rec['step_launches']:.0f} host launch calls "
                        f"({h1['step_launches']:.0f}), device busy "
                        f"{rec['step_busy_ms']:.2f} ms "
                        f"({h1['step_busy_ms']:.2f}); bound "
                        f"{rec['step_bound_ms']:.2f} ms "
                        f"({h1['step_bound_ms']:.2f}); "
                        f"{rec['streams_equal_bf16']}/{SERVE_REQUESTS} "
                        f"streams equal the bf16 engine's [{smi}]")
    sub_end("a", t0)
    say("serving_spec", f"(a) peak {out['peak_gib']['a']:.2f} GiB "
                        f"(phase 14 (b) bf16: {h1['peak_gib']:.2f} GiB)")

    # (b) speculative_generate: the int8 tree as draft, and a 2-layer draft
    t0 = sub_start()
    prompt = serve_prompts(np, tok, 1, 64, 64, 1)[0]
    dcfg = dataclasses.replace(cfg, n_layers=SPEC_DRAFT_LAYERS, lora_rank=0)
    with torch.device(dev):
        draft = lm.LlamaLM(dcfg)
    draft.init_weights(torch.Generator(device=dev).manual_seed(1))
    runs = {}
    for name, fn in (
            ("generate", lambda n: (oc.generate(
                None, None, prompt, max_new_tokens=n, buf_len=SERVE_GEN_BUF,
                model=model), {})),
            ("int8_draft", lambda n: speculative_generate(
                model, None, model, qp, prompt, max_new_tokens=n,
                buf_len=SERVE_GEN_BUF, k=SPEC_K)),
            ("2_layer_draft", lambda n: speculative_generate(
                model, None, draft, None, prompt, max_new_tokens=n,
                buf_len=SERVE_GEN_BUF, k=SPEC_K))):
        fn(4)                                            # warm
        torch.cuda.synchronize()
        t1 = time.time()
        toks, st = fn(SPEC_NEW)
        torch.cuda.synchronize()
        runs[name] = dict(st, ms_per_token=(time.time() - t1) * 1e3
                          / len(toks), tokens=toks)
    for name in ("int8_draft", "2_layer_draft"):
        r = runs[name]
        checks.append(("spec", f"(b) {name} vs generate", [prompt],
                       [runs["generate"]["tokens"]], [r["tokens"]]))
        say("serving_spec", f"(b) speculative_generate, {name.replace('_', ' ')}, "
                            f"k {SPEC_K}: {r['ms_per_token']:.1f} ms/token vs "
                            f"generate's {runs['generate']['ms_per_token']:.1f}"
                            f"; acceptance {r['acceptance_rate']:.3f} "
                            f"({r['accepted']}/{r['proposed']}), "
                            f"{r['target_forwards']} target and "
                            f"{r['draft_forwards']} draft forwards for "
                            f"{len(r['tokens'])} tokens [{smi}]")
    out["speculative"] = {k: {kk: vv for kk, vv in v.items() if kk != "tokens"}
                          for k, v in runs.items()}
    # a (k+1)-token verify block against 1-token steps on identical inputs
    ids = prompt + runs["generate"]["tokens"][:SPEC_K + 1]
    n = len(prompt)
    with torch.no_grad():
        caches = [model.init_cache(1, dev, page_tokens=0) for _ in range(2)]
        for c in caches:
            model(torch.tensor([prompt], device=dev), decode=True,
                  start_pos=0, cache=c)
        blk = model(torch.tensor([ids[n:]], device=dev), decode=True,
                    start_pos=n, cache=caches[0])[0]
        steps = torch.cat([model(torch.tensor([[ids[n + j]]], device=dev),
                                 decode=True, start_pos=n + j,
                                 cache=caches[1])[0]
                           for j in range(SPEC_K + 1)])
        del caches
    deltas[f"(b) {SPEC_K + 1}-token verify block vs 1-token steps"] = \
        logits_gap(blk, steps)
    sub_end("b", t0)

    # (c) the speculative engine, the int8 tree as draft, over the 16
    # requests
    t0 = sub_start()
    eng = SpeculativeBatchingEngine(model, None, model, qp,
                                    slots=SERVE_SLOTS, buf_len=SERVE_BUF,
                                    k=SPEC_K)
    got_s, wall, first = run_engine(torch, eng, prompts, SERVE_NEW)
    st = dict(eng.stats)
    eng.stop()
    del eng
    torch.cuda.empty_cache()
    checks.append(("spec_engine", "(c) speculative engine vs dense engine",
                   prompts, base, got_s))
    rec = dict(st, wall_s=wall, tokens_per_s=sum(map(len, got_s)) / wall,
               ttft_s_median=float(np.median(first)),
               acceptance_rate=st["accepted"] / max(st["proposed"], 1))
    out["spec_engine"] = rec
    sub_end("c", t0)
    say("serving_spec", f"(c) speculative engine, {SERVE_SLOTS} slots, k "
                        f"{SPEC_K}, int8 draft: {SERVE_REQUESTS} x "
                        f"{SERVE_NEW} tokens in {wall:.2f} s = "
                        f"{rec['tokens_per_s']:.1f} tokens/s (plain engine, "
                        f"phase 14 (b): {h1['tokens_per_s']:.1f}); TTFT "
                        f"median {rec['ttft_s_median']:.3f} s "
                        f"({h1['ttft_s_median']:.3f}); "
                        f"{st['target_block_forwards']} target block "
                        f"forwards, {st['accepted']}/{st['proposed']} "
                        f"proposals accepted; peak "
                        f"{out['peak_gib']['c']:.2f} GiB [{smi}]")

    # (d) the server: one HTTP request with a draft and batch_slots
    t0 = sub_start()
    srv = oc.OpenAICompatServer(None, None, tokenizer=IdTokenizer(),
                                model=model, draft_model=draft,
                                batch_slots=SPEC_SERVER_SLOTS,
                                buf_len=SERVE_GEN_BUF, spec_k=SPEC_K)
    port = srv.start()
    try:
        code, body = serve_http(port, "/v1/completions",
                                {"prompt": "Federated serving",
                                 "max_tokens": 16})
        stats = dict(srv._engine.stats)
    finally:
        srv.stop()
    ids = IdTokenizer().encode("Federated serving")
    ref = oc.generate(None, None, ids, max_new_tokens=16,
                      buf_len=SERVE_GEN_BUF, model=model,
                      eos_id=IdTokenizer.eos_id)
    got = [int(x) for x in json.loads(body)["choices"][0]["text"].split()] \
        if code == 200 else []
    if code != 200 or not got or not stats["target_block_forwards"]:
        fail(f"serving_spec (d): server reply {code}, {len(got)} tokens, "
             f"stats {stats}")
    checks.append(("server", "(d) server with a draft vs generate", [ids],
                   [ref], [got]))
    out["server"] = {"code": code, "stats": stats}
    say("serving_spec", f"(d) server with a {SPEC_DRAFT_LAYERS}-layer draft "
                        f"and batch_slots {SPEC_SERVER_SLOTS}: completions "
                        f"{code}, 16 tokens through the speculative engine "
                        f"({stats['target_block_forwards']} block forwards)")
    sub_end("d", t0)

    # (e) the adapter cache mode: 4 adapters through a 3-row cache, against
    # the bank-resident engine
    t0 = sub_start()
    loras = saturated_adapters(torch, model, SPEC_CACHE_ADAPTERS, dev)
    names = [f"a{i}" for i in range(SPEC_CACHE_ADAPTERS)]
    ps = prompts[:len(SPEC_CACHE_MIX)]
    res = {}
    for mode, kw in (("bank", {"adapter_slots": SPEC_CACHE_ADAPTERS + 1}),
                     ("cache", {"adapter_cache_slots": SPEC_CACHE_ROWS})):
        eng = ContinuousBatchingEngine(model, None, slots=SERVE_SLOTS,
                                       buf_len=SERVE_BUF, **kw)
        for name, lora in zip(names, loras):
            eng.registry.register(name, lora)
        got, wall, _ = run_engine(torch, eng, ps, SERVE_ADAPTER_NEW,
                                  SPEC_CACHE_MIX)
        res[mode] = (got, wall, dict(eng.registry.stats))
        eng.stop()
        del eng
    torch.cuda.empty_cache()
    lora_of = lambda a: loras[names.index(a)] if a else None
    checks.append(("adapter_cache", "(e) adapter cache vs bank", ps,
                   res["bank"][0], res["cache"][0],
                   [(a, lora_of(a)) for a in SPEC_CACHE_MIX]))
    cst = res["cache"][2]
    if not (cst["cache_misses"] >= SPEC_CACHE_ADAPTERS
            and cst["cache_evictions"] > 0):
        fail(f"serving_spec (e): the cache never missed and evicted: {cst}")
    out["adapter_cache"] = {"stats": cst, "wall_s": res["cache"][1],
                            "bank_wall_s": res["bank"][1]}
    say("serving_spec", f"(e) adapter cache mode, {SPEC_CACHE_ROWS} rows "
                        f"(zero row included) for {SPEC_CACHE_ADAPTERS} "
                        f"adapters, {len(ps)} requests x "
                        f"{SERVE_ADAPTER_NEW} tokens in "
                        f"{res['cache'][1]:.2f} s (bank-resident "
                        f"{res['bank'][1]:.2f} s): {cst['cache_hits']} hits, "
                        f"{cst['cache_misses']} misses, "
                        f"{cst['cache_evictions']} evictions [{smi}]")
    sub_end("e", t0)

    # every stream against its witness: the bf16 model's, then the int8
    # tree's (its dequantized weights upcast); never beside an engine
    t0 = sub_start()
    out["witness"] = {}
    for which, wmodel, forward, cks in (
            ("bf16", model, lambda ids: model(
                torch.tensor([ids], device=dev))[0], checks),
            ("int8", _DequantizedView(model, qp, dequantize_weight),
             lambda ids: make_quantized_apply(model)(
                 qp, torch.tensor([ids], device=dev))[0], checks8)):
        wit = Witness(torch, lm, wmodel, dev)
        streams = base if which == "bf16" else got8
        longest = max(range(SERVE_REQUESTS), key=lambda r: len(prompts[r]))
        eps, limit = witness_limit(torch, wit, forward, [
            prompt + runs["generate"]["tokens"],
            prompts[longest] + streams[longest]])
        say("serving_spec", f"witness ({which}): the plain forward sits "
                            f"within {eps:.3e} of the f32 witness; limit "
                            f"{SERVE_TIE_FACTOR} x that = {limit:.3e}")
        if which == "bf16":
            for name, delta in deltas.items():
                say("serving_spec", f"{name}: logit difference on identical"
                                    f" inputs {delta:.3e} (limit "
                                    f"{limit:.3e})")
                if delta > limit:
                    fail(f"serving_spec {name}: the paths differ by "
                         f"{delta:.3e}, more than the limit {limit:.3e}")
        for section, *check in cks:
            parted = check_streams(wit, limit, out, *check)
            out.setdefault(section, {})
            out[section]["parted"] = out[section].get("parted", 0) + parted
        wrong = wit.stream_gaps(prompts[0], streams[1])
        share = sum(g > limit for g in wrong) / len(wrong)
        out["witness"][which] = {"plain_vs_witness": eps, "limit": limit,
                                 "control_off_limit": share,
                                 "streams": len(wit.gaps)}
        say("serving_spec", f"witness ({which}) control: another request's "
                            f"stream fails the limit on {share:.0%} of its "
                            f"{len(wrong)} tokens")
        if share < SERVE_CONTROL_MIN:
            fail(f"serving_spec: the {which} limit {limit:.3e} passes "
                 f"{1 - share:.0%} of a wrong stream's tokens")
        del wit
        torch.cuda.empty_cache()
    out["witness"]["deltas"] = deltas
    sub_end("witness", t0)
    del qp, draft
    torch.cuda.empty_cache()

    # (f) card ≡ CPU on TINY f32
    t0 = sub_start()
    serving_tiny_spec_card_vs_cpu(torch, lm, out)
    sub_end("f", t0)
    out["seconds"]["phase"] = time.time() - t_phase
    return out


# -- 16. the sp planes: FedBuff, the client store, checkpoints -------------
PLANES_ROUNDS = 3
PLANES_HEAVY = dict(async_latency_median_s=2.0, async_latency_sigma=1.6,
                    async_inflight_gens=2, async_dropout=0.1,
                    async_max_staleness=3)
PLANES_REGISTERED = 10 ** 6


def _state_equal(torch, a, b):
    from fedml_tpu_torch.core.checkpoint import state_to_flat
    fa, fb = state_to_flat(a.state), state_to_flat(b.state)
    return set(fa) == set(fb) and all(torch.equal(fa[k], fb[k]) for k in fa)


def _snapshot(api):
    """The whole server state as a flat dict of host tensors."""
    from fedml_tpu_torch.core.checkpoint import state_to_flat
    st = api.full_state() if hasattr(api, "full_state") else api.state
    return {k: v.detach().cpu().clone() for k, v in state_to_flat(st).items()}


def _rows(api):
    import numpy as np
    if api._store is not None:
        api._pager.drain_writebacks()
        return api._store.gather(np.arange(api.registered_clients))
    return {k: v.cpu().numpy() for k, v in (api.client_table or {}).items()}


def planes_phase(torch, fedml_tpu_torch, smi):
    """Phase 16: phase 5 (b)'s FEMNIST CNN through FedBuff, the client
    store, data paging, a registered population and a checkpoint resume."""
    import shutil

    import numpy as np

    from fedml_tpu_torch import data, device, model
    from fedml_tpu_torch.runner import FedMLRunner

    out = {"seconds": {}}
    t_phase = time.time()
    # one dataset for every run (the options below do not change it)
    ds, n_out = data.load(sp_args(fedml_tpu_torch, **SP_FEMNIST_CNN))

    def build(**over):
        """The engine a user script builds (``build_sp``) for phase 5
        (b)'s configuration with ``over``, on the shared dataset."""
        cfg = dict(SP_FEMNIST_CNN, comm_round=PLANES_ROUNDS + 1)
        cfg.update(over)
        args = sp_args(fedml_tpu_torch, **cfg)
        return FedMLRunner(args, device.get_device(args), ds,
                           model.create(args, n_out)).runner.fl_trainer

    def rounds(api, n=PLANES_ROUNDS):
        """``n`` rounds: seconds a round after the first (warm), and each
        round's metrics."""
        ms, dts = [], []
        for r in range(n):
            dt, m = sync_time(torch, lambda: api.train_one_round(r))
            ms.append(m)
            dts.append(dt)
        return sum(dts[1:]) / (n - 1), ms

    # (a) FedBuff at zero staleness ≡ the sync round, and a heavy tail
    t0 = time.time()
    sync = build()
    s_sync, _ = rounds(sync)
    fb = build(federated_optimizer="fedbuff")
    s_fb, _ = rounds(fb)
    same = _state_equal(torch, sync, fb)
    heavy = build(federated_optimizer="fedbuff", **PLANES_HEAVY)
    s_heavy, ms = rounds(heavy, PLANES_ROUNDS + 1)
    losses = [float(m["train_loss"]) for m in ms]
    rec = {"s_per_round_sync": s_sync, "s_per_round_fedbuff": s_fb,
           "s_per_apply_heavy": s_heavy, "zero_staleness_bitwise": same,
           "fastpath_applies": fb.fastpath_applies,
           "heavy_losses": losses,
           "heavy_staleness_p99": ms[-1]["staleness_p99"],
           "heavy_dropped": heavy.updates_dropped,
           "heavy_dispatched": heavy.clients_dispatched,
           "heavy_sim_s": heavy.sim.now}
    out["fedbuff"] = rec
    say("planes", f"(a) FedBuff, FEMNIST CNN, K = cohort 10: zero-staleness "
                  f"run bitwise the sync rounds: {same} ({fb.fastpath_applies}"
                  f" fast-path applies), {s_fb:.4f} s/round vs the sync "
                  f"engine's {s_sync:.4f}; heavy tail (median 2 s, σ 1.6, 2 "
                  f"generations in flight, dropout 0.1, staleness ≤ 3): "
                  f"{s_heavy:.4f} s/apply, losses "
                  f"{[round(x, 4) for x in losses]}, staleness p99 "
                  f"{rec['heavy_staleness_p99']:.1f}, {heavy.updates_dropped}"
                  f" of {heavy.clients_dispatched} updates dropped, "
                  f"{heavy.sim.now:.1f} simulated s [{smi}]")
    if not same or fb.fastpath_applies != PLANES_ROUNDS:
        fail("planes (a): the zero-staleness FedBuff rounds are not the sync "
             "rounds")
    if not (finite(*losses) and heavy.fastpath_applies < len(ms)
            and heavy.updates_dropped > 0):
        fail(f"planes (a): the heavy-tailed run {rec}")
    del sync, fb, heavy
    out["seconds"]["a"] = time.time() - t0

    # (b) the client store ≡ the dense table (SCAFFOLD), data paging ≡ the
    # host path, a registered population of 10^6
    t0 = time.time()
    dense = build(federated_optimizer="SCAFFOLD")
    s_dense, _ = rounds(dense)
    store = build(federated_optimizer="SCAFFOLD", client_store=True,
                  store_page_size=16)
    s_store, _ = rounds(store)
    rd, rs = _rows(dense), _rows(store)
    same = _state_equal(torch, dense, store) and all(
        np.array_equal(rd[k], rs[k]) for k in rd)
    host = build(device_data=False)
    s_host, _ = rounds(host, 2)
    paged = build(data_paging=True, data_page_size=256)
    s_paged, _ = rounds(paged, 2)
    same_paged = _state_equal(torch, host, paged)
    reg = build(federated_optimizer="SCAFFOLD", client_store=True,
                registered_clients=PLANES_REGISTERED, store_page_size=64)
    s_reg, _ = rounds(reg, 2)
    reg._pager.drain_writebacks()   # the last round's rows land first
    rst = reg._store.stats()
    sampled = len(np.unique(np.concatenate(
        [reg._client_sampling(r) for r in range(2)])))
    rec = {"store_bitwise_dense": same, "s_per_round_dense": s_dense,
           "s_per_round_store": s_store, "paged_bitwise_host": same_paged,
           "s_per_round_host": s_host, "s_per_round_paged": s_paged,
           "registered_touched_rows": rst["touched_rows"],
           "registered_resident_bytes": rst["resident_bytes"],
           "registered_dense_bytes": reg._store.dense_nbytes(),
           "s_per_round_registered": s_reg}
    out["store"] = rec
    say("planes", f"(b) client store (SCAFFOLD) bitwise the dense table: "
                  f"{same}, {s_store:.4f} s/round vs {s_dense:.4f}; data "
                  f"paging bitwise the host path: {same_paged}, "
                  f"{s_paged:.4f} vs {s_host:.4f} s/round; 10^6 registered: "
                  f"{rst['touched_rows']} rows touched ({sampled} sampled), "
                  f"{rst['resident_bytes'] / 2 ** 20:.2f} MiB resident of a "
                  f"{rec['registered_dense_bytes'] / 2 ** 30:.1f} GiB dense "
                  f"table, {s_reg:.4f} s/round [{smi}]")
    if not (same and same_paged and rst["touched_rows"] == sampled):
        fail(f"planes (b): {rec}")
    # phase 18 (b) holds the mesh's client-state plane to these runs
    carry = out["_carry"] = {
        "store": (_snapshot(store), rs), "paged": (_snapshot(paged), None),
        "registered": (_snapshot(reg), reg._store.to_checkpoint())}
    del dense, store, host, paged, reg
    out["seconds"]["b"] = time.time() - t0

    # (c) a run stopped after 2 rounds and resumed ≡ the uninterrupted run
    t0 = time.time()
    # a scratch directory inside the checkout, removed after the check
    ckpt = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        ".phase16_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    over = dict(federated_optimizer="SCAFFOLD", client_store=True,
                store_page_size=16)
    full = build(**over)
    full.train()
    first = build(**dict(over, comm_round=2, checkpoint_dir=ckpt,
                         checkpoint_freq=1))
    first.train()
    resumed = build(**over, checkpoint_dir=ckpt, checkpoint_freq=1)
    resumed.train()
    ra, rb = _rows(full), _rows(resumed)
    same = _state_equal(torch, full, resumed) and all(
        np.array_equal(ra[k], rb[k]) for k in ra)
    carry["checkpoint"] = (_snapshot(full), ra)
    shutil.rmtree(ckpt, ignore_errors=True)
    out["checkpoint"] = {"resumed_bitwise": same,
                         "resumed_rounds": len(resumed.metrics_history)}
    say("planes", f"(c) checkpoint_dir: {PLANES_ROUNDS + 1} rounds, stopped "
                  f"after 2 and resumed from the step and its store sidecar, "
                  f"bitwise the uninterrupted run: {same}")
    if not same or len(resumed.metrics_history) != PLANES_ROUNDS - 1:
        fail("planes (c): the resumed run differs from the uninterrupted one")
    out["seconds"]["c"] = time.time() - t0
    out["seconds"]["phase"] = time.time() - t_phase
    return out


# -- 17. tp: the 2-D client x model mesh at a model factor of 1 -----------
#: phase 17 (b): the attention calls of a tensor-parallel Llama-2-7B layer
#: at model factors 2 and 4 (each rank's own heads: B 2, S 1024, D 128,
#: causal, bf16, H = H_kv = 32 / m)
TP_SHAPES = [("tp_h16", 2, 16, 16, 1024, 128, True, "bfloat16"),
             ("tp_h8", 2, 8, 8, 1024, 128, True, "bfloat16")]
#: phase 17 (d): new tokens a decode stream is held for
TP_DECODE_NEW = 24


def tp_phase(torch, fedml_tpu_torch, att, smi, layers, slice_lora):
    """Phase 17."""
    from fedml_tpu_torch import data, model
    from fedml_tpu_torch.core.mesh import make_mesh2d
    from fedml_tpu_torch.llm.configurations import (
        build_fedllm, llama2_7b_round_arguments)
    from fedml_tpu_torch.llm.model import LLAMA2_7B, LlamaLM
    from fedml_tpu_torch.serving.templates.openai_compat import generate
    from fedml_tpu_torch.simulation.mesh.engine import MeshFedAvgAPI
    from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI
    import dataclasses

    dev = torch.device("cuda", 0)
    out = {"seconds": {}}
    mesh = make_mesh2d("1,1")
    if (mesh.shape["client"], mesh.shape["model"]) != (1, 1) or \
            mesh.groups["model"] is None:
        fail(f"tp: make_mesh2d('1,1') gave {mesh} without a model group")

    # (a) the federated LoRA round, tensor-parallel over a model group of
    # one rank, at phase 4's configuration
    t1 = time.time()
    api = build_fedllm(llama2_7b_round_arguments(layers), device="cuda",
                       mesh=mesh)
    tp = api.model.tp
    if tp is None or tp.size != 1 or api.model.layer_0.attention.tp is None:
        fail("tp: FedLLMAPI(mesh=...) did not build the tensor-parallel "
             "model")
    torch.cuda.synchronize()
    att.reset_launch_counts()
    api.train()
    torch.cuda.synchronize()
    launches = launch_counts(att)
    steps = sum(hr["steps"] for hr in api.history)
    expect = {"flash_fwd": layers * 2 * steps, "flash_bwd_dq": layers * steps,
              "flash_bwd_dkv": layers * steps}
    err = params_err({k: v.cpu() for k, v in api.global_lora.items()},
                     slice_lora)
    out["lora"] = {"launches": launches, "expected": expect,
                   "adapters_err_vs_phase4": err,
                   "rounds": [{"loss": hr["train_loss"],
                               "seconds": hr["seconds"]}
                              for hr in api.history]}
    say("tp", f"(a) FedLLMAPI(mesh=make_mesh2d('1,1')), Llama-2-7B widths, "
              f"{layers} layers, TP path (model group of 1): adapters vs "
              f"phase 4's {err:.2e} (tol {MESH_LORA_TOL:g}); launches "
              f"{launches}, expected {expect}; rounds "
              f"{[round(hr['seconds'], 2) for hr in api.history]} s [{smi}]")
    if err > MESH_LORA_TOL or launches != expect or \
            not all(launches.values()):
        fail("tp: the tensor-parallel LoRA round disagrees with phase 4 or "
             "launched K1-K3 other than expected")
    del api
    torch.cuda.empty_cache()
    out["seconds"]["lora"] = time.time() - t1

    # (b) K1-K3 at the tensor-parallel shard shapes
    t1 = time.time()
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    rows = out["rows"] = {}
    for tag, b, h, hkv, s, d, causal, dt in TP_SHAPES:
        dtype = getattr(torch, dt)
        mk = lambda *shape: torch.randn(shape, generator=gen, device=dev,
                                        dtype=torch.float32).to(dtype)
        q, k, v, do = mk(b, h, s, d), mk(b, hkv, s, d), mk(b, hkv, s, d), \
            mk(b, h, s, d)
        o, lse = att.flash_attention_fwd(q, k, v, causal)
        e_o, l_o = check_close(att, "K1 O", o, att.flash_attention_fwd_plain(
            q, k, v, causal)[0])
        dq, delta = att.flash_attention_bwd_dq(q, k, v, o, lse, do, causal)
        e_dq, l_dq = check_close(att, "K2 dQ", dq,
                                 att.flash_attention_bwd_dq_plain(
                                     q, k, v, o, lse, do, causal)[0])
        dk, dv = att.flash_attention_bwd_dkv(q, k, v, lse, delta, do, causal)
        pdk, pdv = att.flash_attention_bwd_dkv_plain(q, k, v, lse, delta,
                                                     do, causal)
        e_dk, l_dk = check_close(att, "K3 dK", dk, pdk)
        e_dv, l_dv = check_close(att, "K3 dV", dv, pdv)
        say("tp", f"(b) {tag} B{b} H{h} Hkv{hkv} S{s} D{d} causal {dt}: ok")
        for line in (l_o, l_dq, l_dk, l_dv):
            say("tp", f"  {line}")
        new_rows, _ = time_kernels(
            torch, att, tag, (q, k, v, do, o, lse, delta),
            (b, h, hkv, s, d, causal, dt),
            {"flash_fwd": e_o, "flash_bwd_dq": e_dq,
             "flash_bwd_dkv": max(e_dk, e_dv)}, smi)
        rows.update(new_rows)
        del q, k, v, do, o, lse, delta, dq, dk, dv, pdk, pdv
    out["seconds"]["kernels"] = time.time() - t1

    # (c) the sim engine at mesh_shape "1,1" against the sp engine
    t1 = time.time()
    args0 = sp_args(fedml_tpu_torch, **SP_FEMNIST_CNN)
    dataset, out_dim = data.load(args0)
    cnn = model.create(args0, out_dim)
    sim = out["sim"] = {}
    for alg in ("FedAvg", "SCAFFOLD"):
        cfg = dict(SP_FEMNIST_CNN, federated_optimizer=alg)
        sp = FedAvgAPI(sp_args(fedml_tpu_torch, **cfg), dev, dataset, cnn)
        sp_losses, sp_s, _ = two_rounds(torch, sp)
        for lay in MESH_LAYOUTS:
            api = MeshFedAvgAPI(sp_args(fedml_tpu_torch, backend="mesh",
                                        mesh_shape="1,1",
                                        update_sharding=lay, **cfg),
                                dev, dataset, cnn)
            if (api.n_shards, api.n_model_shards) != (1, 1):
                fail(f"tp: mesh_shape '1,1' gave {api.n_shards} x "
                     f"{api.n_model_shards}")
            losses, s, _ = two_rounds(torch, api)
            api._stager.close()
            err = params_err(api.full_params(), sp.state.global_params)
            loss_err = max(abs(a - b) for a, b in zip(losses, sp_losses))
            sim[f"{alg}/{lay}"] = {"params_err": err, "loss_err": loss_err,
                                   "s_per_round": s, "sp_s_per_round": sp_s}
            say("tp", f"(c) MeshFedAvgAPI mesh_shape '1,1' FEMNIST CNN "
                      f"{alg}/{lay}: 2 rounds vs sp params {err:.2e}, "
                      f"losses {loss_err:.2e} (tol {MESH_TOL:g}); {s:.4f} s "
                      f"a round, sp {sp_s:.4f} [{smi}]")
            if err > MESH_TOL or loss_err > MESH_TOL:
                fail(f"tp: the 2-D engine at '1,1' disagrees with sp "
                     f"({alg}/{lay})")
    out["seconds"]["sim"] = time.time() - t1

    # (d) tensor-parallel decode at a model factor of 1 against generate
    t1 = time.time()
    dec = out["decode"] = {}
    prompt = list(range(3, 40))
    for kv in ("native", "int8"):
        cfg = dataclasses.replace(LLAMA2_7B, n_layers=2, max_seq_len=256,
                                  kv_cache_dtype=kv, attn_impl="blockwise")
        streams = {}
        for name, m in (("plain", None), ("tp", mesh)):
            with torch.device("meta"):
                lm = LlamaLM(cfg, mesh=m)
            lm = lm.to_empty(device=dev)
            g = torch.Generator(device=dev)
            g.manual_seed(0)
            lm.init_weights(g)
            if name == "tp" and lm.init_cache(1).layers[0]["k"].shape[1] \
                    != cfg.n_kv_heads:
                fail("tp: the decode cache does not hold the rank's heads")
            streams[name] = generate(None, None, prompt,
                                     max_new_tokens=TP_DECODE_NEW,
                                     buf_len=256, model=lm)
            del lm
        dec[kv] = {"tokens": streams["tp"],
                   "equal": streams["tp"] == streams["plain"]}
        say("tp", f"(d) TP decode (model group of 1, Llama-2-7B widths, 2 "
                  f"layers, {kv} KV): {TP_DECODE_NEW} greedy tokens equal "
                  f"generate's: {dec[kv]['equal']} [{smi}]")
        if not dec[kv]["equal"]:
            fail(f"tp: TP decode ({kv} KV) differs from generate")
    torch.cuda.empty_cache()
    out["seconds"]["decode"] = time.time() - t1
    return out


# -- 18. mesh3d: the pipeline, the mesh's client-state plane, the ring ----
#: phase 18 (a): ``pipe_mlp`` at hidden 4096 and depth 16 (268 M params,
#: f32) through the pipeline trainer at a stage factor of 1
PIPE_CFG = dict(dataset="synthetic", num_classes=10, input_shape=(28, 28, 1),
                train_size=256, test_size=64, model="pipe_mlp",
                model_dim=4096, model_layers=16, client_num_in_total=8,
                client_num_per_round=2, batch_size=16, learning_rate=0.05,
                partition_method="homo", comm_round=2)
PIPE_MICRO = 4
#: its params against the sp engine's: bitwise or within this
PIPE_TOL = 1e-6
#: phase 18 (c): Llama-2-7B attention (B, H, H_kv, S, D), causal bf16, in
#: this many ring blocks (each block the slice's S 1024)
RING_SHAPE = (1, 32, 32, 4096, 128)
RING_BLOCKS = 4
#: the kernels' rows at the ring's two block shapes
RING_BLOCK_SHAPES = [
    ("ring_diag", 1, 32, 32, 1024, 128, True, "bfloat16"),
    ("ring_full", 1, 32, 32, 1024, 128, False, "bfloat16")]


def mesh3d_phase(torch, fedml_tpu_torch, att, smi, planes):
    """Phase 18: (a), (b) and (c) in turn."""
    out = {"seconds": {}}
    t1 = time.time()
    out["pipeline"] = pipeline_part(torch, fedml_tpu_torch, att, smi)
    out["seconds"]["pipeline"] = time.time() - t1
    t1 = time.time()
    out["mesh_state"] = mesh_state_part(torch, fedml_tpu_torch, att, smi,
                                        planes)
    out["seconds"]["mesh_state"] = time.time() - t1
    t1 = time.time()
    out["ring"], out["rows"] = ring_part(torch, att, smi)
    out["seconds"]["ring"] = time.time() - t1
    return out


def _engine(torch, fedml_tpu_torch, cfg, ds=None, n_out=None):
    """The engine a user script builds for ``cfg``: the sp engine, or with
    ``backend="mesh"`` the mesh engine over a world of 1."""
    from fedml_tpu_torch import data, device, model
    from fedml_tpu_torch.runner import FedMLRunner
    args = sp_args(fedml_tpu_torch, **cfg)
    if ds is None:
        ds, n_out = data.load(args)
    args.training_type = "simulation"
    return FedMLRunner(args, device.get_device(args), ds,
                       model.create(args, n_out)).runner.fl_trainer


def pipeline_part(torch, fedml_tpu_torch, att, smi):
    """Phase 18 (a): the pipeline trainer at a stage factor of 1 against
    the sp engine."""
    from fedml_tpu_torch import data
    build = lambda cfg, ds, n_out: _engine(torch, fedml_tpu_torch, cfg, ds,
                                           n_out)
    att.reset_launch_counts()
    args0 = sp_args(fedml_tpu_torch, **PIPE_CFG)
    ds, n_out = data.load(args0)
    # the reference runs its clients one after another, as the pipeline
    # does; the sp engine's vmapped client map (its default) is a control
    sp = build(dict(PIPE_CFG, sp_client_mode="scan"), ds, n_out)
    init = {k: v.clone() for k, v in sp.state.global_params.items()}
    n_params = sum(v.numel() for v in init.values())
    sp_losses, sp_s, _ = two_rounds(torch, sp)
    wide = build(PIPE_CFG, ds, n_out)
    wide.reset_params(init)
    wide_losses, wide_s, _ = two_rounds(torch, wide)
    wide_err = params_err(wide.state.global_params, sp.state.global_params)
    del wide
    api = build(dict(PIPE_CFG, backend="mesh", mesh_shape="1,1,1",
                     microbatches=PIPE_MICRO), ds, n_out)
    if type(api.trainer).__name__ != "PipelineTrainer" or \
            not api.layout.pipeline:
        fail("mesh3d (a): mesh_shape '1,1,1' on pipe_mlp did not build the "
             "pipeline trainer")
    api.reset_params(init)
    del init
    losses, s, _ = two_rounds(torch, api)
    api._stager.close()
    err = params_err(api.full_params(), sp.state.global_params)
    loss_err = max(abs(a - b) for a, b in zip(losses, sp_losses))
    launches = launch_counts(att)
    rec = {"n_params": n_params, "params_err": err,
           "loss_err": loss_err, "losses": losses,
           "s_per_round": s, "sp_s_per_round": sp_s,
           "sp_vmap_s_per_round": wide_s,
           "sp_vmap_vs_scan_params_err": wide_err,
           "microbatches": PIPE_MICRO, "launches": launches}
    say("mesh3d", f"(a) pipeline trainer, mesh_shape '1,1,1', pipe_mlp "
                  f"hidden {PIPE_CFG['model_dim']} depth "
                  f"{PIPE_CFG['model_layers']} ({n_params / 1e6:.1f} M "
                  f"params, f32), {PIPE_MICRO} microbatches: params vs the "
                  f"sp engine with its clients one by one {err:.2e}, losses "
                  f"{loss_err:.2e} (tol {PIPE_TOL:g}); {s:.3f} s a round vs "
                  f"sp {sp_s:.3f} s; control: the sp engine's vmapped "
                  f"client map vs one by one {wide_err:.2e} ({wide_s:.3f} s "
                  f"a round: the ReLU masks of near-zero pre-activations "
                  f"follow the GEMMs' summation order); K1-K3 launches "
                  f"{launches} [{smi}]")
    if err > PIPE_TOL or loss_err > PIPE_TOL or not finite(*losses) or \
            any(launches.values()):
        fail(f"mesh3d (a): {rec}")
    del sp, api
    torch.cuda.empty_cache()
    return rec


def mesh_state_part(torch, fedml_tpu_torch, att, smi, planes):
    """Phase 18 (b): the mesh's client-state plane at mesh_shape "1,1,1"
    against phase 16's sp-engine runs, bitwise."""
    import shutil

    import numpy as np

    from fedml_tpu_torch import data
    att.reset_launch_counts()
    ds, n_out = data.load(sp_args(fedml_tpu_torch, **SP_FEMNIST_CNN))
    base = dict(SP_FEMNIST_CNN, comm_round=PLANES_ROUNDS + 1,
                backend="mesh", mesh_shape="1,1,1")

    def mesh(**over):
        return _engine(torch, fedml_tpu_torch, dict(base, **over), ds, n_out)

    def equal_state(a, b):
        return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)

    def equal_rows(a, b):
        return set(a) == set(b) and all(np.array_equal(a[k], b[k])
                                        for k in a)

    res = {}
    api = mesh(federated_optimizer="SCAFFOLD", client_store=True,
               store_page_size=16)
    dt, _ = sync_time(torch, lambda: [api.train_one_round(r)
                                      for r in range(PLANES_ROUNDS)])
    state, rows = planes["store"]
    res["store"] = equal_state(_snapshot(api), state) and \
        equal_rows(_rows(api), rows)
    res["s_per_round_store"] = dt / PLANES_ROUNDS
    api = mesh(data_paging=True, data_page_size=256)
    dt, _ = sync_time(torch, lambda: [api.train_one_round(r)
                                      for r in range(2)])
    res["paged"] = equal_state(_snapshot(api), planes["paged"][0])
    res["s_per_round_paged"] = dt / 2
    api = mesh(federated_optimizer="SCAFFOLD", client_store=True,
               registered_clients=PLANES_REGISTERED, store_page_size=64)
    dt, _ = sync_time(torch, lambda: [api.train_one_round(r)
                                      for r in range(2)])
    api._pager.drain_writebacks()
    state, payload = planes["registered"]
    res["registered"] = equal_state(_snapshot(api), state) and \
        equal_rows(api._store.to_checkpoint(), payload)
    res["s_per_round_registered"] = dt / 2
    ckpt = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        ".phase18_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    over = dict(federated_optimizer="SCAFFOLD", client_store=True,
                store_page_size=16, checkpoint_dir=ckpt, checkpoint_freq=1)
    mesh(**dict(over, comm_round=2)).train()
    resumed = mesh(**over)
    resumed.train()
    state, rows = planes["checkpoint"]
    res["checkpoint"] = equal_state(_snapshot(resumed), state) and \
        equal_rows(_rows(resumed), rows) and \
        len(resumed.metrics_history) == PLANES_ROUNDS - 1
    shutil.rmtree(ckpt, ignore_errors=True)
    del api, resumed
    res["launches"] = launch_counts(att)
    say("mesh3d", f"(b) MeshFedAvgAPI mesh_shape '1,1,1', FEMNIST CNN, "
                  f"bitwise phase 16's sp runs: client store (SCAFFOLD) "
                  f"{res['store']}, data paging {res['paged']}, 10^6 "
                  f"registered {res['registered']}, checkpoint_dir resume "
                  f"{res['checkpoint']}; s/round store "
                  f"{res['s_per_round_store']:.4f}, paged "
                  f"{res['s_per_round_paged']:.4f}, registered "
                  f"{res['s_per_round_registered']:.4f}; K1-K3 launches "
                  f"{res['launches']} [{smi}]")
    if not all(res[k] for k in ("store", "paged", "registered",
                                "checkpoint")) or \
            any(res["launches"].values()):
        fail(f"mesh3d (b): {res}")
    return res


def ring_part(torch, att, smi):
    """Phase 18 (c): the ring schedule on one card, the exchange replaced
    by slicing.  Returns its record and the kernels' rows at the two block
    shapes."""
    from fedml_tpu_torch.ops import ring_attention as ring
    dev = torch.device("cuda", 0)
    b, h, hkv, s_len, d = RING_SHAPE
    n = RING_BLOCKS
    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    mk = lambda *shape: torch.randn(shape, generator=gen, device=dev,
                                    dtype=torch.float32).to(torch.bfloat16)
    q, k, v, do = mk(b, h, s_len, d), mk(b, hkv, s_len, d), \
        mk(b, hkv, s_len, d), mk(b, h, s_len, d)
    (o, lse), fwd_l = counted(torch, att,
                              lambda: ring.ring_schedule_fwd(q, k, v, n))
    (dq, dk, dv), bwd_l = counted(
        torch, att, lambda: ring.ring_schedule_bwd(q, k, v, o, lse, do, n))
    steps = n * (n + 1) // 2
    want_f = {"flash_fwd": steps, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    want_b = {"flash_fwd": 0, "flash_bwd_dq": steps, "flash_bwd_dkv": steps}
    # the references: one K1/K2/K3 call over S, the same ring with each
    # kernel's plain version, and the plain ring, the JAX recurrence.  Its
    # autograd gradients keep dS in f32 where K2 and K3 round it to bf16
    # before their products (as the TPU kernels and their plain versions
    # do): the ring's gradients are held to it within one limit of what
    # the one call over S reads against it
    so, slse = att.flash_attention_fwd(q, k, v, True)
    sdq, sdelta = att.flash_attention_bwd_dq(q, k, v, so, slse, do, True)
    sdk, sdv = att.flash_attention_bwd_dkv(q, k, v, slse, sdelta, do, True)
    vo, vlse = ring.ring_schedule_fwd(q, k, v, n, plain=True)
    vdq, vdk, vdv = ring.ring_schedule_bwd(q, k, v, o, lse, do, n,
                                           plain=True)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    po = ring.ring_schedule_plain(*leaves, n)
    pdq, pdk, pdv = torch.autograd.grad(po, leaves, do)
    del leaves
    errs, vs_plain = {}, {}
    for what, got, one, vers, plain in (
            ("O", o, so, vo, po), ("lse", lse, slse, vlse, None),
            ("dQ", dq, sdq, vdq, pdq), ("dK", dk, sdk, vdk, pdk),
            ("dV", dv, sdv, vdv, pdv)):
        errs[what], line = check_close(att, f"ring {what} vs one call",
                                       got, one)
        say("mesh3d", f"  {line}")
        errs[f"{what}_plain_versions"], line = check_close(
            att, f"ring {what} vs the ring of plain versions", got, vers)
        say("mesh3d", f"  {line}")
        if plain is None:
            continue
        if what == "O":
            errs["O_plain_ring"], line = check_close(
                att, "ring O vs the plain ring", got, plain)
            say("mesh3d", f"  {line}")
            continue
        st, st1 = (att.compare_with_plain(t, plain) for t in (got, one))
        vs_plain[what] = {"ring": st, "one_call": st1}
        line = (f"ring {what} vs the plain ring's autograd (dS in f32 "
                f"there): worst element {st['elem']:.2f}, block "
                f"{st['block']:.2f} of KERNEL_TOL; one call over S "
                f"{st1['elem']:.2f}, {st1['block']:.2f} (held: the ring "
                f"within one limit of the one call)")
        say("mesh3d", f"  {line}")
        if st["elem"] > st1["elem"] + 1 or st["block"] > st1["block"] + 1:
            fail(line)
    del vo, vlse, vdq, vdk, vdv, po, pdq, pdk, pdv

    def ring_fb():
        o_, lse_ = ring.ring_schedule_fwd(q, k, v, n)
        ring.ring_schedule_bwd(q, k, v, o_, lse_, do, n)

    def one_fb():
        o_, lse_ = att.flash_attention_fwd(q, k, v, True)
        _, delta_ = att.flash_attention_bwd_dq(q, k, v, o_, lse_, do, True)
        att.flash_attention_bwd_dkv(q, k, v, lse_, delta_, do, True)

    ring_ms, one_ms = graph_ms(torch, ring_fb, reps=5), \
        graph_ms(torch, one_fb, reps=5)
    blocks = {}
    for tag, *shape in RING_BLOCK_SHAPES:
        new_rows, _ = time_kernels(
            torch, att, tag, _kernel_inputs(torch, att, gen, *shape),
            tuple(shape), {"flash_fwd": errs["O"], "flash_bwd_dq": errs["dQ"],
                           "flash_bwd_dkv": max(errs["dK"], errs["dV"])},
            smi, out_f32=True)
        per = n if tag == "ring_diag" else steps - n
        for r in new_rows.values():
            r["launches"] = per
        blocks.update(new_rows)
    bound_ms = sum(r["bound_ms"] * r["launches"] for r in blocks.values())
    launches = {name: fwd_l[name] + bwd_l[name] for name in fwd_l}
    rec = {"shape": list(RING_SHAPE), "blocks": n,
           "launches_fwd": fwd_l, "launches_bwd": bwd_l,
           "launches": launches, "errs": errs,
           "grads_vs_plain_ring_autograd": vs_plain,
           "fwd_bwd_ms": ring_ms, "one_call_fwd_bwd_ms": one_ms,
           "bound_ms": bound_ms, "method": "graph"}
    say("mesh3d", f"(c) ring schedule, Llama-2-7B attention B{b} H{h} "
                  f"S{s_len} D{d} causal bf16 in {n} blocks of "
                  f"{s_len // n}: launches forward {fwd_l}, backward "
                  f"{bwd_l}; forward+backward {ring_ms:.3f} ms device "
                  f"(graph) vs one K1+K2+K3 call over S {one_ms:.3f} ms; "
                  f"the ring's blocks' bound {bound_ms:.3f} ms [{smi}]")
    if fwd_l != want_f or bwd_l != want_b:
        fail(f"mesh3d (c): launches forward {fwd_l} (want {want_f}), "
             f"backward {bwd_l} (want {want_b})")
    return rec, blocks


#: phase 19: the cross-silo federation.  (a) the FEMNIST CNN as a server
#: and 2 silos (client_id_list [1, 2]: two of the 100 FEMNIST clients a
#: round) for 3 rounds; (a') tests/test_cross_silo.py's lr federation, the
#: dropout-free config on which the CPU tests show the cross-silo and sp
#: engines agree; (b) phase 8's text transformer at full width as 2 silos
#: for 2 rounds, clean and under the fault stack; (c) (a) as 3 processes
XS_FEMNIST = dict(SP_FEMNIST_CNN, client_id_list=[1, 2], comm_round=3)
XS_LR = dict(dataset="synthetic", num_classes=10, input_shape=(14, 14, 1),
             train_size=512, test_size=128, model="lr",
             client_num_in_total=2, client_num_per_round=2, comm_round=3,
             batch_size=16, learning_rate=0.1, random_seed=11,
             client_id_list=[1, 2], partition_method="hetero")
#: phase 5 (d)'s cnn_web config, as 2 silos for 2 rounds
XS_CNN_WEB = dict(dataset="synthetic", num_classes=10,
                  input_shape=(28, 28, 1), train_size=512, test_size=128,
                  model="cnn_web", client_num_in_total=8,
                  client_num_per_round=4, batch_size=16, learning_rate=0.05,
                  partition_method="hetero", partition_alpha=0.3,
                  momentum=0.9, random_seed=3, client_id_list=[1, 2],
                  comm_round=2)
XS_TEXT = dict(TEXT_REALTEXT, client_id_list=[1, 2], comm_round=2)
#: tests/test_chaos.py's dup/delay chaos, acked and retransmitted by the
#: reliability layer, every message above 4 MiB (a 17 MB text model: 5
#: frames) split into frames
XS_FAULTS = dict(chaos_seed=7, chaos_dup_prob=0.3, chaos_delay_prob=0.5,
                 chaos_max_delay_s=0.03, reliable_delivery=True,
                 reliable_types=[1, 2, 3, 5, 7], wire_chunk_bytes=4 << 20)
#: card ≡ CPU, and cross-silo ≡ sp engine (f32, TF32 off)
XS_TOL = 1e-6
#: card vs CPU, a forward's ReLU pre-activations while the params agree
#: within ``XS_TOL`` (f32 sums of up to 3,136 products in another order)
XS_ACT_TOL = 1e-4
#: each thread join waits at most this long, and (c)'s processes must be
#: done within it of their launch
XS_JOIN_S = 60


def xs_args(fedml_tpu_torch, cfg, rank, run_id, **over):
    return sp_args(fedml_tpu_torch, **cfg).update(
        training_type="cross_silo", backend="local", rank=rank,
        run_id=run_id, role="server" if rank == 0 else "client", **over)


def xs_federation(torch, fedml_tpu_torch, cfg, device, run_id, ds, n_out,
                  init=None, record=False, agg_factory=None, **over):
    """A server and its silos as threads (one model each, the dataset
    shared); returns the server, the silos and the seconds, and with
    ``record`` each silo's first (round-0) upload as the server received
    it, by silo index.  ``agg_factory(model, args)`` builds the server's
    user ``ServerAggregator``.  Each join has a deadline: a stalled
    federation fails the run."""
    from fedml_tpu_torch import model
    from fedml_tpu_torch.cross_silo.client import Client
    from fedml_tpu_torch.cross_silo.server import Server

    out, errors = {"clients": {}}, []

    def guard(fn, *a):
        try:
            fn(*a)
        except BaseException as e:   # noqa: BLE001 — failed below
            errors.append(repr(e))

    def server():
        a = xs_args(fedml_tpu_torch, cfg, 0, run_id, **over)
        m = model.create(a, n_out)
        srv = Server(a, device, ds, m,
                     agg_factory(m, a) if agg_factory else None)
        if init is not None:
            srv.aggregator.set_global_model_params(init)
        if record:
            agg, first = srv.aggregator, out.setdefault("round0", {})
            add = agg.add_local_trained_result

            def add_recorded(index, params, n):
                first.setdefault(index, {k: torch.as_tensor(v).detach().cpu()
                                         .clone() for k, v in params.items()})
                add(index, params, n)
            agg.add_local_trained_result = add_recorded
        out["init"] = {k: v.detach().clone() for k, v in
                       srv.aggregator.get_global_model_params().items()}
        out["server"] = srv
        out["params"] = srv.run()

    def client(rank):
        a = xs_args(fedml_tpu_torch, cfg, rank, run_id, **over)
        c = Client(a, device, ds, model.create(a, n_out))
        out["clients"][rank] = c.client_manager
        c.run()

    t0 = time.time()
    ranks = range(1, len(cfg["client_id_list"]) + 1)
    threads = [threading.Thread(target=guard, args=(server,), daemon=True)]
    threads += [threading.Thread(target=guard, args=(client, r), daemon=True)
                for r in ranks]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=XS_JOIN_S)
    if errors:
        fail(f"cross-silo {run_id}: {errors[0]}")
    if any(t.is_alive() for t in threads):
        fail(f"cross-silo {run_id}: the federation stalled past "
             f"{XS_JOIN_S} s a join")
    if str(device) != "cpu":
        torch.cuda.synchronize()
    out["seconds"] = time.time() - t0
    return out


def forward_signs(torch, F, p, x, keep):
    """The FEMNIST CNN's forward (``models/cnn.py::CNNDropOut``) up to its
    last ReLU: the ReLU pre-activations (after Conv_0, Conv_1, Dense_0)
    and the max-pool winners (after each conv)."""
    x = (x[..., None] if x.ndim == 3 else x).permute(0, 3, 1, 2)
    z0 = F.conv2d(x, p["Conv_0.weight"], p["Conv_0.bias"], padding=2)
    h0, i0 = F.max_pool2d(F.relu(z0), 2, 2, return_indices=True)
    z1 = F.conv2d(h0, p["Conv_1.weight"], p["Conv_1.bias"], padding=2)
    h1, i1 = F.max_pool2d(F.relu(z1), 2, 2, return_indices=True)
    f = h1.permute(0, 2, 3, 1).reshape(h1.shape[0], -1)
    if keep is not None:
        f = torch.where(keep[0], f / 0.75, 0.0)
    z2 = F.linear(f, p["Dense_0.weight"], p["Dense_0.bias"])
    return {"relu_conv0": z0, "relu_conv1": z1, "relu_dense0": z2}, \
        {"pool0": i0, "pool1": i1}


def xs_silo_trace(torch, fedml_tpu_torch, cfg, ds, n_out, init, data_idx):
    """Card vs CPU, step by step: one silo's round-0 local pass (client
    ``data_idx``, its batches and dropout keep-masks fed as
    ``TrainerDistAdapter`` feeds them) from ``init`` on each device.  A row
    a step: before it, how many ReLU signs and max-pool winners differ
    between the two runs' forwards on the step's batch and the forwards'
    largest pre-activation difference; after it, the params' largest
    difference.  Returns the rows and the card run's final params."""
    import torch.nn.functional as F

    from fedml_tpu_torch import model
    from fedml_tpu_torch.core import rng as rng_util
    from fedml_tpu_torch.ml.trainer.local_trainer import LocalTrainer, \
        ServerCtx

    args = xs_args(fedml_tpu_torch, cfg, 1, "xs_trace")
    m = model.create(args, n_out)
    tr = LocalTrainer(m, args)
    seed, bs = int(args.random_seed), int(args.batch_size)
    xb, yb = ds.client_batches(data_idx, bs, seed, 0, int(args.epochs))
    masks = m.dropout_masks(rng_util.client_key(
        rng_util.root_key(seed), 0, data_idx), (len(xb), bs))
    runs = {}
    for dev in ("cuda", "cpu"):
        p = {k: v.to(dev) for k, v in init.items()}
        zero = torch.zeros((), device=dev)
        runs[dev] = {"carry": (p, tr.tx.init(p), None, None, zero, zero),
                     "ctx": ServerCtx(p)}
    rows = []
    for s in range(len(xb)):
        feed = {dev: (torch.as_tensor(xb[s], device=dev),
                      torch.as_tensor(yb[s], device=dev),
                      tuple(mk[s].to(dev) for mk in masks))
                for dev in runs}
        with torch.no_grad():
            (za, pa), (zb, pb) = (forward_signs(
                torch, F, runs[dev]["carry"][0], feed[dev][0], feed[dev][2])
                for dev in ("cuda", "cpu"))
        row = {"step": s + 1, "flips": 0, "act_diff": 0.0}
        for k in za:
            a = za[k].cpu()
            row["flips"] += int(((a > 0) != (zb[k] > 0)).sum())
            row["act_diff"] = max(row["act_diff"],
                                  float((a - zb[k]).abs().max()))
        row["flips"] += sum(int((pa[k].cpu() != pb[k]).sum()) for k in pa)
        for dev, r in runs.items():
            x, y, keep = feed[dev]
            r["carry"] = tr.train_step(r["carry"], x, y,
                                       torch.ones((), device=dev), keep,
                                       r["ctx"])
        row["params_gap"] = xs_err(runs["cuda"]["carry"][0],
                                   runs["cpu"]["carry"][0])
        rows.append(row)
    return rows, {k: v.cpu() for k, v in runs["cuda"]["carry"][0].items()}


def xs_hold_trace(rows):
    """The steps a silo's card pass is held to its CPU pass through: every
    step before the first whose forward flips a ReLU sign or a max-pool
    winner between the two (all steps if none does) within ``XS_TOL``, and
    the forwards' pre-activations within ``XS_ACT_TOL`` through that
    step.  Returns the first flip step (None if none) and the failures."""
    flip = next((r["step"] for r in rows if r["flips"]), None)
    bad = [f"step {r['step']}: params {r['params_gap']:.2e}" for r in rows
           if (flip is None or r["step"] < flip)
           and not r["params_gap"] <= XS_TOL]
    bad += [f"step {r['step']}: activations {r['act_diff']:.2e}"
            for r in rows if (flip is None or r["step"] <= flip)
            and not r["act_diff"] <= XS_ACT_TOL]
    return flip, bad


def xs_split(fed):
    """Per round, the silos' mean local pass and mean upload-to-sync
    seconds (the ClientMasterManager's timings)."""
    rows = {}
    for mgr in fed["clients"].values():
        for t in mgr.timings:
            r = rows.setdefault(t["round"], {"local_pass_s": [],
                                             "upload_to_sync_s": []})
            r["local_pass_s"].append(t["local_pass_s"])
            r["upload_to_sync_s"].append(t["upload_to_sync_s"])
    return [{"round": r, **{k: sum(v) / len(v) for k, v in d.items()}}
            for r, d in sorted(rows.items())]


def xs_message_bytes(params, round_idx=0):
    """Bytes of one model upload as the codec writes it (the message a
    filestore, MQTT blob or chunked frame carries)."""
    from fedml_tpu_torch.core.distributed.communication.message import (
        Message, encode_tree, to_host)
    from fedml_tpu_torch.cross_silo.message_define import MyMessage

    msg = Message(MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, 1, 0)
    msg.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, to_host(params))
    msg.add_params(MyMessage.MSG_ARG_KEY_NUM_SAMPLES, 1.0)
    msg.add_params(MyMessage.MSG_ARG_KEY_ROUND_IDX, round_idx)
    return len(encode_tree(msg.get_params()))


def xs_report(tag, fed, nbytes, smi, launches=None):
    split = xs_split(fed)
    ev = fed["server"].aggregator.last_eval
    say("cross_silo", f"{tag}: {fed['seconds']:.2f} s; model message "
                      f"{nbytes:,} bytes; eval round {ev['round']} loss "
                      f"{ev['loss']:.4f} acc {ev['acc']:.4f}"
                      + (f"; K1-K3 launches {launches}" if launches else "")
                      + f" [{smi}]")
    for r in split:
        say("cross_silo", f"  round {r['round']}: silo local pass "
                          f"{r['local_pass_s']:.4f} s, upload to next sync "
                          f"{r['upload_to_sync_s']:.4f} s")
    rec = {"seconds": fed["seconds"], "rounds": split,
           "message_bytes": nbytes, "eval": ev}
    if launches is not None:
        rec["launches"] = launches
    return rec


def xs_err(a, b):
    return max(max_err(a[k].detach().cpu(), b[k].detach().cpu()) for k in b)


def xs_bitwise(torch, a, b):
    return set(a) == set(b) and all(
        torch.equal(a[k].detach().cpu(), b[k].detach().cpu()) for k in b)


def cross_silo_phase(torch, fedml_tpu_torch, att, smi):
    """Phase 19."""
    import shutil

    out, seconds = {}, {}
    t_phase = time.time()
    # (c)'s three processes start first: each imports torch and the port,
    # loads FEMNIST and reaches the card while (a)–(b) run in this one
    procs = xs_launch_processes(fedml_tpu_torch)
    try:
        threads_params = xs_in_process(torch, fedml_tpu_torch, att, smi, out,
                                       seconds)
        t0 = time.time()
        out["processes"] = xs_join_processes(torch, procs, threads_params,
                                             smi)
        seconds["c_after_b"] = time.time() - t0
    finally:
        procs["launcher"].kill()
        procs["broker"].stop()
        shutil.rmtree(procs["work"], ignore_errors=True)
    seconds["phase"] = time.time() - t_phase
    out["seconds"] = seconds
    return out


def xs_in_process(torch, fedml_tpu_torch, att, smi, out, seconds):
    """Phase 19 (a)–(b), in threads of this process; returns (a)'s final
    params."""
    from fedml_tpu_torch import data
    from fedml_tpu_torch.core import rng as rng_util

    # (a) the FEMNIST CNN on the card; each silo's round-0 pass traced
    # card vs CPU from the same weights
    t0 = time.time()
    args = xs_args(fedml_tpu_torch, XS_FEMNIST, 0, "xs_a")
    ds, n_out = data.load(args)
    say("cross_silo", f"(a) CNNDropOut ({n_out} classes), femnist synthetic "
                      f"{ds.train_data_num:,} / {ds.test_data_num:,}, 100 "
                      f"clients (α 0.5), server + 2 silos in threads over "
                      f"local, 3 rounds; data in {time.time() - t0:.1f} s")
    card, launches_a = counted(torch, att, lambda: xs_federation(
        torch, fedml_tpu_torch, XS_FEMNIST, "cuda", "xs_a_card", ds, n_out,
        record=True))
    if any(launches_a.values()):
        fail(f"(a) launched a flash-attention kernel: {launches_a}")
    nbytes = xs_message_bytes(card["params"])
    out["femnist_card"] = xs_report("(a) card", card, nbytes, smi,
                                    launches_a)
    sampled = rng_util.sample_clients(int(args.random_seed), 0,
                                      int(args.client_num_in_total), 2)
    out["femnist_card_vs_cpu"] = {}
    for index, data_idx in enumerate(int(c) for c in sampled):
        rows, final = xs_silo_trace(torch, fedml_tpu_torch, XS_FEMNIST, ds,
                                    n_out, card["init"], data_idx)
        flip, bad = xs_hold_trace(rows)
        fed = xs_bitwise(torch, final, card["round0"][index])
        out["femnist_card_vs_cpu"][f"silo{index + 1}"] = {
            "client": data_idx, "steps": rows, "first_flip_step": flip,
            "upload_bitwise_trace": fed}
        held = len(rows) if flip is None else flip - 1
        say("cross_silo", f"(a) silo {index + 1}'s round-0 pass (client "
                          f"{data_idx}, {len(rows)} steps), card vs CPU from "
                          f"the same weights: params after each step "
                          + " ".join(f"{r['params_gap']:.1e}" for r in rows)
                          + f"; first forward flipping a ReLU sign or max-"
                            f"pool winner: step {flip or 'none'} ({held} steps held "
                            f"within {XS_TOL:g}, pre-activations through the "
                            f"flip within {XS_ACT_TOL:g}: max "
                          + f"{max(r['act_diff'] for r in rows[:held + 1]):.1e}"
                          + f"); the federation's round-0 upload "
                            f"{'bitwise' if fed else 'DIFFERENT from'} the "
                            f"traced card pass")
        if bad:
            fail(f"(a) silo {index + 1}: card and CPU part before any "
                 f"activation flips ({'; '.join(bad[:3])})")
        if not fed:
            fail(f"(a) silo {index + 1}'s round-0 upload is not the traced "
                 f"card pass")
    seconds["a"] = time.time() - t0

    # (a') cnn_web and lr federations card ≡ CPU; lr cross-silo ≡ sp
    t0 = time.time()
    out["card_vs_cpu"] = {}
    for name, cfg in (("cnn_web", XS_CNN_WEB), ("lr", XS_LR)):
        cargs = xs_args(fedml_tpu_torch, cfg, 0, f"xs_{name}")
        cds, c_out = data.load(cargs)
        on_card = xs_federation(torch, fedml_tpu_torch, cfg, "cuda",
                                f"xs_{name}_card", cds, c_out)
        on_cpu = xs_federation(torch, fedml_tpu_torch, cfg, "cpu",
                               f"xs_{name}_cpu", cds, c_out,
                               init={k: v.cpu() for k, v in
                                     on_card["init"].items()})
        err = xs_err(on_card["params"], on_cpu["params"])
        out["card_vs_cpu"][name] = err
        say("cross_silo", f"(a') {name}, 2 silos, {cfg['comm_round']} rounds"
                          f": card vs CPU from the same weights, params max "
                          f"abs diff {err:.2e} (tol {XS_TOL:g})")
        if not err <= XS_TOL:
            fail(f"(a') {name}: card and CPU federations disagree "
                 f"({err:.2e})")
    api = build_sp(sp_args(fedml_tpu_torch, **XS_LR))
    api.state = api.state.replace(global_params=on_card["init"])
    for r in range(XS_LR["comm_round"]):
        api.train_one_round(r)
    err = xs_err(on_card["params"], api.state.global_params)
    out["lr_vs_sp"] = err
    say("cross_silo", f"(a') lr: cross-silo vs the sp engine on the card from "
                      f"the same weights, params max abs diff {err:.2e} (tol "
                      f"{XS_TOL:g})")
    if not err <= XS_TOL:
        fail(f"(a') cross-silo and sp engines disagree ({err:.2e})")
    seconds["a_small"] = time.time() - t0

    # (b) the text transformer at full width, clean and under the faults
    t0 = time.time()
    targs = xs_args(fedml_tpu_torch, XS_TEXT, 0, "xs_b")
    tds, t_out = data.load(targs)
    seed, bs = int(targs.random_seed), int(targs.batch_size)
    steps = sum(tds.client_index_batches(int(c), bs, seed, r).shape[0]
                for r in range(XS_TEXT["comm_round"])
                for c in rng_util.sample_clients(
                    seed, r, XS_TEXT["client_num_in_total"], 2))
    n_eval = len(tds.test_batches()[0])
    evals = sum(1 for r in range(XS_TEXT["comm_round"])
                if r % int(targs.frequency_of_the_test) == 0
                or r == XS_TEXT["comm_round"] - 1)
    layers = 4
    want = expect_launches(layers, steps + n_eval * evals, steps)
    runs = {}
    for name, over in (("clean", {}), ("faults", XS_FAULTS)):
        fed, got = counted(torch, att, lambda: xs_federation(
            torch, fedml_tpu_torch, XS_TEXT, "cuda", f"xs_b_{name}", tds,
            t_out, **over))
        mod = fed["server"].aggregator.model.module
        if (mod.tok_embed.weight.shape, mod.n_layers, mod.layer_0.n_heads,
                mod.layer_0.ff_up.weight.shape[0]) != ((8192, 256), 4, 8,
                                                       512):
            fail("(b) not the text model at its full width")
        nbytes = xs_message_bytes(fed["params"])
        out[f"text_{name}"] = xs_report(f"(b) text {name}", fed, nbytes, smi,
                                        got)
        say("cross_silo", f"  expected launches {want}: layers {layers} × "
                          f"({steps} silo steps over 2 silos × 2 rounds + "
                          f"{n_eval} eval batches × {evals} evals) for K1, "
                          f"layers × steps for K2/K3")
        if got != want or not all(got.values()):
            fail(f"(b) {name}: launches {got} != expected {want}")
        runs[name] = fed
    com = runs["faults"]["server"].server_manager.com_manager
    from fedml_tpu_torch.core.distributed.chunking import find_chunking
    from fedml_tpu_torch.core.distributed.reliability import find_reliable
    chunks = find_chunking(com).stats
    rel = find_reliable(com).stats
    chaos = runs["faults"]["clients"][1].com_manager
    while type(chaos).__name__ != "FaultInjectingCommManager":
        chaos = chaos.inner
    same = xs_bitwise(torch, runs["faults"]["params"],
                      runs["clean"]["params"])
    say("cross_silo", f"(b) faults vs clean: params bitwise "
                      f"{'equal' if same else 'DIFFERENT'}; server chunking "
                      f"{chunks}; server reliability {rel}; silo 1's chaos "
                      f"{chaos.stats}")
    out["text_faults"].update(chunking=chunks, reliability=rel,
                              chaos_silo1=chaos.stats)
    if not same:
        fail("(b) the federation under chaos and chunking is not bitwise "
             "the clean run")
    if chunks["chunked_sends"] == 0 or chaos.stats["duplicated"] == 0:
        fail("(b) the fault stack did not engage")
    out["text_launches"] = want
    seconds["b"] = time.time() - t0

    return card["params"]


def xs_launch_processes(fedml_tpu_torch):
    """(c): ``CrossSiloLauncher`` starts the server and 2 silos as OS
    processes (``tools/torch_cross_silo_entry.py``) on the card, on (a)'s
    config, over ``MQTT_S3`` through a ``MiniMqttBroker`` on an ephemeral
    port of this host, the server's persistent session opened first.
    Returns the launcher, the broker and the work directory, which the
    caller stops and removes."""
    import shutil

    from fedml_tpu_torch.core.distributed.communication.mqtt.mini_broker \
        import MiniMqttBroker
    from fedml_tpu_torch.core.distributed.communication.mqtt \
        .mqtt_s3_comm_manager import preregister_session
    from fedml_tpu_torch.cross_silo.client.client_launcher import \
        CrossSiloLauncher

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, ".phase19_xs")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    broker = MiniMqttBroker().start()
    cfg = dict(XS_FEMNIST, epochs=1, frequency_of_the_test=10 ** 9,
               random_seed=0, backend="MQTT_S3",
               mqtt_config={"host": "127.0.0.1", "port": broker.port},
               store_dir=os.path.join(work, "store"))
    run_id = "xs_c"
    preregister_session(fedml_tpu_torch.load_arguments().update(
        run_id=run_id, **cfg), 0, 3)
    out_path = os.path.join(work, "server_params.pt")
    launcher = CrossSiloLauncher(
        os.path.join(root, "tools", "torch_cross_silo_entry.py"),
        run_id=run_id, client_ranks=[1, 2],
        extra_env={"XS_CFG": json.dumps(cfg), "XS_OUT": out_path})
    rec = {"launcher": launcher, "broker": broker, "work": work,
           "out": out_path, "run_id": run_id}
    try:
        launcher.launch()
    except BaseException:
        launcher.kill()
        broker.stop()
        raise
    rec["t0"] = time.time()
    return rec


def xs_join_processes(torch, procs, threads_params, smi):
    """(c)'s end: the three processes exit 0 within ``XS_JOIN_S`` of their
    launch, and the server's final params equal (a)'s thread run
    bitwise."""
    try:
        codes = procs["launcher"].wait(
            timeout_s=max(XS_JOIN_S - (time.time() - procs["t0"]), 0.1))
    except (RuntimeError, TimeoutError) as e:
        fail(f"(c) the three processes failed: {e}")
    dt = time.time() - procs["t0"]
    params = torch.load(procs["out"], map_location="cpu")
    msgs = [m for m in procs["broker"].message_log
            if m[0].startswith(f"fedml_{procs['run_id']}")]
    same = xs_bitwise(torch, params, threads_params)
    err = xs_err(params, threads_params)
    say("cross_silo", f"(c) server + 2 silos as processes (CrossSiloLauncher"
                      f", FEDML_TPU_RANK/ROLE/RUN_ID) over MQTT_S3 through "
                      f"the in-repo broker: exit codes {codes}, {dt:.2f} s "
                      f"from launch (3 interpreters, each importing torch and "
                      f"the port, loading FEMNIST and reaching the card, "
                      f"beside (a)–(b) in this process), {len(msgs)} control "
                      f"messages on the broker; params vs (a)'s threads "
                      f"{'bitwise equal' if same else 'DIFFERENT'} (max abs "
                      f"diff {err:.2e}) [{smi}]")
    if not same:
        fail(f"(c) the processes' params differ from the threads' by "
             f"{err:.2e}")
    return {"seconds": dt, "exit_codes": codes, "bitwise": same,
            "max_abs_diff": err, "control_messages": len(msgs)}


# -- 20. wire: the codec and its drivers --------------------------------------
#: phase 20: phase 8's text transformer at full width on the real text
#: shard, 4 clients a round over 2 silos, 2 rounds unfused; the wire at its
#: default block (every projection and the embedding far above 256
#: elements).  Clients step with SGD at phase 8 (e)'s rate: Adam's
#: normalised step turns the two-tier sums' rounding into steps of order
#: its rate (7.7e-3 apart after 2 rounds on the card, PERF.md §6), so no
#: reassociation bound holds under it
WIRE_TEXT = dict(TEXT_REALTEXT, client_num_per_round=4, num_silos=2,
                 comm_round=2, frequency_of_the_test=10 ** 9,
                 client_optimizer="sgd", learning_rate=0.1)
#: two-tier vs flat: the JAX package's reassociation bound; the int8 wire
#: vs fp32: its int8 loss bound (tests/test_wire.py, on `lr`)
WIRE_REASSOC_TOL = 2e-5
WIRE_INT8_TOL = 1e-2
#: the int8 wire vs fp32 on the text model.  The JAX package's driver
#: parts from its fp32 run as far as the port's does on the same config
#: at narrow widths on the CPU (JAX vs port within 2e-7), and the gap
#: about doubles with each doubling of the width: 3.8e-3, 8.3e-3, 1.6e-2
#: at widths 32, 64, 128 (tests/test_torch_wire_drivers.py run as a
#: script); 6.7e-2 at 256 with 4 layers on the card, the same bits in
#: two calls (PERF.md §6)
WIRE_INT8_TEXT_TOL = 1e-1
#: (c): the state the silos receive is the server's f32 state moved by
#: the link's residuals, ``sent - state = ef_before - ef_after`` (exact
#: in reals): the two sides' L2 norms and largest entries agree to f32
#: rounding of ``state + ef_before``
WIRE_EF_REL_TOL = 1e-3
#: (b)-(c): the local backend, 4 MiB frames on reliable delivery
WIRE_DIST = dict(backend="local", wire_chunk_bytes=4 << 20,
                 reliable_delivery=True, comm_recv_timeout_s=120.0)
#: (d): the JAX package's async-driver config (tests/test_wire.py), int8
#: with the writer thread
WIRE_ASYNC = dict(dataset="synthetic", num_classes=10,
                  input_shape=(14, 14, 1), train_size=512, test_size=128,
                  model="lr", client_num_in_total=12,
                  client_num_per_round=8, comm_round=3, batch_size=16,
                  learning_rate=0.1, random_seed=5,
                  frequency_of_the_test=100, async_workers=2,
                  async_buffer_k=2, wire_precision="int8", wire_block=16,
                  wire_overlap=True, backend="local")
#: (d): the final params' L2 distance from FedBuffAPI's (two generations a
#: buffer) over the distance FedBuffAPI moved them from the initial
#: weights (tests/test_torch_async_driver.py's bound)
WIRE_ASYNC_REL = 0.5
#: (e): tests/test_wire.py's two-tier config (lr), wire checkpoints
WIRE_CKPT = dict(dataset="synthetic", num_classes=4, input_shape=(8,),
                 train_size=96, test_size=32, model="lr",
                 client_num_in_total=8, client_num_per_round=4,
                 comm_round=2, batch_size=8, learning_rate=0.1,
                 random_seed=7, partition_method="homo", num_silos=2,
                 wire_precision="fp32", wire_block=16,
                 checkpoint_codec="wire", checkpoint_freq=1,
                 backend="local")


def wire_threads(torch, ranks, run_id, run):
    """``run(rank)`` for every rank in threads (the server last); each
    join has a deadline.  Returns the seconds."""
    from fedml_tpu_torch.core.distributed.communication.local import (
        local_comm_manager)
    errors = []

    def guard(rank):
        try:
            run(rank)
        except BaseException as e:   # noqa: BLE001 — failed below
            errors.append(f"rank {rank}: {e!r}")

    threads = [threading.Thread(target=guard, args=(r,), daemon=True)
               for r in ranks]
    t0 = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=XS_JOIN_S)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    local_comm_manager.reset_run(run_id)
    if errors:
        fail(f"wire {run_id}: {errors[0]}")
    if any(t.is_alive() for t in threads):
        fail(f"wire {run_id}: the federation stalled past {XS_JOIN_S} s "
             "a join")
    return seconds


def wire_silos(torch, fedml_tpu_torch, cfg, ds, n_out, run_id, **over):
    """``run_silo_federation`` with a server and ``num_silos`` silos in
    threads, each rank its own model and API (built first); returns the
    server's history, every rank's API (by rank) and the seconds."""
    from fedml_tpu_torch import model
    from fedml_tpu_torch.store.hierarchy import (HierarchicalSiloAPI,
                                                 run_silo_federation)
    silos = int(cfg["num_silos"])
    ranks = list(range(silos, -1, -1))
    built, out = {}, {}
    for r in ranks:
        a = sp_args(fedml_tpu_torch, **dict(cfg, rank=r, run_id=run_id,
                                            **over))
        m = model.create(a, n_out)
        built[r] = (a, m, HierarchicalSiloAPI(a, "cuda", ds, m))

    def run(r):
        a, m, api = built[r]
        out[r] = run_silo_federation(a, "cuda", ds, m, api=api)

    seconds = wire_threads(torch, ranks, run_id, run)
    return out[0], {r: b[2] for r, b in built.items()}, seconds


class WireStateSyncs:
    """Within the block, records every state sync a combine tier's wire
    link encodes: the server's params (host copies), the params a silo
    decodes from the payload, and the link's residual before and after
    the encode."""

    def __init__(self, wire):
        self.wire, self.syncs = wire, []

    def __enter__(self):
        wire, enc = self.wire, self.wire.WireLink.encode
        self._enc = enc

        def ef(wl, link):
            e = wl.ef(link)
            return None if e is None else e.copy()

        def record(wl, sd, link=""):
            before = ef(wl, link)
            payload = enc(wl, sd, link)
            if link == "state_sync":
                self.syncs.append({
                    "state": {k: v.detach().cpu().numpy().copy()
                              for k, v in sd["global_params"].items()},
                    "sent": wire.WireCodec.decode(
                        payload, wl.codec.layout)["global_params"],
                    "ef_before": before, "ef_after": ef(wl, link)})
            return payload

        wire.WireLink.encode = record
        return self

    def __exit__(self, *exc):
        self.wire.WireLink.encode = self._enc

    def check(self):
        """Per sync: the largest distance of the sent params from the
        state, and the L2 norms and largest entries of ``sent - state``
        and of ``ef_before - ef_after`` (a residual not yet kept, or none
        kept at fp32 and bf16, counts as zero)."""
        import numpy as np
        rows = []
        for x in self.syncs:
            diff = np.concatenate([(x["sent"][k] - v).reshape(-1)
                                   for k, v in x["state"].items()])
            step = np.subtract(*(np.zeros(1, np.float32) if e is None else e
                                 for e in (x["ef_before"], x["ef_after"])))
            rows.append({"max_err": float(np.max(np.abs(diff))),
                         "norm": float(np.linalg.norm(diff)),
                         "ef_step_max": float(np.max(np.abs(step))),
                         "ef_step_norm": float(np.linalg.norm(step))})
        return rows


def wire_partial_bytes(layout, params):
    """A FedAvg partial of ``params`` (``{num, den}`` and ``n_sampled``)
    encoded at each precision: the payload's array bytes, the codec's
    modeled bytes and the framed message bytes."""
    import torch

    from fedml_tpu_torch.core import wire
    from fedml_tpu_torch.core.distributed.communication.message import (
        encode_tree)
    part = {"avg_params": {"num": params, "den": torch.tensor(1.0)},
            "n_sampled": torch.tensor(4.0)}
    rows = {}
    for prec in ("fp32", "bf16", "int8"):
        codec = wire.WireCodec(prec, layout=layout)
        p, _ = codec.encode(part)
        rows[prec] = {"payload": wire.payload_nbytes(p),
                      "modeled": codec.modeled_nbytes(int(p["n"]),
                                                      p["raw"]),
                      "framed": len(encode_tree(p))}
    return rows


def wire_phase(torch, fedml_tpu_torch, att, smi):
    """Phase 20."""
    import tempfile
    import zlib

    from fedml_tpu_torch import data, model, obs
    from fedml_tpu_torch.core import wire
    from fedml_tpu_torch.core.checkpoint import WireCheckpointer
    from fedml_tpu_torch.core.distributed.communication.message import (
        encode_tree)
    from fedml_tpu_torch.core.distributed.reliability import RoundWAL
    from fedml_tpu_torch.runner import FedMLRunner
    from fedml_tpu_torch.simulation.async_driver import run_async_federation
    from fedml_tpu_torch.simulation.async_engine import FedBuffAPI
    from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI
    from fedml_tpu_torch.store.hierarchy import (HierarchicalSiloAPI,
                                                 run_silo_federation)

    rec, seconds = {}, {}
    t0 = time.time()
    args = sp_args(fedml_tpu_torch, **WIRE_TEXT)
    ds, n_out = data.load(args)
    seconds["data"] = time.time() - t0

    # (a) the flat round beside the two-tier round, both built as a user
    # builds them, from the same seed's weights
    flat_args = sp_args(fedml_tpu_torch, **dict(WIRE_TEXT, num_silos=0))
    flat = FedAvgAPI(flat_args, "cuda", ds, model.create(flat_args, n_out))
    t0 = time.time()
    _, l_flat = counted(torch, att, flat.train)
    seconds["a_flat"] = time.time() - t0
    runner = FedMLRunner(args, torch.device("cuda"), ds,
                         model.create(args, n_out))
    two = runner.runner.fl_trainer
    if not isinstance(two, HierarchicalSiloAPI):
        fail(f"num_silos=2 built {type(two).__name__}, not "
             "HierarchicalSiloAPI")
    t0 = time.time()
    _, l_two = counted(torch, att, runner.run)
    seconds["a_two_tier"] = time.time() - t0
    loss_flat = [h["train_loss"] for h in flat.metrics_history]
    loss_two = [h["train_loss"] for h in two.metrics_history]
    gap_loss = max(abs(a - b) for a, b in zip(loss_flat, loss_two))
    gap_params = xs_err(two.state.global_params, flat.state.global_params)
    # each silo maps its own clients: a step launches each kernel once a
    # layer a silo, where the flat round's launches once for the cohort;
    # the evaluation (K1 only) is the same
    silos = WIRE_TEXT["num_silos"]
    steps_flat = l_flat["flash_bwd_dq"]
    want = {"flash_fwd": silos * steps_flat
            + l_flat["flash_fwd"] - steps_flat,
            "flash_bwd_dq": silos * steps_flat,
            "flash_bwd_dkv": silos * steps_flat}
    say("wire", f"(a) text {WIRE_TEXT['comm_round']} rounds, "
                f"{WIRE_TEXT['client_num_per_round']} clients: flat "
                f"{seconds['a_flat']:.2f} s, two-tier "
                f"{seconds['a_two_tier']:.2f} s; losses flat {loss_flat} "
                f"two-tier {loss_two}; gaps loss {gap_loss:.3e} params "
                f"{gap_params:.3e} (tol {WIRE_REASSOC_TOL}); K1-K3 "
                f"launches flat {l_flat}, two-tier {l_two} (expected "
                f"{want}); the codec runs on the host, no kernel of ours "
                f"but K1-K3 exists [{smi}]")
    if l_two != want or not all(l_flat.values()):
        fail(f"(a) K1-K3 launches: flat {l_flat}, two-tier {l_two}, "
             f"expected {want}")
    if gap_loss > WIRE_REASSOC_TOL or gap_params > WIRE_REASSOC_TOL:
        fail(f"(a) two-tier vs flat: loss {gap_loss:.3e}, params "
             f"{gap_params:.3e} > {WIRE_REASSOC_TOL}")
    rec["a"] = {"losses_flat": loss_flat, "losses_two_tier": loss_two,
                "gap_loss": gap_loss, "gap_params": gap_params,
                "launches_flat": l_flat, "launches_two_tier": l_two}

    # (b) the multi-rank driver at fp32 over local: bitwise (a)'s rounds
    torch.cuda.synchronize()
    att.reset_launch_counts()
    hist_b, apis_b, seconds["b"] = wire_silos(
        torch, fedml_tpu_torch, WIRE_TEXT, ds, n_out, "wire_b",
        wire_precision="fp32", **WIRE_DIST)
    l_b = launch_counts(att)
    api_b = apis_b[0]
    loss_b = [h["train_loss"] for h in hist_b]
    bitwise_b = loss_b == loss_two and xs_bitwise(
        torch, api_b.state.global_params, two.state.global_params)
    say("wire", f"(b) run_silo_federation fp32, 4 MiB frames, reliable: "
                f"{seconds['b']:.2f} s; losses {loss_b}; bitwise (a)'s "
                f"two-tier run: {bitwise_b} (params gap "
                f"{xs_err(api_b.state.global_params, two.state.global_params):.3e}"
                f"); K1-K3 launches {l_b} [{smi}]")
    if not bitwise_b:
        fail("(b) the fp32 federation is not bitwise the in-process run")
    if l_b != {k: silos * steps_flat for k in l_b}:
        fail(f"(b) K1-K3 launches {l_b}, expected "
             f"{silos * steps_flat} each (the silos' steps, no eval)")
    rec["b"] = {"losses": loss_b, "bitwise": bitwise_b, "launches": l_b,
                "rounds": hist_b}

    # (c) int8 with the writer thread, traced for the codec's counters
    obs.configure(enabled=True, reset=True)
    torch.cuda.synchronize()
    att.reset_launch_counts()
    try:
        with WireStateSyncs(wire) as syncs:
            hist_c, apis_c, seconds["c"] = wire_silos(
                torch, fedml_tpu_torch, WIRE_TEXT, ds, n_out, "wire_c",
                wire_precision="int8", wire_overlap=True, **WIRE_DIST)
        counters = obs.get_tracer().summary()["counters"]
    finally:
        obs.configure(enabled=False, reset=True)
    l_c = launch_counts(att)
    loss_c = [h["train_loss"] for h in hist_c]
    gap_c = max(abs(a - b) for a, b in zip(loss_c, loss_b))
    ef = float(counters.get("wire.ef_norm", 0.0))
    nbytes = wire_partial_bytes(two.layout, two.state.global_params)
    # the state sync with its residual: the silos hold, bitwise, the last
    # sync's params, and each sync's error is the link's residual step
    sync_rows = syncs.check()
    last_sent = syncs.syncs[-1]["sent"] if syncs.syncs else {}
    silos_hold = bool(last_sent) and all(
        all(torch.equal(api.state.global_params[k].cpu(),
                        torch.as_tensor(v)) for k, v in last_sent.items())
        for r, api in apis_c.items() if r)
    ef_ok = len(sync_rows) == WIRE_TEXT["comm_round"] and all(
        abs(x["norm"] - x["ef_step_norm"]) <= WIRE_EF_REL_TOL * x["norm"]
        and abs(x["max_err"] - x["ef_step_max"])
        <= WIRE_EF_REL_TOL * x["max_err"] for x in sync_rows)
    say("wire", f"(c) int8 + wire_overlap: {seconds['c']:.2f} s; losses "
                f"{loss_c}; gap to (b) {gap_c:.3e} (tol "
                f"{WIRE_INT8_TEXT_TOL}; the JAX package's lr bound "
                f"{WIRE_INT8_TOL}: "
                f"{'within' if gap_c < WIRE_INT8_TOL else 'outside'}); "
                f"EF norm (last) {ef:.4e}; wire bytes "
                f"{counters.get('wire.bytes', 0):,.0f} vs modeled "
                f"{counters.get('wire.modeled_bytes', 0):,.0f}; K1-K3 "
                f"launches {l_c} [{smi}]")
    for prec, r in nbytes.items():
        say("wire", f"  a text partial at {prec}: payload {r['payload']:,}"
                    f" B, modeled {r['modeled']:,} B, framed "
                    f"{r['framed']:,} B")
    for r, x in enumerate(sync_rows):
        say("wire", f"  round {r}'s int8 state sync: the silos' params "
                    f"{x['max_err']:.4e} at most from the server's (L2 "
                    f"{x['norm']:.4e}); the link's residual step "
                    f"{x['ef_step_max']:.4e} (L2 {x['ef_step_norm']:.4e})")
    say("wire", f"  every silo holds the last sync's params bitwise: "
                f"{silos_hold}")
    if not ef_ok:
        fail(f"(c) the state syncs' errors {sync_rows} are not the "
             f"link's residual steps (rel {WIRE_EF_REL_TOL})")
    if not silos_hold:
        fail("(c) a silo does not hold the params of the last state sync")
    if not (0 < gap_c < WIRE_INT8_TEXT_TOL) or not finite(*loss_c):
        fail(f"(c) int8 vs fp32 loss gap {gap_c:.3e} outside "
             f"(0, {WIRE_INT8_TEXT_TOL})")
    if not ef > 0:
        fail("(c) the int8 wire kept no error feedback")
    if not counters.get("wire.bytes") or counters.get("wire.bytes") != \
            counters.get("wire.modeled_bytes") or any(
                r["payload"] != r["modeled"] for r in nbytes.values()):
        fail("(c) the wire's payload bytes differ from the codec's model")
    if l_c != l_b:
        fail(f"(c) K1-K3 launches {l_c} != (b)'s {l_b}")
    rec["c"] = {"losses": loss_c, "gap_to_b": gap_c, "ef_norm": ef,
                "wire_bytes": counters.get("wire.bytes"),
                "wire_modeled_bytes": counters.get("wire.modeled_bytes"),
                "partial_bytes": nbytes, "launches": l_c,
                "state_syncs": sync_rows}

    # (d) the buffered-async driver on lr, beside the in-process engine
    ds_l, n_l = data.load(sp_args(fedml_tpu_torch, **WIRE_ASYNC))
    built, out = {}, {}
    for r in (2, 1, 0):
        a = sp_args(fedml_tpu_torch, **dict(WIRE_ASYNC, rank=r,
                                            run_id="wire_d"))
        m = model.create(a, n_l)
        built[r] = (a, m, FedAvgAPI(a, "cuda", ds_l, m))

    def run_d(r):
        a, m, api = built[r]
        out[r] = run_async_federation(a, "cuda", ds_l, m, api=api)

    seconds["d"] = wire_threads(torch, (2, 1, 0), "wire_d", run_d)
    hist_d = out[0]
    ref_args = sp_args(fedml_tpu_torch, **dict(
        WIRE_ASYNC, federated_optimizer="fedbuff",
        async_buffer_k=2 * WIRE_ASYNC["client_num_per_round"]))
    ref = FedBuffAPI(ref_args, "cuda", ds_l, model.create(ref_args, n_l))
    init = {k: v.clone() for k, v in ref.state.global_params.items()}
    for r in range(WIRE_ASYNC["comm_round"]):
        ref.train_one_round(r)
    dist = lambda a, b: float(torch.sqrt(sum(
        torch.sum((a[k] - b[k]) ** 2) for k in b)))
    got = built[0][2].state.global_params
    rel = dist(got, ref.state.global_params) / dist(
        ref.state.global_params, init)
    loss_d = [h["train_loss"] for h in hist_d]
    say("wire", f"(d) run_async_federation, 2 workers, int8: "
                f"{seconds['d']:.2f} s; {len(hist_d)} applies, losses "
                f"{loss_d}, staleness p50 "
                f"{[h['staleness_p50'] for h in hist_d]}; params vs "
                f"FedBuffAPI {rel:.4f} of its move (bound {WIRE_ASYNC_REL})"
                f" [{smi}]")
    if len(hist_d) != WIRE_ASYNC["comm_round"] or not finite(*loss_d):
        fail(f"(d) applies {len(hist_d)}, losses {loss_d}")
    if rel > WIRE_ASYNC_REL:
        fail(f"(d) params {rel:.4f} of FedBuffAPI's move from theirs")
    rec["d"] = {"losses": loss_d, "rel_to_fedbuff": rel, "rounds": hist_d}

    # (e) wire checkpoints: resume bitwise; the WAL's digests
    t0 = time.time()
    ds_e, n_e = data.load(sp_args(fedml_tpu_torch, **WIRE_CKPT))
    tmp = tempfile.mkdtemp(prefix="wire_ckpt_")
    try:
        def mk(cls, **o):
            a = sp_args(fedml_tpu_torch, **dict(WIRE_CKPT, **o))
            return cls(a, "cuda", ds_e, model.create(a, n_e))

        first = mk(FedAvgAPI, checkpoint_dir=os.path.join(tmp, "sp"))
        for r in range(2):
            first.train_one_round(r)
            first.maybe_checkpoint(r)
        fresh = mk(FedAvgAPI, checkpoint_dir=os.path.join(tmp, "sp"))
        start = fresh.maybe_resume()
        resumed = start == 2 and xs_bitwise(
            torch, fresh.state.global_params, first.state.global_params)
        hist_e, _api, _s = wire_silos(
            torch, fedml_tpu_torch, WIRE_CKPT, ds_e, n_e, "wire_e",
            checkpoint_dir=os.path.join(tmp, "silo"))
        ref_e = mk(HierarchicalSiloAPI)
        codec = wire.WireCodec("fp32", WIRE_CKPT["wire_block"],
                               ref_e.layout)
        want = []
        for r in range(WIRE_CKPT["comm_round"]):
            p, _ = codec.encode(wire.state_tree(ref_e.state))
            want.append(f"{zlib.crc32(encode_tree(p)):08x}")
            ref_e.train_one_round(r)
        digests = [e.get("state_digest")
                   for e in RoundWAL(os.path.join(tmp, "silo")).entries()]
        files = sorted(os.listdir(os.path.join(tmp, "silo")))
        last = WireCheckpointer(os.path.join(tmp, "silo"),
                                layout=ref_e.layout).restore_state()
        ckpt_ok = all(torch.equal(last[f"global_params/{k}"], v.cpu())
                      for k, v in ref_e.state.global_params.items())
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    seconds["e"] = time.time() - t0
    say("wire", f"(e) checkpoint_codec=wire: resumed at round {start}, "
                f"bitwise {resumed}; combine tier WAL digests {digests} vs "
                f"the shipped state's {want}; files {files}; its last "
                f"checkpoint = the in-process state: {ckpt_ok}; "
                f"{seconds['e']:.2f} s")
    if not resumed:
        fail("(e) the wire checkpoint did not resume bitwise")
    if digests != want or not ckpt_ok:
        fail("(e) the WAL's state digests or the last checkpoint differ "
             "from the state shipped")
    rec["e"] = {"resumed_at": start, "digests": digests}
    rec["seconds"] = seconds
    rec["text_launches"] = l_two
    return rec


def _kernel_inputs(torch, att, gen, b, h, hkv, s, d, causal, dt):
    """K1-K3's inputs at one shape, drawn from ``gen`` (the order
    ``time_kernels`` takes)."""
    dtype = getattr(torch, dt)
    mk = lambda *shape: torch.randn(shape, generator=gen, device="cuda",
                                    dtype=torch.float32).to(dtype)
    q, k, v, do = mk(b, h, s, d), mk(b, hkv, s, d), mk(b, hkv, s, d), \
        mk(b, h, s, d)
    o, lse = att.flash_attention_fwd(q, k, v, causal)
    _, delta = att.flash_attention_bwd_dq(q, k, v, o, lse, do, causal)
    return q, k, v, do, o, lse, delta


# -- phase 21: the obs plane ---------------------------------------------------

#: phase 21 (a): phase 5 (b)'s FEMNIST CNN in blocks of 4 for 8 rounds
OBS_BLOCK, OBS_ROUNDS = 4, 8
#: phase 21 (b): tests/test_fedmon.py's label-flip config (lr, 64 clients,
#: 32 a round, 6 flipped, 10 rounds, seed 7); FedBuff with the buffer the
#: cohort (tests/test_torch_obs_engines.py)
OBS_FLIP = dict(dataset="synthetic", num_classes=10, input_shape=(28, 28, 1),
                train_size=4096, test_size=256, model="lr",
                client_num_in_total=64, client_num_per_round=32,
                comm_round=10, epochs=1, batch_size=16, learning_rate=0.1,
                random_seed=7, partition_method="homo",
                frequency_of_the_test=5, health=True)
OBS_FLIP_RUNS = {"sp": {},
                 "fused": dict(round_block=5,
                               frequency_of_the_test=10 ** 9),
                 "fedbuff": dict(federated_optimizer="fedbuff",
                                 async_buffer_k=32,
                                 async_latency_median_s=5.0,
                                 async_latency_sigma=1.2,
                                 async_inflight_gens=3,
                                 frequency_of_the_test=4)}
OBS_FLIP_BAR = 0.9
#: phase 21 (c): phase 8's text model at full width, f32, its cohort (the
#: text shape); the probe's timed repeats cut from 3 to 2 to fit the phase
OBS_PROBE_TEXT = dict(TEXT_REALTEXT, comm_round=1)
OBS_PROBE_REPEATS = 2
#: phase 21 (d): the probe's event timer against graph_ms
OBS_TIMER_TOL = 0.10


def obs_flip_run(fedml_tpu_torch, kind, dev):
    """Phase 21 (b)'s run of ``kind`` on ``dev``: the flagged set, the
    flipped set and the monitor's gauges."""
    import numpy as np

    from fedml_tpu_torch import data, model
    from fedml_tpu_torch.simulation.async_engine import FedBuffAPI
    from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI

    args = sp_args(fedml_tpu_torch, **dict(OBS_FLIP, **OBS_FLIP_RUNS[kind]))
    ds, n_out = data.load(args)
    flipped = sorted(np.random.default_rng(0).choice(
        64, size=6, replace=False).tolist())
    for c in flipped:
        idx = ds.client_idxs[c]
        ds.train_y[idx] = 9 - ds.train_y[idx]
    cls = FedBuffAPI if kind == "fedbuff" else FedAvgAPI
    api = cls(args, dev, ds, model.create(args, n_out))
    api.train()
    return api.health_monitor.flagged(), flipped, \
        api.health_monitor.gauges()


def obs_phase(torch, fedml_tpu_torch, att, smi):
    """Phase 21."""
    import urllib.request

    from fedml_tpu_torch import data, device, model, obs
    from fedml_tpu_torch.analysis import TorchRuntimeAudit
    from fedml_tpu_torch.core.compression.blockscale import \
        collective_payload_nbytes
    from fedml_tpu_torch.obs import devicetime
    from fedml_tpu_torch.obs.metricsd import parse_prometheus_text, \
        prom_value
    from fedml_tpu_torch.runner import FedMLRunner

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    import fedtrace

    rec, seconds = {}, {}
    t_phase = time.time()
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)

    # (a) the fused FEMNIST CNN, obs off and on, the steady-state block
    # under TorchRuntimeAudit (sync debug mode "warn")
    t0 = time.time()
    base = sp_args(fedml_tpu_torch, **SP_FEMNIST_CNN)
    ds, n_out = data.load(base)
    trace_path = os.path.join(out_dir, "obs_trace.json")
    runs = {}
    for mode, over in (("off", {}),
                       ("on", dict(trace=True, trace_path=trace_path,
                                   health=True, metrics_port=0))):
        obs.configure(enabled=False, reset=True)
        cfg = dict(SP_FEMNIST_CNN, round_block=OBS_BLOCK,
                   comm_round=OBS_ROUNDS, **over)
        args = sp_args(fedml_tpu_torch, **cfg)
        api = FedMLRunner(args, device.get_device(args), ds,
                          model.create(args, n_out)).runner.fl_trainer
        audit = TorchRuntimeAudit(sync_debug=True)
        block = api.train_block

        def audited(r, block=block, audit=audit):
            if r == OBS_BLOCK:     # the steady state: after every capture
                audit.__enter__()
            return block(r)

        api.train_block = audited
        try:
            api.train()
        finally:
            audit.__exit__(None, None, None)
        torch.cuda.synchronize()
        runs[mode] = api, audit
    (off, a_off), (on, a_on) = runs["off"], runs["on"]
    l_off = [r["train_loss"] for r in off.metrics_history]
    l_on = [r["train_loss"] for r in on.metrics_history]
    if l_on != l_off or len(l_on) != OBS_ROUNDS:
        fail(f"(a) the traced run's losses differ: {l_on} vs {l_off}")
    for k, v in off.state.global_params.items():
        if not torch.equal(on.state.global_params[k], v):
            fail(f"(a) the traced run's param {k} differs")
    if on._block_fn.captures != off._block_fn.captures:
        fail(f"(a) captures {on._block_fn.captures} with obs on vs "
             f"{off._block_fn.captures} off")
    counts = {m: {"syncs": a.syncs, "compilations": a.compilations,
                  "device_puts": a.device_puts,
                  "device_gets": a.device_gets} for m, a in
              (("off", a_off), ("on", a_on))}
    sites = {"off": a_off.sync_sites, "on": a_on.sync_sites}
    if counts["on"] != counts["off"] or counts["on"]["compilations"]:
        fail(f"(a) steady-state audit differs: {counts}; sync sites "
             f"{sites}")
    rows = [e["args"] for e in obs.get_tracer().events()
            if e.get("name") == "obs.round"]
    n_params = sum(v.numel() for v in on.state.global_params.values())
    cbytes = 2.0 * collective_payload_nbytes(n_params, "fp32")
    if [r["round"] for r in rows] != list(range(OBS_ROUNDS)):
        fail(f"(a) obs.round rows for rounds {[r['round'] for r in rows]}")
    for r in rows:
        if not all(v == v and abs(v) < float("inf") for v in r.values()):
            fail(f"(a) non-finite obs row {r}")
        if r["collective_bytes"] != cbytes or r["update_norm"] <= 0:
            fail(f"(a) obs row {r} (byte model {cbytes})")
    summary = fedtrace.summarize(fedtrace.load_trace(trace_path))
    if summary["rounds"] != OBS_ROUNDS:
        fail(f"(a) fedtrace summarize read {summary['rounds']} rounds")
    with urllib.request.urlopen(on.metrics_server.url + "/metrics",
                                timeout=10) as resp:
        samples = parse_prometheus_text(resp.read().decode())
    if prom_value(samples, "fedmon_gauge",
                  name="health.rounds_observed") != OBS_ROUNDS:
        fail("(a) /metrics: health.rounds_observed is not the rounds")
    on.metrics_server.close()
    steady = lambda api: sum(r["round_time"] for r in
                             api.metrics_history[OBS_BLOCK:]) / \
        (OBS_ROUNDS - OBS_BLOCK)
    rec["fused"] = {"s_per_round_off": steady(off),
                    "s_per_round_on": steady(on),
                    "captures": on._block_fn.captures, "audit": counts,
                    "sync_sites": sites,
                    "collective_bytes": cbytes,
                    "summary_phases": summary["phases"]}
    obs.configure(enabled=False, reset=True)
    seconds["fused"] = time.time() - t0
    say("obs", f"(a) FEMNIST CNN, blocks of {OBS_BLOCK}, {OBS_ROUNDS} "
               f"rounds: obs on bitwise obs off; captures "
               f"{on._block_fn.captures} both; steady-state audit {counts}; "
               f"{len(rows)} finite obs.round rows, collective bytes "
               f"{cbytes:.0f} = the byte model; fedtrace phases "
               f"{ {k: round(v, 6) for k, v in summary['phases'].items()} }; "
               f"/metrics parsed; s/round steady state on "
               f"{rec['fused']['s_per_round_on']:.5f} vs off "
               f"{rec['fused']['s_per_round_off']:.5f} [{smi}]")
    del runs, off, on

    # (b) label flips on sp, fused and FedBuff: the card flags the port's
    # CPU set, at precision and recall >= 0.9
    t0 = time.time()
    rec["flags"] = {}
    for kind in OBS_FLIP_RUNS:
        card, flipped, g = obs_flip_run(fedml_tpu_torch, kind, "cuda")
        cpu, _, _ = obs_flip_run(fedml_tpu_torch, kind, "cpu")
        tp = len(set(card) & set(flipped))
        precision = tp / max(len(card), 1)
        recall = tp / len(flipped)
        rec["flags"][kind] = {"card": card, "cpu": cpu, "flipped": flipped,
                              "precision": precision, "recall": recall,
                              "staleness_p99": g["health.staleness_p99"]}
        say("obs", f"(b) {kind}: card flags {card}, CPU {cpu}, flipped "
                   f"{flipped}: precision {precision:.2f}, recall "
                   f"{recall:.2f}, staleness p99 "
                   f"{g['health.staleness_p99']}")
        if card != cpu:
            fail(f"(b) {kind}: the card flags {card}, the CPU {cpu}")
        if precision < OBS_FLIP_BAR or recall < OBS_FLIP_BAR:
            fail(f"(b) {kind}: precision {precision} / recall {recall} "
                 f"below {OBS_FLIP_BAR}")
    seconds["flags"] = time.time() - t0

    # (c) the trace_device probe on the text model at full width (f32):
    # the four phases measured, K1-K3 counted around the probe
    t0 = time.time()
    obs.configure(enabled=True, reset=True)
    api = build_sp(sp_args(fedml_tpu_torch, **dict(
        OBS_PROBE_TEXT, trace=True, trace_device=True)))
    mod = api.model.module
    if (mod.tok_embed.weight.shape, mod.n_layers,
            mod.layer_0.ff_up.weight.shape[0]) != ((8192, 256), 4, 512):
        fail("(c) not the text model at its full width")
    steps = api._stage_round_arrays(0)[4]
    att.reset_launch_counts()
    phases = devicetime.measure_device_phases(api, round_idx=0,
                                              repeats=OBS_PROBE_REPEATS)
    torch.cuda.synchronize()
    probe = launch_counts(att)
    counters = obs.get_tracer().summary()["counters"]
    obs.configure(enabled=False, reset=True)
    if not all(phases[p] > 0 for p in obs.DEVICE_PHASES) or \
            any(counters.get(f"device.{p}_s") != phases[p]
                for p in obs.DEVICE_PHASES):
        fail(f"(c) phases {phases}, counters {counters}")
    # the probe runs the cohort's client map once untimed and ``repeats``
    # times timed; the vmapped map launches each kernel once a layer a step
    passes = OBS_PROBE_REPEATS + 1
    want = {k: passes * mod.n_layers * steps for k in probe}
    if probe != want:
        fail(f"(c) probe launches {probe}, want {want} ({passes} passes x "
             f"{mod.n_layers} layers x {steps} steps)")
    rec["probe_text"] = {"phases_s": phases, "launches": probe,
                         "steps": steps, "passes": passes}
    seconds["probe_text"] = time.time() - t0
    say("obs", f"(c) trace_device on the text model (dim 256, 4 layers, "
               f"f32, 5 clients, {steps} steps): phases "
               f"{ {k: round(v * 1e3, 4) for k, v in phases.items()} } ms; "
               f"K1-K3 launches {probe} ({passes} client maps) [{smi}]")
    del api

    # (d) the probe's event timer on phase 3's K1 text-shape graph
    t0 = time.time()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    _, b, h, hkv, s, d, causal, _ = [x for x in KERNEL_SHAPES
                                     if x[0] == "text"][0]
    q, k, v = (torch.randn((b, n, s, d), generator=gen, device="cuda")
               for n in (h, hkv, hkv))
    fn = lambda: att.flash_attention_fwd(q, k, v, causal)
    ref_ms = graph_ms(torch, fn)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(20):
            fn()
    probe_s, _ = devicetime._timed(lambda: (graph.replay(), q)[1],
                                   repeats=3)
    probe_ms = probe_s * 1e3 / 20
    del graph
    rec["timer"] = {"probe_ms": probe_ms, "graph_ms": ref_ms,
                    "rel": abs(probe_ms - ref_ms) / ref_ms}
    seconds["timer"] = time.time() - t0
    say("obs", f"(d) K1 @text: the probe's event timer {probe_ms:.5f} ms "
               f"a call vs graph_ms {ref_ms:.5f} ms "
               f"({100 * rec['timer']['rel']:.2f}% apart, bar "
               f"{100 * OBS_TIMER_TOL:.0f}%) [{smi}]")
    if rec["timer"]["rel"] > OBS_TIMER_TOL:
        fail(f"(d) the probe's timer reads {probe_ms} ms, graph_ms "
             f"{ref_ms} ms")
    seconds["phase"] = time.time() - t_phase
    rec["seconds"] = seconds
    return rec


# -- 22. trust: serving's obs hooks, the defended DP text federation ---------
#: (a): phase 14's engine on its model: 4 slots, 8 requests over two
#: adapters (prompts of 24..64 byte tokens, 8 new tokens each), then a
#: 2-token request after a pause that rolls the engine's token window
TRUST_SERVE_SLOTS = 4
TRUST_SERVE_NEW = 8
TRUST_SERVE_BUF = 128
TRUST_SERVE_PAUSE_S = 0.6
TRUST_SERVE_RULES = [
    {"name": "ttft", "objective": {"metric": "serve_ttft_seconds",
                                   "threshold": 5.0, "compliance": 0.99}},
    {"name": "error_rate", "metric": "serve.error_rate", "max": 0.01}]
TRUST_TRACE_ID = "4bf92f3577b34da6a3ce929d0e0e4736"
TRUST_TRACEPARENT = f"00-{TRUST_TRACE_ID}-00f067aa0ba902b7-01"
#: (b): phase 19 (b)'s text model at full width as 5 silos for 2 rounds,
#: through a FedAvg ServerAggregator's hooks with these flags: the
#: byzantine attack (random mode) on the first silo, krum, global Gaussian
#: DP (σ = 1e-3·√(2 ln 1.25e5)/10)
TRUST_TEXT = dict(TEXT_REALTEXT, client_num_per_round=5,
                  client_id_list=[1, 2, 3, 4, 5], comm_round=2)
TRUST_FLAGS = dict(enable_attack=True, attack_type="byzantine",
                   attack_mode="random", byzantine_client_num=1,
                   enable_defense=True, defense_type="krum", enable_dp=True,
                   dp_solution_type="global_dp", dp_mechanism_type="gaussian",
                   dp_epsilon=10.0, dp_sensitivity=1e-3)
#: (b-small): phase 8 (e)'s narrow text model as 4 silos, 2 rounds, the
#: same flags, card vs the CPU process
TRUST_SMALL = dict(TEXT_SMALL, client_num_per_round=4,
                   client_id_list=[1, 2, 3, 4], comm_round=2,
                   random_seed=3)
#: (c): the stack: 8 clients, honest ones at noise 0.01·(1 + i/4) around a
#: common N(0, 1) base (distinct krum scores), clients 0 and 1 shifted by
#: +100, weights 10 + i
TRUST_C = 8
TRUST_SHIFTED = 2
#: (c): card vs CPU merges, relative (f32 sums in another order)
TRUST_DEFENSE_TOL = 1e-6
#: (c): a merge whose f32 rounding is itself above TRUST_DEFENSE_TOL at
#: this D (norms and cosines summed over 4.2 M f32 terms: FoolsGold's
#: logits of 1 − max cosine, cclip's and the clips' scales) is held to its
#: float64 run instead: card and CPU each within this many times the CPU
#: f32 run's own distance from it
TRUST_WITNESS_FACTOR = 4.0
#: (c): a krum or bulyan choice that differs card vs CPU is a near tie when
#: the scores of the clients in only one choice lie within this relative
#: distance (f32 squared distances by the product identity at this D round
#: to ~1e-3 of their size); a tie is reported and its merge not compared
TRUST_TIE_REL = 1e-3
#: a phase's CPU process's deadline once the phase waits for it (phases
#: 22 and 23), and how long phase 23's waits for (a)'s input
TRUST_CPU_JOIN_S = 240


def trust_args(fedml_tpu_torch, **over):
    return fedml_tpu_torch.load_arguments().update(**over)


def trust_serve(eng, prompts, adapters, traceparent=None):
    """The 8 requests submitted while the engine waits on its lock (so
    every run admits them in one order), drained, then the trailing
    request after a pause: (tokens, seconds of the 8, decode steps of the
    8: read after the pause, once the engine has counted its last)."""
    with eng._cond:
        t0 = time.time()
        ticks0 = eng._ticks
        qs = [eng.submit(p, max_new_tokens=TRUST_SERVE_NEW, adapter=a,
                         traceparent=traceparent if i == 0 else None)
              for i, (p, a) in enumerate(zip(prompts, adapters))]
    toks = [[t for t in iter(lambda q=q: q.get(timeout=600), None)]
            for q in qs]
    dt = time.time() - t0
    time.sleep(TRUST_SERVE_PAUSE_S)
    ticks = eng._ticks - ticks0
    q = eng.submit(prompts[0][:8], max_new_tokens=2, adapter=adapters[1])
    toks.append([t for t in iter(lambda: q.get(timeout=600), None)])
    return toks, dt, ticks


def serving_obs_phase(torch, fedml_tpu_torch, smi, carry):
    """Phase 22 (a), on phase 14's model (carried like phase 15's)."""
    import collections
    import urllib.request

    import numpy as np

    from fedml_tpu_torch import obs
    from fedml_tpu_torch.analysis import TorchRuntimeAudit
    from fedml_tpu_torch.obs.metricsd import (parse_prometheus_text,
                                              prom_value)
    from fedml_tpu_torch.serving import ContinuousBatchingEngine
    from fedml_tpu_torch.serving.templates import openai_compat as oc

    t0 = time.time()
    dev = torch.device("cuda", 0)
    model = carry["model"]
    tok = oc.ByteTokenizer()
    prompts = serve_prompts(np, tok, 8, 24, 64, 22)
    adapters = ["a0", "a1"] * 4
    loras = saturated_adapters(torch, model, 2, dev)
    runs = {}
    for mode in ("off", "on"):
        on = mode == "on"
        obs.configure(enabled=on, reset=True)
        if on:
            os.environ["FEDML_SERVE_LEGACY_ADAPTER_COUNTERS"] = "1"
        kw = dict(metrics_port=0, slo_rules=TRUST_SERVE_RULES,
                  hist_labels=2) if on else {}
        eng = ContinuousBatchingEngine(model, None, slots=TRUST_SERVE_SLOTS,
                                       buf_len=TRUST_SERVE_BUF,
                                       adapter_slots=3, **kw)
        try:
            for name, lora in zip(("a0", "a1"), loras):
                eng.registry.register(name, lora)
            warm = eng.generate(prompts[0][:8], max_new_tokens=2,
                                adapter="a0")
            torch.cuda.synchronize()
            with TorchRuntimeAudit(sync_debug=True) as audit:
                toks, dt, ticks = trust_serve(
                    eng, prompts, adapters,
                    TRUST_TRACEPARENT if on else None)
            text = None
            if on:
                with urllib.request.urlopen(eng.metrics_server.url +
                                            "/metrics", timeout=30) as r:
                    text = r.read().decode()
        finally:
            eng.stop()
            os.environ.pop("FEDML_SERVE_LEGACY_ADAPTER_COUNTERS", None)
        events = obs.get_tracer().events() if on else []
        obs.configure(enabled=False, reset=True)
        runs[mode] = dict(toks=[warm] + toks, ms=dt * 1e3 / max(ticks, 1),
                          ticks=ticks, sites=collections.Counter(
                              audit.sync_sites), stats=eng.serve_stats,
                          text=text, events=events, eng=eng)
    off, on = runs["off"], runs["on"]
    if on["toks"] != off["toks"]:
        fail("(a) the tokens with the obs hooks on differ from off")
    if on["ticks"] != off["ticks"] or on["sites"] != off["sites"]:
        fail(f"(a) host syncs by site differ on vs off: {on['ticks']} vs "
             f"{off['ticks']} steps, {dict(on['sites'])} vs "
             f"{dict(off['sites'])}")
    # the host's own counts: the warm request, the 8 and the trailing one
    n_tok = sum(len(t) for t in on["toks"])
    want = collections.Counter(["a0"] + adapters + ["a1"])
    samples = parse_prometheus_text(on["text"])
    counters = collections.defaultdict(list)
    spans = collections.Counter()
    tagged = []
    for ev in on["events"]:
        if ev.get("ph") == "C":
            counters[ev["name"]].append(ev["args"])
        elif ev.get("ph") == "B":
            spans[ev["name"]] += 1
            tp = ev.get("args", {}).get("traceparent")
            if ev["name"] == "serve.request" and tp:
                tagged.append(tp)
    by_label = {a: max(c["value"] for c in counters[
        "serve.requests_by_adapter"] if c.get("adapter") == a)
        for a in want}
    legacy = {a: counters[f"serve.requests.{a}"][-1]["value"] for a in want}
    total = counters["serve.tokens_total"][-1]["value"]
    scraped = prom_value(samples, "fedtrace_counter",
                         name="serve.tokens_total")
    if not (total == scraped == n_tok == on["stats"]["tokens"]):
        fail(f"(a) serve.tokens_total {total} (scraped {scraped}) is not "
             f"the host's {n_tok} tokens")
    if by_label != dict(want) or legacy != dict(want):
        fail(f"(a) request counters {by_label} / {legacy} != the host's "
             f"{dict(want)}")
    if tagged != [TRUST_TRACEPARENT] or TRUST_TRACE_ID not in tagged[0]:
        fail(f"(a) the span tree's traceparents {tagged}")
    n_req = sum(want.values())
    for name in ("serve.request", "serve.queue", "serve.decode",
                 "serve.admit", "serve.prefill"):
        if spans[name] != n_req:
            fail(f"(a) {spans[name]} {name} spans for {n_req} requests")
    e2e = prom_value(samples, "serve_e2e_seconds_count", adapter="a1")
    if e2e != want["a1"]:
        fail(f"(a) /metrics: serve_e2e_seconds_count a1 {e2e}")
    rec = {"ms_per_step_on": on["ms"], "ms_per_step_off": off["ms"],
           "steps": on["ticks"], "tokens": n_tok,
           "syncs_by_site": dict(on["sites"]),
           "requests_by_adapter": by_label,
           "seconds": time.time() - t0}
    say("trust", f"(a) serving obs on phase 14's model ({model.cfg.n_layers} "
                 f"layers), 4 slots, 8 requests over 2 adapters (+ a warm "
                 f"and a trailing one): tokens "
                 f"bitwise on vs off; {on['ms']:.2f} ms/step on vs "
                 f"{off['ms']:.2f} off over {on['ticks']} steps; host syncs "
                 f"by site equal ({sum(on['sites'].values())} each); "
                 f"serve.tokens_total {total:g} = host {n_tok}; "
                 f"requests_by_adapter {by_label}; /metrics {len(samples)} "
                 f"samples parsed; trace id on serve.request [{smi}]")
    return rec


def trust_fedavg(times, kept, att=None, snaps=None):
    """A minimal FedAvg ``ServerAggregator`` class whose hooks record the
    defense + DP seconds (host clock, synchronized) and krum's choice;
    with ``att``, K1–K3's counts as each round's aggregation starts (the
    silos' passes so far) in ``snaps``, and the launches inside the hooks
    under ``snaps["hooks"]``."""
    from fedml_tpu_torch.core import tree as tree_util
    from fedml_tpu_torch.core.alg_frame.server_aggregator import \
        ServerAggregator
    from fedml_tpu_torch.core.security.fedml_defender import FedMLDefender

    def timed(fn, *a):
        import torch
        if att is not None:
            before = launch_counts(att)
        t0 = time.perf_counter()
        out = fn(*a)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if att is not None:
            hooks = snaps.setdefault("hooks", dict.fromkeys(before, 0))
            for k, n in launch_counts(att).items():
                hooks[k] += n - before[k]
        return out

    class FedAvg(ServerAggregator):
        def get_model_params(self):
            return self._params

        def set_model_params(self, p):
            self._params = p

        def on_before_aggregation(self, raw):
            if att is not None:
                snaps.setdefault("rounds", []).append(launch_counts(att))
            out = timed(super().on_before_aggregation, raw)
            d = FedMLDefender.get_instance().defender
            if d is not None and getattr(d, "last_selected", None) \
                    is not None:
                kept.append((list(d.last_selected),
                             [float(x) for x in d.last_scores.tolist()]))
            return out

        def aggregate(self, raw):
            return tree_util.weighted_average([p for _, p in raw],
                                              [n for n, _ in raw])

        def on_after_aggregation(self, agg):
            return timed(super().on_after_aggregation, agg)

        def test(self, test_data, device, args):
            return None

    return FedAvg


def trust_history(history):
    """An aggregator factory whose ``on_after_aggregation`` output (each
    round's global params) is kept, on the host, in ``history``."""
    times, kept = [], []
    cls = trust_fedavg(times, kept)

    class Recorded(cls):
        def on_after_aggregation(self, agg):
            out = super().on_after_aggregation(agg)
            history.append({k: v.detach().cpu().clone()
                            for k, v in out.items()})
            return out

    return Recorded, times, kept


class trust_draws:
    """Inside the block, every noise draw of the trust stack
    (``core/noise.py::draw``) is recorded into ``log`` (``{purpose: [CPU
    tensors]}``), or, given ``replay``, taken from it in order (moved to
    the draw's device): how the CPU's draws reach the card."""

    def __init__(self, log=None, replay=None):
        self.log, self.replay = log, replay

    def __enter__(self):
        import torch

        from fedml_tpu_torch.core import noise
        self.noise, real = noise, noise.draw
        self.real = real

        def recorded(source, shape, dev, kind="normal", dtype=torch.float32):
            z = real(source, shape, dev, kind, dtype)
            self.log.setdefault(source.purpose, []).append(
                z.detach().cpu().clone())
            return z

        def replayed(source, shape, dev, kind="normal", dtype=torch.float32):
            queue = self.replay.get(source.purpose)
            if not queue or tuple(queue[0].shape) != tuple(shape):
                fail(f"a {source.purpose} draw of {tuple(shape)} has no "
                     "recorded draw of its shape")
            return queue.pop(0).to(device=dev, dtype=dtype)

        noise.draw = recorded if self.replay is None else replayed
        return self

    def __exit__(self, *exc):
        self.noise.draw = self.real


def trust_small_run(torch, fedml_tpu_torch, device, draws=None):
    """(b-small) on ``device``: the narrow text federation with the trust
    flags, every noise draw recorded (``draws`` None) or replayed from
    ``draws`` (with ``"_init"``, the params to start from); the init, each
    round's params, krum's choices and the draws."""
    from fedml_tpu_torch import data

    args = xs_args(fedml_tpu_torch, TRUST_SMALL, 0, "trust_small")
    ds, n_out = data.load(args)
    history, log = [], {}
    factory, times, kept = trust_history(history)
    init = None
    if draws is not None:
        init = {k: v.to(device) for k, v in draws.pop("_init").items()}
    with trust_draws(log=log, replay=draws):
        fed = xs_federation(torch, fedml_tpu_torch, TRUST_SMALL, device,
                            f"trust_small_{'replay' if draws else 'record'}",
                            ds, n_out, init=init,
                            agg_factory=factory, **TRUST_FLAGS)
    return {"init": {k: v.cpu() for k, v in fed["init"].items()},
            "history": history, "kept": [k for k, _ in kept],
            "draws": log}


def trust_stack(torch, shapes, device):
    """(c)'s client list from a seeded CPU generator (the same in both
    processes), on ``device``, and its base."""
    g = torch.Generator().manual_seed(22)
    base = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    raw = []
    for i in range(TRUST_C):
        p = {k: v + (0.01 * (1 + i / 4)) * torch.randn(v.shape, generator=g)
             for k, v in base.items()}
        if i < TRUST_SHIFTED:
            p = {k: v + 100.0 for k, v in p.items()}
        raw.append((10.0 + i, {k: v.to(device) for k, v in p.items()}))
    return raw, {k: v.to(device) for k, v in base.items()}


def trust_rel(got, want):
    """Elementwise relative distance: max |got − want| / (1 + |want|)."""
    return float(((got - want).abs() / (1 + want.abs())).max())


def trust_defend(d, raw, extra):
    """``BaseDefense.run`` phase by phase: (the kept positions or None, the
    output: the merge)."""
    from fedml_tpu_torch.core.security.defense.common import merge_list
    lst, kept = raw, None
    if hasattr(d, "defend_before_aggregation"):
        lst = d.defend_before_aggregation(raw, extra)
        ids = {id(e): i for i, e in enumerate(raw)}
        if all(id(e) in ids for e in lst):
            kept = [ids[id(e)] for e in lst]
    if hasattr(d, "defend_on_aggregation"):
        out = d.defend_on_aggregation(lst, merge_list, extra)
    else:
        out = merge_list(lst)
        if hasattr(d, "defend_after_aggregation"):
            out = d.defend_after_aggregation(out)
    return kept, out


def trust_text_shapes(fedml_tpu_torch):
    """(b)'s text model: its parameter shapes in order, and the model."""
    from fedml_tpu_torch import data, model
    args = xs_args(fedml_tpu_torch, TRUST_TEXT, 0, "trust_shapes")
    _, n_out = data.load(args)
    m = model.create(args, n_out)
    return {n: tuple(p.shape) for n, p in m.module.named_parameters()}, m


def trust_cpu_reference(work):
    """The CPU process of phase 22: (b-small) on the CPU (its draws,
    init and rounds) and (c)'s defenses on the CPU, written under
    ``work``."""
    import torch

    import fedml_tpu_torch
    from fedml_tpu_torch.core.security.defense import (common,
                                                       create_defender,
                                                       registered_names)
    torch.set_num_threads(4)
    t0 = time.time()
    small = trust_small_run(torch, fedml_tpu_torch, "cpu")
    torch.save(small, os.path.join(work, "small.pt"))
    t1 = time.time()
    shapes, m = trust_text_shapes(fedml_tpu_torch)
    common.use_layout(m)
    raw, base = trust_stack(torch, shapes, "cpu")
    raw64 = [(n, {k: v.double() for k, v in p.items()}) for n, p in raw]
    base64 = {k: v.double() for k, v in base.items()}
    flat = common.tree_flatten_1d
    for name in registered_names():
        args = trust_args(fedml_tpu_torch, defense_type=name,
                          byzantine_client_num=2, random_seed=22)
        d, log = create_defender(name, args), {}
        with trust_draws(log=log):
            kept, out = trust_defend(d, raw, base)
        # the float64 run on the same draws: the f32 run's rounding
        with trust_draws(replay={k: list(v) for k, v in log.items()}):
            _, out64 = trust_defend(create_defender(name, args), raw64,
                                    base64)
        e_cpu = trust_rel(flat(out).double(), flat(out64))
        rec = {"kept": kept, "out": out, "draws": log, "e_cpu": e_cpu,
               "selected": getattr(d, "last_selected", None),
               "scores": getattr(d, "last_scores", None)}
        if e_cpu * TRUST_WITNESS_FACTOR > TRUST_DEFENSE_TOL:
            rec["out64"] = out64
        torch.save(rec, os.path.join(work, f"c_{name}.pt"))
    with open(os.path.join(work, "done.json"), "w") as f:
        json.dump({"small_s": t1 - t0, "defenses_s": time.time() - t1}, f)


def cpu_process_start(phase, entry):
    """Start the CPU process of phase ``phase`` (no card:
    ``CUDA_VISIBLE_DEVICES`` empty), running ``chip_smoke.<entry>(work)``
    with its work directory ``.phase<phase>_trust/``."""
    import shutil
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, f".phase{phase}_trust")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    log = open(os.path.join(work, "cpu.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke as c; "
         f"c.{entry}({work!r})"], cwd=root, env=env,
        stdout=log, stderr=subprocess.STDOUT)
    # a failed check exits early: the process must not outlive this one
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return {"proc": proc, "work": work, "log": log, "phase": phase}


def cpu_process_join(child):
    """Wait for a phase's CPU process (``TRUST_CPU_JOIN_S``); its log on
    failure, else its ``done.json``."""
    try:
        code = child["proc"].wait(timeout=TRUST_CPU_JOIN_S)
    except subprocess.TimeoutExpired:
        child["proc"].kill()
        code = "timeout"
    child["log"].close()
    if code != 0:
        with open(os.path.join(child["work"], "cpu.log")) as f:
            tail = f.read()[-3000:]
        fail(f"phase {child['phase']}'s CPU process exited {code}: {tail}")
    with open(os.path.join(child["work"], "done.json")) as f:
        return json.load(f)


def trust_defenses(torch, fedml_tpu_torch, smi, work, shapes, model):
    """(c): every registered defense on the card, the CPU's noise draws
    carried, against the CPU process's run of it."""
    from fedml_tpu_torch.core.security.defense import (common,
                                                       create_defender,
                                                       registered_names)
    dev = torch.device("cuda", 0)
    common.use_layout(model)
    raw, base = trust_stack(torch, shapes, dev)
    flat = common.tree_flatten_1d
    d_params = sum(v.numel() for v in raw[0][1].values())
    rec, ties = {}, []
    for name in registered_names():
        args = trust_args(fedml_tpu_torch, defense_type=name,
                          byzantine_client_num=2, random_seed=22)
        ref = torch.load(os.path.join(work, f"c_{name}.pt"))
        d = create_defender(name, args)
        with trust_draws(replay={k: list(v) for k, v in
                                 ref["draws"].items()}):
            kept, out = trust_defend(d, raw, base)
        sel = getattr(d, "last_selected", None)
        if sel != ref["selected"]:
            # krum's or bulyan's choice differs: a near tie is reported
            # with both devices' scores and its merge not compared
            cs, gs = ref["scores"].tolist(), d.last_scores.tolist()
            vals = [cs[i] for i in set(sel) ^ set(ref["selected"])]
            tie = max(vals) - min(vals) <= TRUST_TIE_REL * max(map(abs,
                                                                 vals))
            ties.append({"defense": name, "card": sel,
                         "cpu": ref["selected"], "card_scores": gs,
                         "cpu_scores": cs, "tie": tie})
            say("trust", f"(c) {name}: the card keeps {sel}, the CPU "
                         f"{ref['selected']} ({'a near tie' if tie else 'NOT a tie'}); "
                         f"card scores {gs}, CPU scores {cs}")
            if not tie:
                fail(f"(c) {name}: the card's choice {sel} differs from the "
                     f"CPU's {ref['selected']} beyond a tie")
            continue
        if kept != ref["kept"]:
            fail(f"(c) {name}: kept {kept} on the card vs {ref['kept']} on "
                 "the CPU")
        got = flat(out)
        gap = trust_rel(got, flat(ref["out"]).to(dev))
        bar, e_card = TRUST_DEFENSE_TOL, None
        if gap > bar and "out64" in ref:
            bar = TRUST_WITNESS_FACTOR * ref["e_cpu"]
            e_card = trust_rel(got.double(), flat(ref["out64"]).to(dev))
        if not (gap <= bar and (e_card is None or e_card <= bar)):
            fail(f"(c) {name}: card vs CPU merge {gap:.3e}, card vs its "
                 f"float64 run {e_card}, bar {bar:.3e} (the CPU f32 run "
                 f"{ref['e_cpu']:.3e} from it)")
        # the device time: CUDA events around a second call (warm)
        d = create_defender(name, args)
        trust_defend(d, raw, base)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        trust_defend(d, raw, base)
        end.record()
        end.synchronize()
        rec[name] = {"ms": start.elapsed_time(end), "gap": gap, "bar": bar,
                     "e_cpu": ref["e_cpu"], "e_card": e_card,
                     "kept": kept, "selected": sel}
    held = [n for n, r in rec.items() if r["e_card"] is not None]
    say("trust", f"(c) {len(rec)} defenses on the card at C {TRUST_C}, D "
                 f"{d_params:,} ({TRUST_SHIFTED} rows +100) vs the CPU "
                 f"process, its noise draws carried: kept sets equal "
                 f"({len(ties)} near ties), merges within "
                 f"{TRUST_DEFENSE_TOL:g} relative; held to their float64 "
                 f"runs instead (f32 rounding above the bar at this D): "
                 + ", ".join(f"{n} (card vs CPU {rec[n]['gap']:.2e}, card "
                             f"{rec[n]['e_card']:.2e} and CPU "
                             f"{rec[n]['e_cpu']:.2e} from float64)"
                             for n in held) + f" [{smi}]")
    say("trust", "  ms on the card (CUDA events, a warm call): " + ", ".join(
        f"{n} {r['ms']:.2f}" for n, r in rec.items()))
    return {"defenses": rec, "ties": ties, "d_params": d_params}


def trust_phase(torch, fedml_tpu_torch, att, smi, child, serve_rec):
    """Phase 22 (b), (b-small) and (c); (a) ran at phase 15's end."""
    import math

    from fedml_tpu_torch import data
    from fedml_tpu_torch.core import rng as rng_util

    out, seconds = {"serving_obs": serve_rec}, {}
    t_phase = time.time()

    # (b) the text model at full width, 5 silos, trust on and off
    t0 = time.time()
    targs = xs_args(fedml_tpu_torch, TRUST_TEXT, 0, "trust_b")
    tds, t_out = data.load(targs)
    seed, bs = int(targs.random_seed), int(targs.batch_size)
    rounds, n_silo = TRUST_TEXT["comm_round"], len(TRUST_TEXT[
        "client_id_list"])
    steps = sum(tds.client_index_batches(int(c), bs, seed, r).shape[0]
                for r in range(rounds)
                for c in rng_util.sample_clients(
                    seed, r, TRUST_TEXT["client_num_in_total"], n_silo))
    n_eval = len(tds.test_batches()[0])
    evals = sum(1 for r in range(rounds)
                if r % int(targs.frequency_of_the_test) == 0
                or r == rounds - 1)
    want = expect_launches(4, steps + n_eval * evals, steps)
    steps0 = sum(tds.client_index_batches(int(c), bs, seed, 0).shape[0]
                 for c in rng_util.sample_clients(
                     seed, 0, TRUST_TEXT["client_num_in_total"], n_silo))
    times, kept, snaps = [], [], {}
    factory = trust_fedavg(times, kept, att, snaps)
    fed, got = counted(torch, att, lambda: xs_federation(
        torch, fedml_tpu_torch, dict(TRUST_TEXT, **TRUST_FLAGS), "cuda",
        "trust_b_on", tds, t_out, agg_factory=factory))
    on = dict(fed=fed, launches=got, times=times, kept=kept, snaps=snaps)
    pass0 = expect_launches(4, steps0, steps0)
    passes = [on["snaps"]["rounds"][0]] + [
        {k: b[k] - a[k] for k in a}
        for a, b in zip(on["snaps"]["rounds"], on["snaps"]["rounds"][1:])]
    if not (on["launches"] == want and passes[0] == pass0
            and not any(on["snaps"]["hooks"].values())):
        fail(f"(b) K1-K3 launches: the defended run {on['launches']} "
             f"(expected {want}), its round-0 silo passes {passes[0]} "
             f"(expected {pass0}), inside the trust hooks "
             f"{on['snaps']['hooks']}")
    params = on["fed"]["params"]
    ev = on["fed"]["server"].aggregator.last_eval
    if not all(math.isfinite(float(v.abs().max())) for v in
               params.values()) or not math.isfinite(ev["loss"]):
        fail(f"(b) non-finite params or eval loss {ev}")
    if len(on["kept"]) != rounds or any(0 in k for k, _ in on["kept"]):
        fail(f"(b) krum kept the attacked silo: {on['kept']}")
    nbytes = xs_message_bytes(params)
    trust_s = [a + b for a, b in zip(on["times"][0::2], on["times"][1::2])]
    # a round as a silo sees it: its local pass, then upload to next sync
    round_s = [r["local_pass_s"] + r["upload_to_sync_s"]
               for r in xs_split(on["fed"])]
    for r, ((k, sc), ts, rs) in enumerate(zip(on["kept"], trust_s,
                                              round_s)):
        say("trust", f"(b) round {r}: krum keeps silo {k} (scores "
                     f"{', '.join(f'{x:.4e}' for x in sc)}; the attacked silo "
                     f"is 0); defense + DP {ts:.4f} s of the round's "
                     f"{rs:.3f} s (a silo's local pass + upload to sync)")
    say("trust", f"(b) text at full width, {n_silo} silos × {rounds} rounds, "
                 f"attack + krum + global DP: eval loss {ev['loss']:.4f}, "
                 f"acc {ev['acc']:.4f}; model message {nbytes:,} bytes; "
                 f"K1-K3 launches {on['launches']} = expected (layers 4 × "
                 f"({steps} silo steps + {n_eval} eval batches × {evals})); "
                 f"the silo passes by round {passes}, round 0's = the "
                 f"formula's {pass0}; inside the trust hooks "
                 f"{on['snaps']['hooks']} [{smi}]")
    out["text"] = {"launches": on["launches"], "passes": passes,
                   "hooks": on["snaps"]["hooks"],
                   "seconds": on["fed"]["seconds"],
        "trust_seconds": trust_s, "round_seconds": round_s,
        "kept": on["kept"], "message_bytes": nbytes, "eval": ev}
    seconds["b"] = time.time() - t0

    # the CPU process: (b-small)'s CPU run and (c)'s CPU defenses
    t0 = time.time()
    done = cpu_process_join(child)
    seconds["cpu_wait"] = time.time() - t0
    out["cpu_process"] = done

    # (b-small) card vs CPU, the CPU's draws carried
    t0 = time.time()
    small = torch.load(os.path.join(child["work"], "small.pt"))
    draws = dict(small["draws"], _init=small["init"])
    card = trust_small_run(torch, fedml_tpu_torch, "cuda", draws)
    left = {k: len(v) for k, v in draws.items() if v}
    if left:
        fail(f"(b-small) the card drew fewer noise draws than the CPU: {left}")
    errs = [max(max_err(a[k], b[k]) for k in b)
            for a, b in zip(card["history"], small["history"])]
    if len(errs) != TRUST_SMALL["comm_round"] or card["kept"] != \
            small["kept"] or max(errs) > TEXT_CARD_CPU_TOL:
        fail(f"(b-small) card vs CPU: rounds {errs}, kept {card['kept']} vs "
             f"{small['kept']}")
    say("trust", f"(b-small) narrow text, 4 silos × 2 rounds, attack + krum "
                 f"+ global DP, the CPU's draws carried: card vs CPU params "
                 f"max abs diff by round {[f'{e:.2e}' for e in errs]} (tol "
                 f"{TEXT_CARD_CPU_TOL:g}); krum kept {card['kept']} on both")
    out["small"] = {"errs": errs, "kept": card["kept"]}
    seconds["b_small"] = time.time() - t0

    # (c) every defense on the card against the CPU process
    t0 = time.time()
    shapes = {n: tuple(v.shape) for n, v in params.items()}
    out["defenses"] = trust_defenses(
        torch, fedml_tpu_torch, smi, child["work"], shapes,
        on["fed"]["server"].aggregator.model)
    seconds["c"] = time.time() - t0
    import shutil
    shutil.rmtree(child["work"], ignore_errors=True)
    seconds["phase"] = time.time() - t_phase
    out["seconds"] = seconds
    return out


#: phase 23 (c): the text model at full width as 3 silos (the first 3 of
#: the 10 realtext clients, each its own silo) for 1 round through the
#: SecAgg and the LightSecAgg FSMs: a server and 3 clients on threads
TRUST2_SECURE = dict(TEXT_REALTEXT, client_id_list=[1, 2, 3], comm_round=1)
#: (b): the text model as 4 silos (4 of 10 realtext clients) for 1 round
#: through a FedAvg ServerAggregator with exact MR-Shapley (15 non-empty
#: coalitions), the first silo replaced by phase 22 (b)'s server-side
#: byzantine attack (random mode)
TRUST2_CONTRIB = dict(TEXT_REALTEXT, client_num_per_round=4,
                      client_id_list=[1, 2, 3, 4], comm_round=1)
TRUST2_FLAGS = dict(enable_contribution=True, contribution_alg="mr",
                    enable_attack=True, attack_type="byzantine",
                    attack_mode="random", byzantine_client_num=1)
#: (b-small): phase 8 (e)'s narrow text model as 4 silos, 1 round, the
#: same flags, card vs the CPU process
TRUST2_SMALL = dict(TEXT_SMALL, client_num_per_round=4,
                    client_id_list=[1, 2, 3, 4], comm_round=1,
                    random_seed=3)
#: (a): the seed of the FHE run (the codec's secret derives from it)
TRUST2_FHE_SEED = 23
#: (b): Shapley's efficiency under exact enumeration, Σφ = U(all)
TRUST2_EFFICIENCY_TOL = 1e-9


class ckks_draws:
    """Inside the block, every draw of the CKKS codec (``ckks.draw``) is
    recorded into ``log`` (CPU copies, in order), or, given ``replay``,
    taken from it in order (moved to the draw's device)."""

    def __init__(self, log=None, replay=None):
        self.log, self.replay = log, replay

    def __enter__(self):
        from fedml_tpu_torch.core.fhe import ckks
        self.ckks, real = ckks, ckks.draw

        def recorded(gen, shape, p=None):
            z = real(gen, shape, p)
            self.log.append(z.cpu())
            return z

        def replayed(gen, shape, p=None):
            z = self.replay.pop(0)
            if tuple(z.shape) != tuple(shape):
                fail(f"a CKKS draw of {tuple(shape)} has no recorded draw of "
                     "its shape")
            return z.to(gen.device)

        self.real = real
        ckks.draw = recorded if self.replay is None else replayed
        return self

    def __exit__(self, *exc):
        self.ckks.draw = self.real


def digest(t):
    """sha256 of a tensor's bytes on the host: bitwise equality across
    processes."""
    import hashlib
    return hashlib.sha256(t.detach().cpu().contiguous().numpy()
                          .tobytes()).hexdigest()


def ckks_encrypt_digests(torch, vec, draws, device):
    """Encrypt ``vec`` on ``device`` with the carried ``draws`` and decrypt
    it: the digests of c0, c1 and the decrypted vector, and the seconds."""
    from fedml_tpu_torch.core.fhe.ckks import CkksCodec
    codec = CkksCodec(TRUST2_FHE_SEED ^ 0xF4E)
    t0 = time.time()
    with ckks_draws(replay=list(draws)):
        ct = codec.encrypt(vec.to(device))
    dec = codec.decrypt(ct)
    return {"c0": digest(ct.c0), "c1": digest(ct.c1), "dec": digest(dec),
            "seconds": time.time() - t0}


def contrib_aggregator(rec, att=None):
    """A FedAvg ``ServerAggregator`` class whose ``assess_contribution``
    records each utility (in call order), φ, the assessment's seconds,
    the list it assessed and, with ``att``, K1–K3's launches inside it."""
    base = trust_fedavg([], [])

    class Assessed(base):
        def assess_contribution(self, client_idxs, model_list,
                                aggregated_model, val_fn):
            utils = rec.setdefault("utilities", [])

            def val(params):
                u = val_fn(params)
                utils.append(u)
                return u

            before = launch_counts(att) if att is not None else None
            t0 = time.perf_counter()
            super().assess_contribution(client_idxs, model_list,
                                        aggregated_model, val)
            rec["seconds"] = time.perf_counter() - t0
            if att is not None:
                rec["launches"] = {k: n - before[k] for k, n in
                                   launch_counts(att).items()}
            rec.update(phi=dict(self.final_contribution_assigned_by_group),
                       idxs=list(client_idxs), models=model_list,
                       aggregated=aggregated_model, val_fn=val_fn)

    return Assessed


def mr_coalitions(m):
    """The coalitions exact MR-Shapley evaluates, in the order it first
    evaluates them (its loops, its cache): the utilities' call order."""
    import itertools
    seen, order = {frozenset()}, []
    for k in range(m):
        others = [i for i in range(m) if i != k]
        for r in range(m):
            for S in itertools.combinations(others, r):
                for c in (frozenset(S) | {k}, frozenset(S)):
                    if c not in seen:
                        seen.add(c)
                        order.append(c)
    return order


def contrib_small_run(torch, fedml_tpu_torch, device, draws=None):
    """(b-small) on ``device``: the narrow text federation with
    ``TRUST2_FLAGS``, the attack's draws recorded (``draws`` None) or
    replayed from ``draws`` (with ``"_init"``, the params to start from):
    the init, the draws, each utility and φ."""
    from fedml_tpu_torch import data

    args = xs_args(fedml_tpu_torch, TRUST2_SMALL, 0, "trust2_small")
    ds, n_out = data.load(args)
    rec, log = {}, {}
    init = None
    if draws is not None:
        init = {k: v.to(device) for k, v in draws.pop("_init").items()}
    with trust_draws(log=log, replay=draws):
        fed = xs_federation(torch, fedml_tpu_torch, TRUST2_SMALL, device,
                            f"trust2_small_{'replay' if draws else 'record'}",
                            ds, n_out, init=init,
                            agg_factory=contrib_aggregator(rec),
                            **TRUST2_FLAGS)
    return {"init": {k: v.cpu() for k, v in fed["init"].items()},
            "draws": log, "utilities": rec["utilities"], "phi": rec["phi"],
            "n_test": len(ds.test_x)}


def trust2_cpu_reference(work):
    """The CPU process of phase 23: (b-small) on the CPU, then, once the
    card has written (a)'s input, one silo's encryption and decryption
    on the CPU with the card's draws; results under ``work``."""
    import torch

    import fedml_tpu_torch
    torch.set_num_threads(4)
    t0 = time.time()
    small = contrib_small_run(torch, fedml_tpu_torch, "cpu")
    torch.save(small, os.path.join(work, "small.pt"))
    small_s = time.time() - t0
    path = os.path.join(work, "ckks_in.pt")
    while not os.path.exists(path):
        if time.time() - t0 > TRUST_CPU_JOIN_S:
            raise SystemExit("phase 23 (a)'s input never came")
        time.sleep(0.2)
    a = torch.load(path)
    cpu = ckks_encrypt_digests(torch, a["vec"], a["draws"], "cpu")
    with open(os.path.join(work, "done.json"), "w") as f:
        json.dump({"small_s": small_s, "ckks": cpu}, f)


def secure_run(torch, fedml_tpu_torch, att, kind, ds, n_out):
    """(c): the SecAgg (``kind`` "sa") or LightSecAgg ("lsa") FSM, a
    server and 3 clients on threads over ``local``, each client the
    port's cross-silo text silo trainer on the card: the server's params,
    each silo's (samples, trained params on the host), the seconds and
    K1–K3's launches."""
    from fedml_tpu_torch import model
    from fedml_tpu_torch.core import rng as rng_util
    from fedml_tpu_torch.core.distributed.communication.local.\
        local_comm_manager import reset_run
    from fedml_tpu_torch.cross_silo.client import TrainerDistAdapter
    if kind == "sa":
        from fedml_tpu_torch.cross_silo.secagg import (SAClientManager as C,
                                                       SAServerManager as S)
    else:
        from fedml_tpu_torch.cross_silo.lightsecagg import (
            LSAClientManager as C, LSAServerManager as S)
    run_id = f"trust2_{kind}"
    reset_run(run_id)
    cfg = TRUST2_SECURE
    ranks = range(1, len(cfg["client_id_list"]) + 1)
    args = {r: xs_args(fedml_tpu_torch, cfg, r, run_id) for r in
            [0, *ranks]}
    silos, errors = {}, []

    class Silo:
        def __init__(self, rank):
            a = args[rank]
            self.rank = rank
            self.adapter = TrainerDistAdapter(a, model.create(a, n_out), ds,
                                              device="cuda")

        def train(self, global_params, round_idx):
            params, n = self.adapter.train(global_params, self.rank - 1,
                                           round_idx)
            silos[self.rank] = (n, params)
            return params, n

    m0 = model.create(args[0], n_out)
    init = m0.init(rng_util.purpose_key(rng_util.root_key(
        int(args[0].random_seed)), "init"))
    server = S(args[0], init, rank=0, size=len(ranks) + 1, device="cuda")
    clients = [C(args[r], Silo(r), rank=r, size=len(ranks) + 1)
               for r in ranks]
    # the server's unmasking: its host field work at the round's end
    finish, finish_s = server._finish_round, []

    def timed_finish():
        t0 = time.perf_counter()
        finish()
        finish_s.append(time.perf_counter() - t0)
    server._finish_round = timed_finish

    def guard(m):
        try:
            m.run()
        except BaseException as e:   # noqa: BLE001 — failed below
            errors.append(repr(e))

    def run():
        threads = [threading.Thread(target=guard, args=(m,), daemon=True)
                   for m in [server] + clients]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=XS_JOIN_S)
        if errors:
            fail(f"(c) {kind}: {errors[0]}")
        if any(t.is_alive() for t in threads) or server.round_idx != 1:
            fail(f"(c) {kind}: the federation stalled past {XS_JOIN_S} s "
                 "a join")

    t0 = time.time()
    _, got = counted(torch, att, run)
    return {"params": server.global_params, "silos": silos,
            "seconds": time.time() - t0, "launches": got,
            "unmask_s": finish_s[0]}


def secure_check(torch, fedml_tpu_torch, kind, run, smi):
    """(c)'s checks of one FSM against the host witness of its field
    arithmetic and the float64 plaintext weighted average."""
    import numpy as np

    from fedml_tpu_torch.core.mpc.secagg import P, dequantize, quantize
    from fedml_tpu_torch.cross_silo.secagg.sa_fedml_client_manager import \
        flatten_params
    silos = [run["silos"][r] for r in sorted(run["silos"])]
    ns = [float(n) for n, _ in silos]
    xs = [flatten_params(p).astype(np.float64) for _, p in silos]
    total_w = sum(ns)
    plain = sum(n * x for n, x in zip(ns, xs)) / total_w
    headroom = float(sum(n * np.abs(x) for n, x in zip(ns, xs)).max())
    limit = (P - 1) / 2 / (1 << 16)
    witness_sum = np.zeros(xs[0].size, dtype=np.int64)
    for n, x in zip(ns, xs):
        witness_sum = (witness_sum + quantize(x * n)) % P
    witness = dequantize(witness_sum) / max(total_w, 1e-12)
    got = flatten_params(run["params"])
    if not np.array_equal(got, np.asarray(witness, np.float32)):
        fail(f"(c) {kind}: the server's params are not the host witness of "
             "the same field arithmetic")
    wrapped = headroom > limit
    err = float(np.abs(got.astype(np.float64) - plain).max())
    bound = 3 * 2.0 ** -17 / total_w + 2.0 ** -23 * float(np.abs(plain).max())
    if not wrapped and err > bound:
        fail(f"(c) {kind}: {err:.3e} from the float64 plaintext average, "
             f"bound {bound:.3e}")
    say("trust2", f"(c) {kind}: 3 text silos at full width (samples "
                  f"{[int(n) for n in ns]}), field headroom max_e "
                  f"Σ_i n_i·|x_i,e| = {headroom:,.1f} beside {limit:,.1f} "
                  f"({'WRAPS: the params are bitwise the host witness, as '
                      'the JAX arithmetic gives' if wrapped else 'no wrap'}"
                  f"); params bitwise the host witness; {err:.3e} from the "
                  f"float64 plaintext average (bound {bound:.3e}"
                  f"{', not held: wrapped' if wrapped else ''}); "
                  f"{run['seconds']:.1f} s, the server's unmasking "
                  f"{run['unmask_s']:.2f} s; K1-K3 {run['launches']} [{smi}]")
    return {"samples": ns, "headroom": headroom, "limit": limit,
            "wrapped": wrapped, "err": err, "bound": bound,
            "seconds": run["seconds"], "unmask_s": run["unmask_s"],
            "launches": run["launches"]}


def fhe_phase(torch, fedml_tpu_torch, silos, model, work, smi):
    """(a): three silos' trained params through a port ``ClientTrainer``'s
    encrypt hook on the card, ``fhe_fedavg`` and a ``ServerAggregator``'s
    decrypt hook, against the float64 plaintext average and the CPU
    process (silo 0's ciphertext and its decryption, the card's draws
    carried)."""
    import math

    import numpy as np

    from fedml_tpu_torch.core.alg_frame.client_trainer import ClientTrainer
    from fedml_tpu_torch.core.alg_frame.server_aggregator import \
        ServerAggregator
    from fedml_tpu_torch.core.fhe import ckks
    from fedml_tpu_torch.core.fhe.fhe_agg import FedMLFHE
    from fedml_tpu_torch.core.security.defense.common import tree_flatten_1d
    dev = torch.device("cuda", 0)

    class Trainer(ClientTrainer):
        def get_model_params(self):
            return self.params

        def set_model_params(self, p):
            self.params = p

        def train(self, train_data, device, args):
            return None

    class Aggregator(ServerAggregator):
        def get_model_params(self):
            return None

        def set_model_params(self, p):
            pass

        def aggregate(self, raw):
            return FedMLFHE.get_instance().fhe_fedavg(raw)

        def test(self, test_data, device, args):
            return None

    args = trust_args(fedml_tpu_torch, enable_fhe=True,
                      random_seed=TRUST2_FHE_SEED)
    trainer, agg = Trainer(model, args), Aggregator(model, args)
    fhe = FedMLFHE.get_instance()
    if not isinstance(fhe.codec, ckks.CkksCodec):
        fail(f"(a) the FHE codec is {type(fhe.codec).__name__}, not CKKS")
    raw, flats, logs, enc_ms = [], [], [], []
    for n, p in silos:
        p = {k: torch.as_tensor(v, device=dev) for k, v in p.items()}
        flats.append(tree_flatten_1d(p).to(torch.float32))
        trainer.set_model_params(p)
        log = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ckks_draws(log=log):
            trainer.on_after_local_training(None, dev, args)
        torch.cuda.synchronize()
        enc_ms.append(1e3 * (time.perf_counter() - t0))
        raw.append((n, trainer.get_model_params()))
        logs.append(log)
    ct0 = raw[0][1]
    if ct0.c0.device != dev:
        fail(f"(a) the ciphertext lives on {ct0.c0.device}, not the card")
    # the CPU process re-encrypts silo 0's vector with the card's draws
    tmp = os.path.join(work, "ckks_in.tmp")
    torch.save({"vec": flats[0].cpu(), "draws": logs[0]}, tmp)
    os.replace(tmp, os.path.join(work, "ckks_in.pt"))
    card0 = {"c0": digest(ct0.c0), "c1": digest(ct0.c1),
             "dec": digest(fhe.codec.decrypt(ct0))}
    passed, _ = agg.on_before_aggregation(raw)
    if any(a is not b for (_, a), (_, b) in zip(passed, raw)):
        fail("(a) on_before_aggregation did not pass the ciphertexts through")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    merged_ct = agg.aggregate(passed)
    torch.cuda.synchronize()
    agg_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    out = agg.on_after_aggregation(merged_ct)
    torch.cuda.synchronize()
    dec_ms = 1e3 * (time.perf_counter() - t0)
    # the float64 plaintext weighted average, and the scheme's error: the
    # weights' quantization, the encoding, the RLWE error and the f32 cast
    ns = [float(n) for n, _ in silos]
    total = sum(ns)
    plain = sum(n / total * f.double() for n, f in zip(ns, flats))
    got = tree_flatten_1d(out).double()
    weights = sum(int(round(n / total * (1 << ckks.WEIGHT_BITS)))
                  for n in ns)
    e_max = max(float(torch.round(log[0]).abs().max()) for log in logs)
    bound = (2.0 ** -17 * sum(f.double().abs() for f in flats) + 2.0 ** -30
             + weights * e_max / 2.0 ** 46 + 2.0 ** -24 * got.abs())
    err = (got - plain).abs()
    over = int((err > bound).sum())
    # the weights' and the encoding's terms alone, without the RLWE error
    # and the cast: how many elements they miss
    two_terms = int((err > 2.0 ** -17 * sum(f.double().abs() for f in flats)
                     + 2.0 ** -30).sum())
    # two codecs of one seed draw different (a, e)
    a, b = ckks.CkksCodec(7), ckks.CkksCodec(7)
    reuse = torch.equal(a.encrypt(flats[0]).c1, b.encrypt(flats[0]).c1)
    d = flats[0].numel()
    nbytes, model_bytes = ct0.nbytes, 65536 * math.ceil(d / ckks.N)
    if over or reuse or nbytes != model_bytes or not all(
            torch.isfinite(v).all() for v in out.values()):
        fail(f"(a) CKKS FedAvg: {over} elements over the bound, randomness "
             f"reused {reuse}, ciphertext {nbytes} B vs {model_bytes} B")
    say("trust2", f"(a) CKKS FedAvg of {len(silos)} silos at D {d:,} on the "
                  f"card: max |err| {float(err.max()):.3e} from the float64 "
                  f"plaintext average, every element within 2^-17·Σ|x_i| + "
                  f"2^-30 + W·max|e|/2^46 + 2^-24·|avg| (W {weights}, max|e| "
                  f"{e_max:g}; worst element at {float((err / bound).max()):.3f}"
                  f" of its bound; {two_terms} elements over the first two "
                  f"terms alone); a ciphertext {nbytes:,} B = 65,536 · "
                  f"ceil(D / 2048); encrypt {', '.join(f'{m:.1f}' for m in enc_ms)}"
                  f" ms, aggregate {agg_ms:.1f} ms, decrypt {dec_ms:.1f} ms; "
                  f"two codecs of one seed draw different c1 [{smi}]")
    return {"d": d, "nbytes": nbytes, "err": float(err.max()),
            "worst_of_bound": float((err / bound).max()), "e_max": e_max,
            "over_two_terms": two_terms,
            "weights": weights, "encrypt_ms": enc_ms, "aggregate_ms": agg_ms,
            "decrypt_ms": dec_ms, "card0": card0}


def trust2_phase(torch, fedml_tpu_torch, att, smi, child):
    """Phase 23: (c) SecAgg and LightSecAgg, (a) CKKS FedAvg on (c)'s
    silos, (b) contribution at full width, (b-small) card vs CPU."""
    from fedml_tpu_torch import data
    from fedml_tpu_torch.core import rng as rng_util
    from fedml_tpu_torch.core.contribution.gtg_shapley import GTGShapleyValue
    from fedml_tpu_torch.core.contribution.loo import LeaveOneOut
    from fedml_tpu_torch.core.fhe.fhe_agg import FedMLFHE

    out, seconds = {}, {}
    t_phase = time.time()

    # (c) SecAgg and LightSecAgg, 3 text silos at full width
    t0 = time.time()
    sargs = xs_args(fedml_tpu_torch, TRUST2_SECURE, 0, "trust2_shapes")
    sds, s_out = data.load(sargs)
    seed, bs = int(sargs.random_seed), int(sargs.batch_size)
    steps = sum(sds.client_index_batches(c, bs, seed, 0).shape[0]
                for c in range(len(TRUST2_SECURE["client_id_list"])))
    want = expect_launches(4, steps, steps)
    runs = {}
    for kind in ("sa", "lsa"):
        run = secure_run(torch, fedml_tpu_torch, att, kind, sds, s_out)
        if run["launches"] != want:
            fail(f"(c) {kind}: K1-K3 launches {run['launches']}, expected "
                 f"{want} (layers 4 × {steps} silo steps)")
        out[kind] = secure_check(torch, fedml_tpu_torch, kind, run, smi)
        runs[kind] = run
    say("trust2", f"(c) K1-K3 launches each run {want} = layers 4 × {steps} "
                  "silo steps")
    seconds["c"] = time.time() - t0

    # (a) CKKS FedAvg of (c)'s SecAgg silos on the card
    t0 = time.time()
    from fedml_tpu_torch import model as model_mod
    m = model_mod.create(sargs, s_out)
    silos = [runs["sa"]["silos"][r] for r in sorted(runs["sa"]["silos"])]
    out["fhe"] = fhe_phase(torch, fedml_tpu_torch, silos, m, child["work"],
                           smi)
    FedMLFHE.get_instance().init(None)
    del runs
    torch.cuda.empty_cache()
    seconds["a"] = time.time() - t0

    # (b) contribution at full width: 4 silos, MR exact, one attacked
    t0 = time.time()
    bargs = xs_args(fedml_tpu_torch, TRUST2_CONTRIB, 0, "trust2_b")
    bds, b_out = data.load(bargs)
    n_silo = len(TRUST2_CONTRIB["client_id_list"])
    steps = sum(bds.client_index_batches(int(c), bs, seed, 0).shape[0]
                for c in rng_util.sample_clients(
                    seed, 0, TRUST2_CONTRIB["client_num_in_total"], n_silo))
    n_eval = len(bds.test_batches()[0])
    coalitions = mr_coalitions(n_silo)
    want = expect_launches(4, steps + n_eval * (len(coalitions) + 1), steps)
    rec = {}
    fed, got = counted(torch, att, lambda: xs_federation(
        torch, fedml_tpu_torch, TRUST2_CONTRIB, "cuda", "trust2_b", bds,
        b_out, agg_factory=contrib_aggregator(rec, att), **TRUST2_FLAGS))
    phi, utils = rec["phi"], rec["utilities"]
    in_assess = expect_launches(4, n_eval * len(coalitions), 0)
    if got != want or rec["launches"] != in_assess or \
            len(utils) != len(coalitions):
        fail(f"(b) K1-K3 launches {got} (expected {want}: layers 4 × "
             f"({steps} silo steps + {n_eval} eval batches × "
             f"({len(coalitions)} coalitions + the server's eval))), inside "
             f"the assessment {rec['launches']} (expected {in_assess}); "
             f"{len(utils)} utilities for {len(coalitions)} coalitions")
    u_all = utils[coalitions.index(frozenset(range(n_silo)))]
    low = min(phi, key=phi.get)
    if low != 0 or abs(sum(phi.values()) - u_all) > TRUST2_EFFICIENCY_TOL:
        fail(f"(b) φ {phi}: the lowest is silo {low}, not the attacked silo "
             f"0; Σφ {sum(phi.values())!r} vs U(all) {u_all!r}")
    others = {}
    for name, cls in (("gtg", GTGShapleyValue), ("loo", LeaveOneOut)):
        t1 = time.perf_counter()
        others[name] = cls(bargs).compute(rec["idxs"], rec["models"],
                                          rec["aggregated"], rec["val_fn"])
        others[name + "_s"] = time.perf_counter() - t1
    round_s = [r["local_pass_s"] + r["upload_to_sync_s"]
               for r in xs_split(fed)]
    say("trust2", f"(b) text at full width, {n_silo} silos × 1 round, silo 0 "
                  f"attacked (byzantine, random): MR φ "
                  f"{ {k: round(v, 6) for k, v in phi.items()} } (lowest: "
                  f"silo {low}); Σφ - U(all) = "
                  f"{sum(phi.values()) - u_all:.2e} (U(all) {u_all:.6f}); "
                  f"GTG {({k: round(v, 6) for k, v in others['gtg'].items()})}"
                  f" in {others['gtg_s']:.2f} s, LOO "
                  f"{({k: round(v, 6) for k, v in others['loo'].items()})} "
                  f"in {others['loo_s']:.2f} s; the assessment "
                  f"{rec['seconds']:.2f} s beside the round's "
                  f"{max(round_s):.2f} s (a silo's pass + upload to sync); "
                  f"K1-K3 {got} = layers 4 × ({steps} silo steps + {n_eval} "
                  f"eval batches × ({len(coalitions)} coalitions + the "
                  f"server's eval)) [{smi}]")
    out["contribution"] = {
        "phi": phi, "utilities": utils, "u_all": u_all,
        "gtg": others["gtg"], "loo": others["loo"],
        "gtg_s": others["gtg_s"], "loo_s": others["loo_s"],
        "assess_s": rec["seconds"], "round_s": round_s, "launches": got,
        "assess_launches": rec["launches"]}
    del fed, rec
    seconds["b"] = time.time() - t0

    # the CPU process: (b-small)'s CPU run and (a)'s CPU encryption
    t0 = time.time()
    done = cpu_process_join(child)
    seconds["cpu_wait"] = time.time() - t0
    cpu0, card0 = done["ckks"], out["fhe"].pop("card0")
    same = {k: cpu0[k] == card0[k] for k in card0}
    if not all(same.values()):
        fail(f"(a) silo 0's ciphertext and decryption card vs CPU: {same}")
    say("trust2", f"(a) silo 0's c0, c1 and decryption: bitwise the CPU "
                  f"process's with the card's draws carried (sha256 "
                  f"{card0['c0'][:12]}…, {card0['c1'][:12]}…, "
                  f"{card0['dec'][:12]}…; CPU encrypt + decrypt "
                  f"{cpu0['seconds']:.2f} s)")
    out["fhe"]["cpu_bitwise"] = same

    # (b-small) card vs CPU, the CPU's draws carried
    t0 = time.time()
    small = torch.load(os.path.join(child["work"], "small.pt"))
    draws = dict(small["draws"], _init=small["init"])
    card = contrib_small_run(torch, fedml_tpu_torch, "cuda", draws)
    left = {k: len(v) for k, v in draws.items() if v}
    if left or len(card["utilities"]) != len(small["utilities"]):
        fail(f"(b-small) draws left {left}; utilities "
             f"{len(card['utilities'])} vs {len(small['utilities'])}")
    n_test = small["n_test"]
    diffs = [abs(a - b) * n_test for a, b in zip(card["utilities"],
                                                   small["utilities"])]
    flips = [round(d) for d in diffs]
    if any(abs(d - f) > 1e-3 for d, f in zip(diffs, flips)):
        fail(f"(b-small) utilities differ by other than whole test examples: "
             f"{diffs}")
    if not any(flips) and card["phi"] != small["phi"]:
        fail(f"(b-small) equal utilities but φ {card['phi']} vs "
             f"{small['phi']}")
    say("trust2", f"(b-small) narrow text, 4 silos × 1 round, MR exact, the "
                  f"CPU's draws carried: {len(flips)} utilities, "
                  f"{sum(1 for f in flips if f)} differ, by {sum(flips)} "
                  f"test examples of {n_test} in all; φ "
                  f"{'equal' if card['phi'] == small['phi'] else 'apart'} "
                  f"(card {card['phi']}, CPU {small['phi']})")
    out["small"] = {"flips": flips, "n_test": n_test, "phi_card": card["phi"],
                    "phi_cpu": small["phi"]}
    seconds["b_small"] = time.time() - t0
    out["cpu_process"] = {"small_s": done["small_s"],
                          "ckks_s": cpu0["seconds"]}
    import shutil
    shutil.rmtree(child["work"], ignore_errors=True)
    seconds["phase"] = time.time() - t_phase
    out["seconds"] = seconds
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="transformer depth (widths are never cut)")
    opts = ap.parse_args()
    t_start = time.time()

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import fedml_tpu_torch
        from fedml_tpu_torch.llm.configurations import (
            build_fedllm, llama2_7b_round_arguments)
        from fedml_tpu_torch.llm.fedllm import FedLLMAPI
        from fedml_tpu_torch.ops import attention as att
        from fedml_tpu_torch.ops import cuda_build
    except ImportError as e:
        fail(f"the port is not beside this script: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # -- 1. device ------------------------------------------------------
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    say("device", f"nvidia-smi: {smi}")
    say("device", f"torch: {kind}, {torch.cuda.device_count()} visible, "
                  f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 2. build -------------------------------------------------------
    t0 = time.time()
    info = cuda_build.build()
    say("build", f"{len(info)} kernels in {time.time() - t0:.1f} s "
                 "(parallel nvcc, sm_90a)")
    for name, rec in info.items():
        smem = {t: cuda_build.smem_bytes(name, 128, t == "bf16")
                for t in ("bf16", "f32")}
        say("build", f"{name}: {'cached' if rec['cached'] else 'built'} in "
                     f"{rec['seconds']:.1f} s; dynamic shared memory/block "
                     f"at head_dim 128 {smem} bytes")
        report = cuda_build.ptxas_report(rec["ptxas"])
        # bf16 on wgmma, f32 on 3xTF32 mma.sync: each built per head dim
        builds = [f"{name}_{kind}_kernel<{d}>" for kind in ("bf16", "f32")
                  for d in BF16_HEAD_DIMS]
        missing = [kern for kern in builds if kern not in report]
        if missing:
            fail(f"{name}: no -Xptxas -v report of {missing}")
        for kern, r in report.items():
            say("build", f"  {kern}: {r['registers']} registers/thread, "
                         f"spill bytes {r['spill_stores']} stored / "
                         f"{r['spill_loads']} loaded, static shared memory "
                         f"{r['smem']} bytes")
            if kern in builds and r["spill_stores"] + r["spill_loads"]:
                fail(f"{kern} spills registers to local memory")

    # -- 3. kernels vs plain ----------------------------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows, fwd_bwd = {}, {}
    for tag, b, h, hkv, s, d, causal, dt in KERNEL_SHAPES:
        dtype = getattr(torch, dt)
        mk = lambda *shape: torch.randn(shape, generator=gen, device=dev,
                                        dtype=torch.float32).to(dtype)
        q, k, v, do = mk(b, h, s, d), mk(b, hkv, s, d), mk(b, hkv, s, d), \
            mk(b, h, s, d)
        o, lse = att.flash_attention_fwd(q, k, v, causal)
        po, plse = att.flash_attention_fwd_plain(q, k, v, causal)
        e_o, l_o = check_close(att, "K1 O", o, po)
        e_l, l_l = check_close(att, "K1 lse", lse, plse)
        # K2 and K3 each against its plain version on the same inputs: the
        # O and lse that K1 gave, and the Δ that K2 gave
        dq, delta = att.flash_attention_bwd_dq(q, k, v, o, lse, do, causal)
        pdq, pdelta = att.flash_attention_bwd_dq_plain(q, k, v, o, lse, do,
                                                       causal)
        dk, dv = att.flash_attention_bwd_dkv(q, k, v, lse, delta, do, causal)
        pdk, pdv = att.flash_attention_bwd_dkv_plain(q, k, v, lse, delta, do,
                                                     causal)
        e_dq, l_dq = check_close(att, "K2 dQ", dq, pdq)
        _, l_de = check_close(att, "K2 delta", delta, pdelta)
        e_dk, l_dk = check_close(att, "K3 dK", dk, pdk)
        e_dv, l_dv = check_close(att, "K3 dV", dv, pdv)
        # the autograd Function runs the same kernels: bitwise the same
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        out = att.flash_attention(*leaves, causal)
        grads = torch.autograd.grad(out, leaves, do)
        if not all(map(torch.equal, (out, *grads), (o, dq, dk, dv))):
            fail(f"{tag}: the autograd Function's O/dQ/dK/dV differ from "
                 "the kernels' own")
        say("kernels", f"{tag} B{b} H{h} Hkv{hkv} S{s} D{d} "
                       f"{'causal' if causal else 'full'} {dt}: ok, "
                       "autograd Function bitwise equal to the kernels")
        for line in (l_o, l_l, l_dq, l_de, l_dk, l_dv):
            say("kernels", f"  {line}")
        if tag not in TIMED_SHAPES:
            continue
        errs = {"flash_fwd": e_o, "flash_bwd_dq": e_dq,
                "flash_bwd_dkv": max(e_dk, e_dv)}
        inputs = (q, k, v, do, o, lse, delta)
        new_rows, fwd_bwd[tag] = time_kernels(
            torch, att, tag, inputs, (b, h, hkv, s, d, causal, dt), errs,
            smi)
        if tag == "text_bf16":
            bf16_at_text = new_rows     # measured only: no path runs it
        else:
            rows.update(new_rows)

    # -- 4. the slice: federated LoRA rounds at Llama-2-7B width ----------
    t0 = time.time()
    api = build_fedllm(llama2_7b_round_arguments(opts.layers), device="cuda")
    cfg = api.cfg
    if (cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.ffn_dim, cfg.lora_rank,
            cfg.dtype) != (4096, 32, 32, 11008, 8, torch.bfloat16):
        fail(f"not Llama-2-7B width: {cfg}")
    n_params = sum(p.numel() for p in api.model.parameters())
    say("slice", f"Llama-2-7B width, depth {cfg.n_layers} of 32 "
                 f"({n_params / 1e9:.2f} B base params, bf16), LoRA rank "
                 f"{cfg.lora_rank}, vocab {cfg.vocab_size}, seq 1024; built "
                 f"in {time.time() - t0:.1f} s")
    base = {n: p.detach().cpu() for n, p in api.model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    att.reset_launch_counts()
    api.train()
    nll = api.evaluate()
    torch.cuda.synchronize()
    launches = {f.__name__.replace("flash_attention", "flash"): f.launches
                for f in att.KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = sum(hr["steps"] for hr in api.history)
    n_eval = len(api.dataset.test_batches(api.batch_size)[0])
    layers = cfg.n_layers
    expect = {"flash_fwd": layers * (2 * steps + n_eval),   # fwd + remat
              "flash_bwd_dq": layers * steps,
              "flash_bwd_dkv": layers * steps}
    for hr in api.history:
        toks = hr["steps"] * api.batch_size * 1024
        say("slice", f"round {hr['round']}: loss {hr['train_loss']:.4f}, "
                     f"{hr['steps']} client steps, {hr['seconds']:.2f} s, "
                     f"{toks / hr['seconds']:.0f} train tokens/s [{smi}]")
    slice_rec = {"layers": layers, "peak_gib": peak, "eval_nll": nll,
                 "rounds": [{"loss": hr["train_loss"], "steps": hr["steps"],
                             "seconds": hr["seconds"]} for hr in api.history]}
    say("slice", f"eval NLL {nll:.4f} over {n_eval} batches; peak "
                 f"max_memory_allocated {peak:.2f} GiB [{smi}]")
    say("slice", f"launches {launches}, expected {expect} (remat=full "
                 f"runs K1 twice per layer per step)")
    losses = [hr["train_loss"] for hr in api.history] + [nll]
    if not all(map(lambda x: x == x and abs(x) < float("inf"), losses)):
        fail(f"non-finite loss: {losses}")
    if launches != expect:
        fail(f"launch counts {launches} != expected {expect}")
    for n, p in api.model.named_parameters():
        if not torch.equal(p.detach().cpu(), base[n]):
            fail(f"base weight {n} changed")
    del base
    moved = [k for k, t in api.global_lora.items()
             if k.endswith("/B") and t.abs().max().item() > 0]
    n_b = sum(k.endswith("/B") for k in api.global_lora)
    if len(moved) != n_b:
        fail(f"only {len(moved)} of {n_b} B adapters moved off zero")
    say("slice", f"base bitwise unchanged; {n_b}/{n_b} B adapters non-zero")
    for name, n in launches.items():
        rows[f"{name}@slice"]["launches"] = n
    # phase 17 (a) holds its tensor-parallel round to these adapters
    slice_lora = {k: t.detach().cpu() for k, t in api.global_lora.items()}
    del api
    torch.cuda.empty_cache()

    # small-input reference: one f32 round on the card vs the CPU
    targs = fedml_tpu_torch.load_arguments()
    targs.update(model="tiny_llama", dataset="shakespeare", seq_len=64,
                 client_num_in_total=4, client_num_per_round=2, comm_round=1,
                 batch_size=2, llm_max_local_steps=2, lora_rank=4,
                 learning_rate=1e-3, random_seed=1, partition_method="homo",
                 train_size=32, test_size=4)
    gpu_api = build_fedllm(targs, device="cuda")
    cpu_api = FedLLMAPI(targs, gpu_api.dataset, device="cpu")
    with torch.no_grad():
        for (_, pc), (_, pg) in zip(cpu_api.model.named_parameters(),
                                    gpu_api.model.named_parameters()):
            pc.copy_(pg.cpu())
    cpu_api.global_lora = {k: t.cpu() for k, t in gpu_api.global_lora.items()}
    lg = gpu_api.train_one_round(0)["train_loss"]
    lc = cpu_api.train_one_round(0)["train_loss"]
    err = max(max_err(gpu_api.global_lora[k].cpu(), cpu_api.global_lora[k])
              for k in cpu_api.global_lora)
    say("slice", f"small f32 reference: round loss card {lg:.6f} vs CPU "
                 f"{lc:.6f}; adapters max abs diff {err:.2e} (tol 1e-4)")
    if abs(lg - lc) > 1e-4 * max(1.0, abs(lc)) or err > 1e-4:
        fail("card and CPU disagree on the small f32 round")

    # -- 5. sp: the FedAvg simulation on lr and the CNNs -------------------
    att.reset_launch_counts()
    sp = sp_phase(torch, fedml_tpu_torch, smi)
    if any(f.launches for f in att.KERNELS):
        fail("the sp path launched a flash-attention kernel")

    # -- 6. zoo: the algorithm zoo and the sp engines ----------------------
    t0 = time.time()
    zoo = zoo_phase(torch, fedml_tpu_torch, smi)
    if any(f.launches for f in att.KERNELS):
        fail("the zoo launched a flash-attention kernel")
    say("zoo", f"phase 6 took {time.time() - t0:.1f} s; no flash-attention "
               "kernel launched")

    # -- 7. fusion: round blocks as CUDA graphs, bucketing, populations ----
    t0 = time.time()
    fusion = fusion_phase(torch, fedml_tpu_torch, smi)
    if any(f.launches for f in att.KERNELS):
        fail("phase 7 launched a flash-attention kernel")
    say("fusion", f"phase 7 took {time.time() - t0:.1f} s; no "
                  "flash-attention kernel launched")

    # -- 8. text: the FedNLP text transformer on the real text shard -------
    t0 = time.time()
    text = text_phase(torch, fedml_tpu_torch, att, smi)
    for name, n in text["launches"].items():
        rows[f"{name}@text"]["launches"] = n
    say("text", f"phase 8 took {time.time() - t0:.1f} s")

    # -- 9. resnet: resnet18_gn on the CIFAR-100 stand-in ------------------
    t0 = time.time()
    att.reset_launch_counts()
    resnet = resnet_phase(torch, fedml_tpu_torch, smi)
    if any(f.launches for f in att.KERNELS):
        fail("phase 9 launched a flash-attention kernel")
    say("resnet", f"phase 9 took {time.time() - t0:.1f} s; no "
                  "flash-attention kernel launched")

    # -- 10. models: the LSTMs, tag prediction, tabular, the vision zoo ----
    t0 = time.time()
    att.reset_launch_counts()
    models = models_phase(torch, fedml_tpu_torch, smi)
    if any(f.launches for f in att.KERNELS):
        fail("phase 10 launched a flash-attention kernel")
    say("models", f"phase 10 took {time.time() - t0:.1f} s; no "
                  "flash-attention kernel launched")

    # -- 11. engines: FedNAS, FedSeg, FedGKT, FedGAN, split, VFL, ... -----
    t0 = time.time()
    att.reset_launch_counts()
    engines = engines_phase(torch, fedml_tpu_torch, smi)
    if any(f.launches for f in att.KERNELS):
        fail("phase 11 launched a flash-attention kernel")
    say("engines", f"phase 11 took {time.time() - t0:.1f} s; no "
                   "flash-attention kernel launched")

    # -- 12. llm: the trainer, streaming xent, MoE, remat, the hub's LLMs --
    t0 = time.time()
    llm = llm_phase(torch, fedml_tpu_torch, att, smi)
    for path, r in (("trainer_lora", llm["trainer_lora"]),
                    ("trainer_dense", llm["trainer_dense"]),
                    ("streaming_round", llm["streaming_round"]["streaming"]),
                    ("moe_round", llm["moe"]),
                    ("remat_dots", llm["remat"]["dots"]),
                    ("hub_llama", llm["hub"]["llama"])):
        for name, n in r["launches"].items():
            rows[f"{name}@slice"].setdefault("launches_by_path", {})[
                path] = n
    for name, n in llm["hub"]["launches"].items():
        rows[f"{name}@text"].setdefault("launches_by_path", {})[
            "hub_tiny_llama"] = n
    say("llm", f"phase 12 took {time.time() - t0:.1f} s "
               f"({ {k: round(v, 1) for k, v in llm['seconds'].items()} })")

    # -- 13. mesh: the mesh engine as a world of 1 over NCCL -----------------
    t0 = time.time()
    mesh = mesh_phase(torch, fedml_tpu_torch, att, smi)
    for name, n in mesh["text"]["mesh"]["launches"].items():
        rows[f"{name}@text"].setdefault("launches_by_path", {})[
            "mesh_text"] = n
    for name, n in mesh["lora"]["mesh"]["launches"].items():
        rows[f"{name}@slice"].setdefault("launches_by_path", {})[
            "mesh_lora"] = n
    say("mesh", f"phase 13 took {time.time() - t0:.1f} s "
                f"({ {k: round(v, 1) for k, v in mesh['seconds'].items()} })")
    # the world of 1 phase 13 made, torn down as a user tears it down
    t0 = time.time()
    watchdog = threading.Timer(
        TEARDOWN_LIMIT, lambda: (print(
            "chip_smoke: FAILED: shutdown_world did not return within "
            f"{TEARDOWN_LIMIT} s", file=sys.stderr, flush=True),
            os._exit(1)))
    watchdog.daemon = True
    watchdog.start()
    from fedml_tpu_torch.core.mesh import shutdown_world
    shutdown_world()
    watchdog.cancel()
    mesh["seconds"]["teardown"] = time.time() - t0
    say("mesh", f"shutdown_world returned in "
                f"{mesh['seconds']['teardown']:.2f} s")

    # -- 14. serving: decode, the engines, the adapter bank, the server ----
    t0 = time.time()
    att.reset_launch_counts()
    serving = serving_phase(torch, fedml_tpu_torch, att, smi,
                            min(opts.layers, SERVE_LAYERS))
    torch.cuda.synchronize()
    serving["launches"] = launch_counts(att)
    for name, n in serving["launches"].items():
        for shape in ("slice", "text"):
            rows[f"{name}@{shape}"].setdefault("launches_by_path", {})[
                "serving"] = n
    if any(serving["launches"].values()):
        fail(f"serving launched a flash-attention kernel: "
             f"{serving['launches']}")
    say("serving", f"phase 14 took {time.time() - t0:.1f} s "
                   f"({ {k: round(v, 1) for k, v in serving['seconds'].items()} }"
                   f"); K1-K3 launches {serving['launches']}")
    carry = serving.pop("_carry")

    # -- 15. serving's remainder: int8 trees, speculative decode, the cache --
    t0 = time.time()
    att.reset_launch_counts()
    spec = serving_rest_phase(torch, fedml_tpu_torch, att, smi, carry)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    spec["launches"] = launch_counts(att)
    for name, n in spec["launches"].items():
        for shape in ("slice", "text"):
            rows[f"{name}@{shape}"].setdefault("launches_by_path", {})[
                "serving_spec"] = n
    if any(spec["launches"].values()):
        fail(f"phase 15 launched a flash-attention kernel: "
             f"{spec['launches']}")
    say("serving_spec", f"phase 15 took {time.time() - t0:.1f} s "
                        f"({ {k: round(v, 1) for k, v in spec['seconds'].items()} }"
                        f"); peak GiB by sub-phase "
                        f"{ {k: round(v, 2) for k, v in spec['peak_gib'].items()} }"
                        f"; K1-K3 launches {spec['launches']}")
    # phase 22 (a): serving's obs hooks on the same model, while it lives
    t0 = time.time()
    att.reset_launch_counts()
    serve_obs = serving_obs_phase(torch, fedml_tpu_torch, smi, carry)
    if any(launch_counts(att).values()):
        fail(f"phase 22 (a) launched a flash-attention kernel: "
             f"{launch_counts(att)}")
    say("trust", f"phase 22 (a) took {time.time() - t0:.1f} s")
    del carry
    torch.cuda.empty_cache()

    # -- 16. the sp planes: FedBuff, the client store, checkpoints ----------
    t0 = time.time()
    att.reset_launch_counts()
    planes = planes_phase(torch, fedml_tpu_torch, smi)
    planes_carry = planes.pop("_carry")
    planes["launches"] = launch_counts(att)
    for name, n in planes["launches"].items():
        for shape in ("slice", "text"):
            rows[f"{name}@{shape}"].setdefault("launches_by_path", {})[
                "planes"] = n
    if any(planes["launches"].values()):
        fail(f"phase 16 launched a flash-attention kernel: "
             f"{planes['launches']}")
    say("planes", f"phase 16 took {time.time() - t0:.1f} s "
                  f"({ {k: round(v, 1) for k, v in planes['seconds'].items()} }"
                  f"); K1-K3 launches {planes['launches']}")

    # -- 17. tp: the client x model mesh, a model factor of 1 ---------------
    t0 = time.time()
    tp = tp_phase(torch, fedml_tpu_torch, att, smi, opts.layers, slice_lora)
    for name, n in tp["lora"]["launches"].items():
        rows[f"{name}@slice"].setdefault("launches_by_path", {})[
            "tp_lora"] = n
    t1 = time.time()
    watchdog = threading.Timer(
        TEARDOWN_LIMIT, lambda: (print(
            "chip_smoke: FAILED: shutdown_world did not return within "
            f"{TEARDOWN_LIMIT} s", file=sys.stderr, flush=True),
            os._exit(1)))
    watchdog.daemon = True
    watchdog.start()
    shutdown_world()
    watchdog.cancel()
    tp["seconds"]["teardown"] = time.time() - t1
    say("tp", f"phase 17 took {time.time() - t0:.1f} s "
              f"({ {k: round(v, 1) for k, v in tp['seconds'].items()} })")

    # -- 18. mesh3d: the pipeline, the mesh's state plane, the ring ---------
    t0 = time.time()
    mesh3d = mesh3d_phase(torch, fedml_tpu_torch, att, smi, planes_carry)
    del planes_carry
    for name in mesh3d["ring"]["launches"]:
        for shape in ("slice", "text"):
            by = rows[f"{name}@{shape}"].setdefault("launches_by_path", {})
            by["pipeline"] = mesh3d["pipeline"]["launches"][name]
            by["mesh_state"] = mesh3d["mesh_state"]["launches"][name]
            by["ring"] = mesh3d["ring"]["launches"][name] \
                if shape == "slice" else 0
    t1 = time.time()
    watchdog = threading.Timer(
        TEARDOWN_LIMIT, lambda: (print(
            "chip_smoke: FAILED: shutdown_world did not return within "
            f"{TEARDOWN_LIMIT} s", file=sys.stderr, flush=True),
            os._exit(1)))
    watchdog.daemon = True
    watchdog.start()
    shutdown_world()
    watchdog.cancel()
    mesh3d["seconds"]["teardown"] = time.time() - t1
    say("mesh3d", f"phase 18 took {time.time() - t0:.1f} s "
                  f"({ {k: round(v, 1) for k, v in mesh3d['seconds'].items()} })")

    # -- 19. cross-silo: server and silos over the message plane ----------
    t0 = time.time()
    cross_silo = cross_silo_phase(torch, fedml_tpu_torch, att, smi)
    for name, n in cross_silo["text_launches"].items():
        rows[f"{name}@text"].setdefault("launches_by_path", {})[
            "cross_silo_text"] = n
        rows[f"{name}@slice"].setdefault("launches_by_path", {})[
            "cross_silo_text"] = 0
    say("cross_silo", f"phase 19 took {time.time() - t0:.1f} s "
                      f"({ {k: round(v, 1) for k, v in cross_silo['seconds'].items()} })")

    # phase 22's CPU process (its CPU references) runs beside phases 20-21
    trust_child = cpu_process_start(22, "trust_cpu_reference")

    # -- 20. wire: the codec, the two-tier and buffered-async drivers -----
    t0 = time.time()
    wire_rec = wire_phase(torch, fedml_tpu_torch, att, smi)
    for name, n in wire_rec["text_launches"].items():
        rows[f"{name}@text"].setdefault("launches_by_path", {})[
            "two_tier_text"] = n
        rows[f"{name}@slice"].setdefault("launches_by_path", {})[
            "two_tier_text"] = 0
    say("wire", f"phase 20 took {time.time() - t0:.1f} s "
                f"({ {k: round(v, 1) for k, v in wire_rec['seconds'].items()} })")

    # -- 21. obs: tracing, health, /metrics, the measured device phases ---
    t0 = time.time()
    obs_rec = obs_phase(torch, fedml_tpu_torch, att, smi)
    for name, n in obs_rec["probe_text"]["launches"].items():
        rows[f"{name}@text"].setdefault("launches_by_path", {})[
            "obs_probe_text"] = n
        rows[f"{name}@slice"].setdefault("launches_by_path", {})[
            "obs_probe_text"] = 0
    say("obs", f"phase 21 took {time.time() - t0:.1f} s "
               f"({ {k: round(v, 1) for k, v in obs_rec['seconds'].items()} })")

    # -- 22. trust: the defended DP text federation, every defense --------
    t0 = time.time()
    trust = trust_phase(torch, fedml_tpu_torch, att, smi, trust_child,
                        serve_obs)
    for name, n in trust["text"]["launches"].items():
        rows[f"{name}@text"].setdefault("launches_by_path", {})[
            "trust_text"] = n
        rows[f"{name}@slice"].setdefault("launches_by_path", {})[
            "trust_text"] = 0
    say("trust", f"phase 22 took {time.time() - t0:.1f} s "
                 f"({ {k: round(v, 1) for k, v in trust['seconds'].items()} }"
                 f"; (a) {serve_obs['seconds']:.1f} s at phase 15's end)")

    # -- 23. trust2: CKKS FedAvg, contribution, SecAgg and LightSecAgg ----
    t0 = time.time()
    trust2 = trust2_phase(torch, fedml_tpu_torch, att, smi,
                          cpu_process_start(23, "trust2_cpu_reference"))
    for path, n_by in (("trust2_secagg", trust2["sa"]["launches"]),
                       ("trust2_lightsecagg", trust2["lsa"]["launches"]),
                       ("trust2_contribution",
                        trust2["contribution"]["launches"])):
        for name, n in n_by.items():
            rows[f"{name}@text"].setdefault("launches_by_path", {})[
                path] = n
            rows[f"{name}@slice"].setdefault("launches_by_path", {})[
                path] = 0
    say("trust2", f"phase 23 took {time.time() - t0:.1f} s "
                  f"({ {k: round(v, 1) for k, v in trust2['seconds'].items()} })")
    say("done", f"all phases in {time.time() - t_start:.1f} s")

    print(json.dumps({"kernels": list(rows.values()), "fwd_bwd": fwd_bwd,
                      "bf16_at_text": list(bf16_at_text.values()),
                      "slice": slice_rec, "sp": sp, "zoo": zoo,
                      "fusion": fusion, "text": text, "resnet": resnet,
                      "models": models, "engines": engines, "llm": llm,
                      "mesh": mesh, "serving": serving,
                      "serving_spec": spec, "planes": planes,
                      "tp_shards": list(tp.pop("rows").values()),
                      "tp": tp,
                      "ring_blocks": list(mesh3d.pop("rows").values()),
                      "mesh3d": mesh3d, "cross_silo": cross_silo,
                      "wire": wire_rec, "obs": obs_rec, "trust": trust,
                      "trust2": trust2}, default=str))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
