"""The port's centralized causal-LM trainer (``fedml_tpu_torch/llm/
trainer.py``) and step checkpointer (``core/checkpoint.py``) against the
JAX package's, on the CPU.

- ``make_lr_schedule`` against optax's ``join_schedules``/``linear_
  schedule``/``cosine_decay_schedule`` at every step (rtol 1e-6: both in
  f32, ``cos`` from different libraries);
- ``core/state.py::clip_by_global_norm`` (the trainer's clip, through
  ``ClientOptimizer``) against optax's below, at and above the bound;
- ``CausalLMTrainer`` LoRA-only and dense against the JAX trainer from the
  same weights (the JAX init carried across by ``llm/convert.py``) on the
  same data: gradient accumulation 2 over 3 micro-steps an epoch (a partial
  accumulation carries into the next epoch), clip, warmup + cosine, weight
  decay and a ``max_steps`` budget that ends the run inside an epoch.  Every
  micro-step's loss within 1e-5, the epoch history and the eval NLL within
  1e-5, the trained trees within 1e-4 (Adam's normalised step turns f32
  summation-order noise into differences proportional to lr 1e-3, as in
  ``tests/test_torch_fedllm.py``);
- checkpoint / resume as ``tests/test_llm.py::test_causal_lm_trainer_
  centralized`` checks it, and the checkpointer's own contract.
"""

import jax
import numpy as np
import optax
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu import data as j_data
from fedml_tpu.llm.trainer import CausalLMTrainer as JTrainer
from fedml_tpu.llm.trainer import make_lr_schedule as j_schedule
from fedml_tpu_torch import data as t_data
from fedml_tpu_torch.core.checkpoint import RoundCheckpointer
from fedml_tpu_torch.core.state import clip_by_global_norm
from fedml_tpu_torch.llm.convert import from_flax, to_flax
from fedml_tpu_torch.llm.trainer import CausalLMTrainer as TTrainer
from fedml_tpu_torch.llm.trainer import make_lr_schedule

TOL = 1e-4


@pytest.mark.parametrize("kind", ["constant", "linear", "cosine"])
@pytest.mark.parametrize("warmup", [0, 3])
def test_lr_schedule_matches_optax_at_every_step(kind, warmup):
    total = 11
    ref = j_schedule(3e-3, kind, warmup, total)
    got = make_lr_schedule(3e-3, kind, warmup, total)
    for step in range(total + 4):
        want = float(ref(np.int32(step)))
        assert got(step) == pytest.approx(want, rel=1e-6, abs=0), step
    if warmup:
        assert got(0) == 0.0            # the first update runs at lr 0


def test_unknown_schedule_raises_by_name():
    with pytest.raises(ValueError, match="warmup_cosine"):
        make_lr_schedule(1e-3, "warmup_cosine", 0, 10)


@pytest.mark.parametrize("max_norm", [10.0, 1.0, 0.1])
def test_clip_by_global_norm_matches_optax(max_norm):
    rng = np.random.default_rng(2)
    g = {"a": rng.standard_normal((3, 4)).astype(np.float32),
         "b": rng.standard_normal(5).astype(np.float32)}
    norm = np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                       for v in g.values()))
    assert (norm < max_norm) == (max_norm == 10.0)
    ref, _ = optax.clip_by_global_norm(max_norm).update(g, None)
    got = clip_by_global_norm({k: torch.tensor(v) for k, v in g.items()},
                              max_norm)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=0)


def _args(pkg, **over):
    args = pkg.load_arguments()
    args.update(model="tiny_llama", dataset="shakespeare", seq_len=16,
                batch_size=4, learning_rate=1e-3, random_seed=9,
                lora_rank=4, partition_method="homo", train_size=12,
                test_size=8, data_cache_dir="", client_num_in_total=2,
                client_num_per_round=2, epochs=3,
                gradient_accumulation_steps=2, max_grad_norm=0.5,
                warmup_steps=1, lr_scheduler_type="cosine", max_steps=3,
                weight_decay=0.01)
    args.update(**over)
    return pkg.init(args, should_init_logs=False)


def _pair(lora_rank, **over):
    ja = _args(fedml_tpu, lora_rank=lora_rank, **over)
    ta = _args(fedml_tpu_torch, lora_rank=lora_rank, **over)
    jd, _ = j_data.load(ja)
    td, _ = t_data.load(ta)
    jt, tt = JTrainer(ja, jd), TTrainer(ta, td, device="cpu")
    params = jax.tree_util.tree_map(np.asarray, jt.base_params)
    lora = (None if jt.lora is None
            else jax.tree_util.tree_map(np.asarray, jt.lora))
    _, tl = from_flax(params, lora, tt.cfg, device="cpu", model=tt.model)
    if tt.lora_only:
        tt.lora = tl
    return jt, tt


@pytest.mark.parametrize("mode", ["lora", "dense"])
def test_trainer_matches_jax(mode):
    jt, tt = _pair(4 if mode == "lora" else 0)
    assert tt.lora_only == (mode == "lora")
    if mode == "dense":
        assert all(p.dtype == torch.float32 and p.requires_grad
                   for p in tt.model.parameters())
    j_losses = []
    step = jt._step

    def recording_step(*a):
        out = step(*a)
        j_losses.append(float(out[2]))
        return out

    jt._step = recording_step
    j_hist, t_hist = jt.train()["history"], tt.train()["history"]
    # 3 micro-steps an epoch, 2 per update, 3 updates: epochs 0 and 1 run
    # (the second update spans them), the budget ends the run at epoch 2
    assert len(tt.step_losses) == len(j_losses) == 6
    assert tt.global_step == jt.global_step == 6
    np.testing.assert_allclose(tt.step_losses, j_losses, atol=1e-5, rtol=0)
    assert [h["epoch"] for h in t_hist] == [h["epoch"] for h in j_hist]
    np.testing.assert_allclose([h["loss"] for h in t_hist],
                               [h["loss"] for h in j_hist], atol=1e-5)
    assert tt.counts == {"updates": 3, "mini_step": 0}
    if mode == "lora":
        _, got = to_flax(None, tt.lora)
        ref = jt.lora
    else:
        got, _ = to_flax(tt.model, None)
        ref = jt.base_params
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(ref)[0],
                                 jax.tree_util.tree_flatten_with_path(got)[0]):
        np.testing.assert_allclose(b, np.asarray(a), atol=TOL, rtol=0,
                                   err_msg=str(path))
    assert abs(jt.evaluate() - tt.evaluate()) <= 1e-5


def test_checkpoint_resume_restores_state(tmp_path):
    """The JAX test's centralized path: eval NLL falls, the base stays
    bitwise unchanged under LoRA, and a new trainer resumed from the
    checkpoint has the step, the adapters, the optimizer state and the eval
    NLL of the one that wrote it."""
    args = _args(fedml_tpu_torch, epochs=2, max_steps=0,
                 gradient_accumulation_steps=1, learning_rate=3e-3,
                 output_dir=str(tmp_path / "out"))
    ds, _ = t_data.load(args)
    trainer = TTrainer(args, ds, device="cpu")
    base = {n: p.clone() for n, p in trainer.model.named_parameters()}
    nll0 = trainer.evaluate()
    out = trainer.train()
    nll1 = trainer.evaluate()
    assert nll1 < nll0 and len(out["history"]) == 2
    for n, p in trainer.model.named_parameters():
        assert torch.equal(p, base[n]), n
    trainer.close()

    again = TTrainer(args, ds, device="cpu")
    assert again.resume_from_checkpoint()
    assert again.global_step == trainer.global_step == 6
    assert again.counts == trainer.counts
    for k in trainer.lora:
        assert torch.equal(again.lora[k], trainer.lora[k]), k
    adam = trainer.opt["adam"]
    assert set(again.opt["adam"]) == set(adam) and int(adam["count"]) == 6
    for k, v in adam.items():
        assert torch.equal(again.opt["adam"][k], v), k
    assert again.evaluate() == nll1
    again.close()


def test_dense_resume_loads_the_module_weights(tmp_path):
    args = _args(fedml_tpu_torch, lora_rank=0, epochs=1, max_steps=1,
                 gradient_accumulation_steps=1, checkpoint_dir=str(tmp_path))
    ds, _ = t_data.load(args)
    trainer = TTrainer(args, ds, device="cpu")
    trainer.train()
    again = TTrainer(args, ds, device="cpu")
    assert again.resume_from_checkpoint() and again.global_step == 1
    for (n, p), (_, q) in zip(trainer.model.named_parameters(),
                              again.model.named_parameters()):
        assert torch.equal(p, q), n


def test_round_checkpointer_contract(tmp_path):
    ck = RoundCheckpointer(str(tmp_path), max_to_keep=2)
    assert ck.latest_round() is None and ck.restore() is None
    for step in (1, 5, 9):
        ck.save(step, {"w": torch.full((2, 3), float(step))},
                {"c": torch.arange(4) + step})
    assert ck.steps() == [5, 9] and ck.latest_round() == 9
    template = ({"w": torch.zeros(2, 3, dtype=torch.float64)}, {
        "c": torch.zeros(4, dtype=torch.int64)})
    state, client = ck.restore(5, template=template)
    assert state["w"].dtype == torch.float64 and float(state["w"][0, 0]) == 5
    assert torch.equal(client["c"], torch.arange(4) + 5)
    assert float(ck.restore_state()["w"][1, 2]) == 9
    with pytest.raises(ValueError, match="differ"):
        ck.restore(template=({"v": torch.zeros(2, 3)}, None))
    with pytest.raises(NotImplementedError, match="client store"):
        ck.save(10, {"w": torch.zeros(1)}, client_state=object())
    ck.close()


def test_mesh_regime_is_refused_by_name():
    """The mesh regime runs since the client x model slice: the trainer
    takes the mesh, as the JAX trainer does, and runs on its device (its
    history is pinned bitwise in ``tests/test_torch_tp.py``); a mesh
    without a device is refused."""
    from fedml_tpu_torch.core.mesh import Mesh
    args = _args(fedml_tpu_torch)
    ds, _ = t_data.load(args)
    tt = TTrainer(args, ds, device="cuda", mesh=Mesh(1, 0, "cpu"))
    assert tt.device == torch.device("cpu") and tt.mesh is not None
    with pytest.raises(AttributeError, match="device"):
        TTrainer(args, ds, device="cpu", mesh=object())
