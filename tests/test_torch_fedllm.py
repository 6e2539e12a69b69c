"""Two federated LoRA rounds of the port's FedLLMAPI against the JAX
package's, on the CPU, from the same data and the same starting weights
(the JAX base params and global adapters carried across by
``llm/convert.py::from_flax``): round losses, merged adapters and the eval
NLL agree to 1e-4.  Both run f32 TINY Llama; they differ in summation
order and in the attention backward's formulation (flax autodiff of the
blockwise scan vs the port's explicit flash backward).  Adam's
normalised step turns that noise on near-zero gradient entries into
differences proportional to the learning rate, so the parity runs at
lr 1e-3 (the tests/test_llm.py args use 3e-3).

Cases: the homogeneous cohort of tests/test_llm.py::_llm_args,
heterogeneous LoRA ranks (rank components nobody holds keep their global
value), and a cohort whose clients take 1 to 4 steps (masked steps).
"""

import jax
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu import data as j_data
from fedml_tpu.llm.fedllm import FedLLMAPI as JFedLLM
from fedml_tpu_torch import data as t_data
from fedml_tpu_torch.llm.convert import from_flax, to_flax
from fedml_tpu_torch.llm.fedllm import FedLLMAPI as TFedLLM

TOL = 1e-4


def _args(pkg, **over):
    args = pkg.load_arguments()
    args.update(model="tiny_llama", dataset="shakespeare", seq_len=32,
                client_num_in_total=6, client_num_per_round=3, comm_round=2,
                batch_size=4, learning_rate=1e-3, random_seed=9,
                llm_max_local_steps=4, lora_rank=4, partition_method="homo",
                train_size=120, test_size=8, data_cache_dir="")
    args.update(**over)
    return pkg.init(args, should_init_logs=False)


CASES = {
    "homogeneous": ({}, None),
    "hetero_rank": ({"lora_rank_per_client": [2, 2, 2, 4, 4, 4]}, None),
    "masked_steps": ({}, [4, 8, 13, 16, 6, 30]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_two_rounds_match_jax(case):
    over, sizes = CASES[case]
    j_args, t_args = _args(fedml_tpu, **over), _args(fedml_tpu_torch, **over)
    jd, _ = j_data.load(j_args)
    td, _ = t_data.load(t_args)
    if sizes is not None:
        perm = np.random.default_rng(1).permutation(len(td.train_x))
        cuts = np.cumsum([0] + sizes)
        idxs = {c: np.sort(perm[cuts[c]:cuts[c + 1]])
                for c in range(len(sizes))}
        jd.client_idxs, td.client_idxs = idxs, dict(idxs)
    japi = JFedLLM(j_args, jd)
    tapi = TFedLLM(t_args, td, device="cpu")
    params = jax.tree_util.tree_map(np.asarray, japi.base_params)
    lora0 = jax.tree_util.tree_map(np.asarray, japi.global_lora)
    _, tapi.global_lora = from_flax(params, lora0, tapi.cfg, device="cpu",
                                    model=tapi.model)

    for r in range(2):
        jl = japi.train_one_round(r)["train_loss"]
        tl = tapi.train_one_round(r)["train_loss"]
        assert abs(jl - tl) <= TOL * max(1.0, abs(jl)), (r, jl, tl)
    _, got = to_flax(None, tapi.global_lora)
    ref = jax.tree_util.tree_map(np.asarray, japi.global_lora)
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(ref)[0],
                                 jax.tree_util.tree_flatten_with_path(got)[0]):
        np.testing.assert_allclose(b, a, atol=TOL, rtol=0, err_msg=str(path))
    assert abs(japi.evaluate() - tapi.evaluate()) <= TOL


def test_merge_keeps_components_nobody_holds():
    args = _args(fedml_tpu_torch, lora_rank_per_client=[2] * 6)
    ds, _ = t_data.load(args)
    api = TFedLLM(args, ds, device="cpu")
    init = {k: v.clone() for k, v in api.global_lora.items()}
    api.train_one_round(0)
    for k, v in api.global_lora.items():
        if k.endswith("/A"):
            torch.testing.assert_close(v[:, 2:], init[k][:, 2:], rtol=0,
                                       atol=0)
            assert not torch.equal(v[:, :2], init[k][:, :2])
        else:
            torch.testing.assert_close(v[2:], init[k][2:], rtol=0, atol=0)


def test_base_frozen_and_history_recorded():
    args = _args(fedml_tpu_torch, comm_round=2)
    ds, _ = t_data.load(args)
    api = TFedLLM(args, ds, device="cpu")
    before = {n: p.clone() for n, p in api.model.named_parameters()}
    api.train()
    assert [h["round"] for h in api.history] == [0, 1]
    assert all(np.isfinite(h["train_loss"]) for h in api.history)
    for n, p in api.model.named_parameters():
        assert torch.equal(p, before[n]), n
    assert any(v.abs().max() > 0 for k, v in api.global_lora.items()
               if k.endswith("/B"))
