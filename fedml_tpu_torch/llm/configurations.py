"""LLM training configuration dataclasses (port of
``fedml_tpu.llm.configurations``): typed views over the flat ``Arguments``
namespace — ``from_args`` pulls the fields they know, ``apply_to`` writes
them back — and :func:`build_fedllm`, the dataclass-first entry."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class ModelArguments:
    model_name_or_path: str = "tiny_llama"
    lora_rank: int = 8
    lora_alpha: float = 16.0
    lora_dropout: float = 0.0
    #: attention selection (auto | flash: the flash kernels; blockwise: the
    #: plain streaming softmax; ring: refused, not ported)
    attn_impl: str = "auto"
    dim: Optional[int] = None
    n_layers: Optional[int] = None
    n_heads: Optional[int] = None
    n_kv_heads: Optional[int] = None
    ffn_dim: Optional[int] = None

    @classmethod
    def from_args(cls, args) -> "ModelArguments":
        return cls(
            model_name_or_path=str(getattr(args, "model", "tiny_llama")),
            lora_rank=int(getattr(args, "lora_rank", 8)),
            lora_alpha=float(getattr(args, "lora_alpha", 16.0)),
            lora_dropout=float(getattr(args, "lora_dropout", 0.0)),
            attn_impl=str(getattr(args, "attn_impl", None) or "auto"),
            dim=getattr(args, "llm_dim", None),
            n_layers=getattr(args, "llm_n_layers", None),
            n_heads=getattr(args, "llm_n_heads", None),
            n_kv_heads=getattr(args, "llm_n_kv_heads", None),
            ffn_dim=getattr(args, "llm_ffn_dim", None),
        )

    def apply_to(self, args):
        args.update(model=self.model_name_or_path, lora_rank=self.lora_rank,
                    lora_alpha=self.lora_alpha, lora_dropout=self.lora_dropout,
                    attn_impl=self.attn_impl)
        for f in ("dim", "n_layers", "n_heads", "n_kv_heads", "ffn_dim"):
            v = getattr(self, f)
            if v is not None:
                args.update(**{f"llm_{f}": int(v)})
        return args


@dataclasses.dataclass
class DatasetArguments:
    dataset_name: str = "shakespeare"
    truncation_max_length: int = 512
    test_dataset_ratio: float = 0.1
    seed: int = 0

    @classmethod
    def from_args(cls, args) -> "DatasetArguments":
        return cls(
            dataset_name=str(getattr(args, "dataset", "shakespeare")),
            truncation_max_length=int(getattr(args, "seq_len", 512)),
            test_dataset_ratio=float(getattr(args, "test_dataset_ratio",
                                             0.1)),
            seed=int(getattr(args, "random_seed", 0)),
        )

    def apply_to(self, args):
        args.update(dataset=self.dataset_name,
                    seq_len=self.truncation_max_length,
                    test_dataset_ratio=self.test_dataset_ratio,
                    random_seed=self.seed)
        return args


@dataclasses.dataclass
class ExperimentArguments:
    output_dir: str = "./outputs"
    learning_rate: float = 1e-3
    per_device_train_batch_size: int = 4
    num_train_epochs: int = 1
    max_local_steps: int = 4
    comm_round: int = 10
    client_num_in_total: int = 16
    client_num_per_round: int = 4
    save_steps: int = 10
    resume_from_checkpoint: Optional[str] = None
    seed: int = 0

    @classmethod
    def from_args(cls, args) -> "ExperimentArguments":
        return cls(
            output_dir=str(getattr(args, "output_dir", "./outputs")),
            learning_rate=float(getattr(args, "learning_rate", 1e-3)),
            per_device_train_batch_size=int(getattr(args, "batch_size", 4)),
            num_train_epochs=int(getattr(args, "epochs", 1)),
            max_local_steps=int(getattr(args, "llm_max_local_steps", 4)),
            comm_round=int(getattr(args, "comm_round", 10)),
            client_num_in_total=int(getattr(args, "client_num_in_total", 16)),
            client_num_per_round=int(getattr(args, "client_num_per_round", 4)),
            save_steps=int(getattr(args, "checkpoint_freq", 10)),
            resume_from_checkpoint=getattr(args, "checkpoint_dir", None),
            seed=int(getattr(args, "random_seed", 0)),
        )

    def apply_to(self, args):
        args.update(
            output_dir=self.output_dir, learning_rate=self.learning_rate,
            batch_size=self.per_device_train_batch_size,
            epochs=self.num_train_epochs,
            llm_max_local_steps=self.max_local_steps,
            comm_round=self.comm_round,
            client_num_in_total=self.client_num_in_total,
            client_num_per_round=self.client_num_per_round,
            checkpoint_freq=self.save_steps, random_seed=self.seed)
        if self.resume_from_checkpoint:
            args.update(checkpoint_dir=self.resume_from_checkpoint)
        return args


def llama2_7b_round_arguments(n_layers: int = 32):
    """Arguments of a federated LoRA run at Llama-2-7B width, as
    ``chip_smoke.py`` and ``tools/torch_round_profile.py`` drive it: bf16,
    LoRA rank 8 on wq/wk/wv/wo, synthetic Shakespeare LM data at seq 1024,
    4 of 8 clients per round, batch 2, 2 local steps, 2 rounds, seed 0.
    ``n_layers`` cuts depth only."""
    import fedml_tpu_torch

    args = fedml_tpu_torch.load_arguments()
    args.update(model="llama", dataset="shakespeare", seq_len=1024,
                client_num_in_total=8, client_num_per_round=4, comm_round=2,
                batch_size=2, llm_max_local_steps=2, lora_rank=8,
                lora_alpha=16.0, learning_rate=1e-3, random_seed=0,
                partition_method="homo", train_size=64, test_size=4,
                llm_n_layers=n_layers)
    return args


def build_fedllm(args=None,
                 model_args: Optional[ModelArguments] = None,
                 dataset_args: Optional[DatasetArguments] = None,
                 experiment_args: Optional[ExperimentArguments] = None,
                 device="cuda", mesh=None):
    """Compose the three configs onto args and build a ready FedLLMAPI on
    ``device`` (on ``mesh``'s ranks when one is given)."""
    import fedml_tpu_torch
    from .. import data as data_mod
    from .fedllm import FedLLMAPI

    if args is None:
        args = fedml_tpu_torch.load_arguments()
    for cfg in (model_args, dataset_args, experiment_args):
        if cfg is not None:
            cfg.apply_to(args)
    args = fedml_tpu_torch.init(args, should_init_logs=False)
    dataset, _ = data_mod.load(args)
    return FedLLMAPI(args, dataset, device=device, mesh=mesh)
