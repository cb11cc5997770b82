"""Where the benchmark meets the program (``repro_torch``): the
configuration as the program's ``ArchConfig``, its model holding the
benchmark's weights, its prefill step and its trainer.  Nothing else of
the benchmark imports the program.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import (ArchConfig, HybridConfig, MoEConfig,
                                      SSMConfig)
from repro_torch.core.workload import WorkloadSpec
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import moe as _moe
from repro_torch.models import transformer
from repro_torch.runtime import steps
from repro_torch.runtime.trainer import Trainer, TrainerConfig

_FIELDS = ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
           "d_ff", "vocab_size", "head_dim", "rope_theta", "sliding_window",
           "norm_eps", "tie_embeddings", "param_dtype", "compute_dtype",
           "optimizer", "remat_policy")


def arch_config(cfg: dict) -> ArchConfig:
    """The configuration file as the program's ``ArchConfig``."""
    kw = {k: cfg[k] for k in _FIELDS}
    if cfg.get("ssm"):
        kw["ssm"] = SSMConfig(**cfg["ssm"])
    if cfg.get("hybrid"):
        kw["hybrid"] = HybridConfig(**cfg["hybrid"])
    moe = cfg.get("moe")
    if moe:
        if moe["group_tokens"] != _moe.GROUP_TOKENS:
            raise ValueError(f"the program routes in groups of "
                             f"{_moe.GROUP_TOKENS} tokens, the configuration "
                             f"states {moe['group_tokens']}")
        kw["moe"] = MoEConfig(n_experts=moe["n_experts"], top_k=moe["top_k"],
                              capacity_factor=moe["capacity_factor"],
                              aux_loss_weight=moe["aux_loss_weight"])
    return ArchConfig(**kw)


def _check_names(model: nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    have = {n: tuple(p.shape) for n, p in model.named_parameters()}
    want = {n: tuple(t.shape) for n, t in weights.items()}
    if have != want:
        diff = sorted(set(have.items()) ^ set(want.items()))[:6]
        raise ValueError(f"the program's parameters differ from the "
                         f"benchmark's: {diff}")


def model_with(arch: ArchConfig, weights: Dict[str, torch.Tensor]
               ) -> transformer.Transformer:
    """The program's model made on the meta device, each parameter then
    taken to be the benchmark's tensor of that name (no copy)."""
    model = transformer.Transformer(arch, torch.device("meta"), None)
    _check_names(model, weights)
    for name, t in weights.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        mod._parameters[leaf] = nn.Parameter(t, requires_grad=False)
    return model


def prefill_step(arch: ArchConfig, B: int, S: int):
    """``steps.make_step`` for a prefill of B × S tokens."""
    return steps.make_step(arch, WorkloadSpec(phase="prefill",
                                              global_batch=B, seq_len=S))


class Feed:
    """The trainer's loader, in the layout of ``PackedLoader.batch``:
    ``batch(step)`` holds tokens and labels (int32) and loss_mask (f32),
    made by ``make(step)``."""

    def __init__(self, make):
        self.make = make

    def batch(self, step: int, rank: int = 0, n_ranks: int = 1
              ) -> Dict[str, np.ndarray]:
        return self.make(step)


def trainer(arch: ArchConfig, traffic: dict, weights: Dict[str, torch.Tensor],
            feed: Feed, device) -> Trainer:
    """The program's ``Trainer`` (no checkpoint directory) with its
    learning-rate schedule from the traffic file, its weights overwritten
    in place by the benchmark's and its loader replaced by ``feed``."""
    lr = traffic["lr"]
    tc = TrainerConfig(ckpt_dir=None, lr=lr["peak"], warmup=lr["warmup"],
                       total_steps=lr["total"], log_every=1 << 30)
    data = DataConfig(vocab_size=arch.vocab_size, seq_len=traffic["seq_len"],
                      global_batch=traffic["batch"])
    tr = Trainer(arch, data, tc, device=device)
    _check_names(tr.state.params, weights)
    with torch.no_grad():
        for name, p in tr.state.params.named_parameters():
            p.copy_(weights[name])
    tr.loader = feed
    return tr
