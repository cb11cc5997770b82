"""Where the benchmark meets the program (``repro_torch``): the
configuration as the program's ``ArchConfig``, its model holding the
benchmark's weights, its prefill step and its trainer.  Nothing else of
the benchmark imports the program.
"""
from __future__ import annotations

import dataclasses
import typing
from typing import Dict

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.workload import WorkloadSpec
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import moe as _moe
from repro_torch.models import transformer
from repro_torch.runtime import steps
from repro_torch.runtime.trainer import Trainer, TrainerConfig

#: keys of a configuration file that document it and set nothing of the
#: program (``init_scale`` is the benchmark's, for its weights;
#: ``published`` holds the source's own values)
DOCUMENTARY = ("source", "deployment", "reduced", "published", "assumed",
               "departures", "init_scale")


def _dataclass_in(hint):
    """The dataclass a field's type names (``Optional[X]`` -> X), or
    None."""
    for t in (hint,) + typing.get_args(hint):
        if dataclasses.is_dataclass(t):
            return t
    return None


def _build(cls, values: dict, where: str):
    """``cls`` from ``values``, each key a field of ``cls`` (read with
    ``dataclasses.fields``); a dict for a field whose type is a dataclass
    is built into it the same way, a list becomes a tuple.  A key that
    names no field is refused, by its path in the file."""
    fields = {f.name for f in dataclasses.fields(cls)}
    hints = typing.get_type_hints(cls)
    kw = {}
    for k, v in values.items():
        if k not in fields:
            raise ValueError(f"the configuration's key {where + k!r} "
                             f"names no field of the program's "
                             f"{cls.__name__}")
        sub = _dataclass_in(hints[k])
        if sub is not None and isinstance(v, dict):
            v = _build(sub, v, f"{where}{k}.")
        elif isinstance(v, list):
            v = tuple(v)
        kw[k] = v
    return cls(**kw)


def arch_config(cfg: dict) -> ArchConfig:
    """The configuration file as the program's ``ArchConfig``: every key
    but the ``DOCUMENTARY`` ones is a field of it or of the dataclass of
    its group (``ssm``, ``hybrid``, ``moe``, ...), and passes through as
    it is.  ``published`` holds the source's values: a key it holds has
    that value or is one that ``reduced`` names, and a top-level key that
    names no field passes only as such a copy (a catalog model's file
    holds the catalog's config at the top level).  ``moe.group_tokens``,
    where the file gives it, is checked against the group the program
    routes in."""
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    published = cfg.get("published") or {}
    for k in published.keys() & cfg.keys():
        if cfg[k] != published[k] and k not in cfg.get("reduced", ()):
            raise ValueError(f"the configuration's key {k!r} is "
                             f"{cfg[k]!r}, its source's {published[k]!r}, "
                             f"and 'reduced' does not name it")
    kw = {k: v for k, v in cfg.items() if k not in DOCUMENTARY
          and (k in fields or k not in published)}
    moe = kw.get("moe")
    if moe and "group_tokens" in moe:
        if moe["group_tokens"] != _moe.GROUP_TOKENS:
            raise ValueError(f"the program routes in groups of "
                             f"{_moe.GROUP_TOKENS} tokens, the configuration "
                             f"states {moe['group_tokens']}")
        kw["moe"] = {k: v for k, v in moe.items() if k != "group_tokens"}
    return _build(ArchConfig, kw, "")


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
