"""Plain reference of mamba2-370m as the benchmark runs it: the token
embedding, 48 Mamba2 layers (pre-norm, residual; no attention), the final
RMSNorm and the LM head tied to the embedding.  The departures from the
published model that the configuration file lists are the
configuration's, and this file follows them.

``logits`` runs without autograd, each weight turned to f32 as it is used;
``loss`` takes f32 leaves and recomputes each layer in the backward.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference import plain


def _mamba2_layer(w: Callable[[str], torch.Tensor], cfg: dict, ops, i: int,
                  h: torch.Tensor) -> torch.Tensor:
    p = f"blocks.{i}"
    return h + plain.mamba2_mixer(w, p, plain.rmsnorm(
        h, w(f"{p}.ln.scale"), cfg["norm_eps"]), cfg, ops)


def _forward(w, cfg: dict, tokens: torch.Tensor, ops,
             recompute: bool) -> torch.Tensor:
    h = F.embedding(tokens.long(), w("embed.weight"))
    for i in range(cfg["n_layers"]):
        if recompute:
            h = checkpoint(_mamba2_layer, w, cfg, ops, i, h,
                           use_reentrant=False)
        else:
            h = _mamba2_layer(w, cfg, ops, i, h)
    return plain.head(w, h, cfg, ops)


@torch.no_grad()
def logits(weights: Dict[str, torch.Tensor], cfg: dict,
           tokens: torch.Tensor, precision: str = "f32",
           **_) -> torch.Tensor:
    """tokens (B, S) -> f32 logits (B, S, V)."""
    with plain.exact_f32():
        return _forward(plain.getter(weights), cfg, tokens,
                        plain.Ops(precision), recompute=False)


def loss(leaves: Dict[str, torch.Tensor], cfg: dict,
         batch: Dict[str, torch.Tensor], precision: str = "f32"
         ) -> torch.Tensor:
    """The mean next-token cross-entropy over ``batch`` (tokens, labels,
    loss_mask), differentiable in ``leaves`` (f32)."""
    with plain.exact_f32():
        out = _forward(leaves.__getitem__, cfg, batch["tokens"],
                       plain.Ops(precision), recompute=True)
        return plain.xent(out, batch["labels"], batch.get("loss_mask"))
