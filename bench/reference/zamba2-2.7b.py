"""Plain reference of zamba2-2.7b as the benchmark runs it: the token
embedding, 54 Mamba2 layers (pre-norm, residual), and after every 6th the
one shared block (pre-norm attention with RoPE, then pre-norm SwiGLU MLP,
each residual), the final RMSNorm and the LM head.  The departures from
the published model that the configuration file lists are the
configuration's, and this file follows them.

``logits`` runs without autograd, each weight turned to f32 as it is used;
``loss`` takes f32 leaves and recomputes each layer and each application
of the shared block in the backward, so that the whole model, its f32
gradients and AdamW's moments fit on one card at 2 × 4096 tokens.
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


def _shared_block(w: Callable[[str], torch.Tensor], cfg: dict, ops,
                  h: torch.Tensor) -> torch.Tensor:
    eps = cfg["norm_eps"]
    h = h + plain.attention_block(w, "shared", plain.rmsnorm(
        h, w("shared.ln1.scale"), eps), cfg, ops)
    return h + plain.swiglu(
        plain.rmsnorm(h, w("shared.ln2.scale"), eps),
        w("shared.ffn.gate.weight"), w("shared.ffn.up.weight"),
        w("shared.ffn.down.weight"), ops)


def _forward(w, cfg: dict, tokens: torch.Tensor, ops,
             recompute: bool) -> torch.Tensor:
    def run(fn, *args):
        if recompute:
            return checkpoint(fn, w, cfg, ops, *args, use_reentrant=False)
        return fn(w, cfg, ops, *args)

    h = F.embedding(tokens.long(), w("embed.weight"))
    for i in range(cfg["n_layers"]):
        h = run(_mamba2_layer, i, h)
        if (i + 1) % cfg["hybrid"]["attn_every"] == 0:
            h = run(_shared_block, h)
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
