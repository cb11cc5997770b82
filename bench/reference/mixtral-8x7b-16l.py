"""Plain reference of mixtral-8x7b at 16 layers as the benchmark runs it:
the token embedding, 16 pre-norm blocks of grouped-query attention (32
query heads, 8 KV heads of 128, RoPE theta 1e6, causal with the sliding
window) and a top-2 mixture of 8 SwiGLU experts (f32 router, GShard
capacity in groups, as the configuration states), each residual; the final
RMSNorm and the LM head.

``picks`` (one (G, t, K) tensor a layer) makes every layer route to the
given experts; ``record`` collects each layer's router probabilities and
picks (see ``plain.moe_layer``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from reference import plain


def _forward(w, cfg: dict, tokens: torch.Tensor, ops,
             picks: Optional[Sequence[torch.Tensor]],
             record: Optional[Dict[str, List]]) -> torch.Tensor:
    eps = cfg["norm_eps"]
    h = F.embedding(tokens.long(), w("embed.weight"))
    for i in range(cfg["n_layers"]):
        p = f"blocks.{i}"
        h = h + plain.attention_block(w, p, plain.rmsnorm(
            h, w(f"{p}.ln1.scale"), eps), cfg, ops)
        h = h + plain.moe_layer(
            w, p, plain.rmsnorm(h, w(f"{p}.ln2.scale"), eps), cfg["moe"],
            ops, None if picks is None else picks[i], record)
    return plain.head(w, h, cfg, ops)


@torch.no_grad()
def logits(weights: Dict[str, torch.Tensor], cfg: dict,
           tokens: torch.Tensor, precision: str = "f32",
           picks: Optional[Sequence[torch.Tensor]] = None,
           record: Optional[Dict[str, List]] = None) -> torch.Tensor:
    """tokens (B, S) -> f32 logits (B, S, V)."""
    with plain.exact_f32():
        return _forward(plain.getter(weights), cfg, tokens,
                        plain.Ops(precision), picks, record)


def loss(leaves: Dict[str, torch.Tensor], cfg: dict,
         batch: Dict[str, torch.Tensor], precision: str = "f32",
         ) -> torch.Tensor:
    """Cross-entropy plus ``aux_loss_weight`` × the summed load-balancing
    terms, differentiable in ``leaves`` (f32)."""
    record: Dict[str, List] = {}
    with plain.exact_f32():
        out = _forward(leaves.__getitem__, cfg, batch["tokens"],
                       plain.Ops(precision), None, record)
        ce = plain.xent(out, batch["labels"], batch.get("loss_mask"))
        return ce + cfg["moe"]["aux_loss_weight"] * sum(record["aux"])
