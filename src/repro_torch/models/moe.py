"""Mixture-of-experts layer: top-k token-choice routing with GShard-style
dense dispatch (capacity-bounded, einsum dispatch / combine tensors).

Tokens are routed in groups of up to ``GROUP_TOKENS``; each expert takes at
most ``C`` tokens of a group (``_capacity``), in token order, and the
assignments beyond that are dropped.  Routing and the auxiliary
load-balancing loss are computed in f32; the combine weights are
renormalised over the K picks and cast to the activations' type before the
last product.  The dispatch, the expert products and the combine are
``torch.einsum`` contractions, as the reference's are XLA einsums: there is
no TPU kernel to port here.  ``moe_apply``'s four phases are the spans
``moe.route``, ``moe.dispatch``, ``moe.experts`` and ``moe.combine``
(``obs/trace``).

The parameters keep the reference's layout, so the contractions read the
same: ``router`` (d, E), ``gate`` and ``up`` (E, d, ff), ``down`` (E, ff,
d).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import logical
from repro_torch.models import layers
from repro_torch.obs import trace as _obs_trace

GROUP_TOKENS = 2048  # dispatch group size (tokens)


class MoE(nn.Module):
    """The router and the E experts' SwiGLU weights of one layer."""

    def __init__(self, cfg, dtype, device, generator: torch.Generator):
        super().__init__()
        d, ff, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
        self.router = nn.Parameter(
            layers.normal_((d, E), dtype, device, generator))
        self.gate = nn.Parameter(
            layers.normal_((E, d, ff), dtype, device, generator))
        self.up = nn.Parameter(
            layers.normal_((E, d, ff), dtype, device, generator))
        self.down = nn.Parameter(
            layers.normal_((E, ff, d), dtype, device, generator))


def _capacity(tokens_per_group: int, E: int, top_k: int,
              factor: float) -> int:
    c = int(math.ceil(top_k * tokens_per_group * factor / E))
    return max(c, 4)


class Routing(NamedTuple):
    """The routing of one layer's tokens, in groups: (G, t, ...)."""
    probs: torch.Tensor    # (G, t, E) f32, the router's softmax
    experts: torch.Tensor  # (G, t, K) int64, the k-th pick's expert
    gates: torch.Tensor    # (G, t, K) f32, its probability; 0 where dropped
    slots: torch.Tensor    # (G, t, K) f32, its position in the buffer
    keep: torch.Tensor     # (G, t, K) bool, slot < capacity


def _groups(T: int) -> Tuple[int, int]:
    """-> (G, tokens per group) for T tokens."""
    tg = min(GROUP_TOKENS, T)
    if T % tg:
        raise ValueError(f"{T} tokens do not split into groups of {tg}")
    return T // tg, tg


def route(router: torch.Tensor, xg: torch.Tensor, top_k: int,
          C: int) -> Routing:
    """Token-choice top-K with capacity ``C`` (GShard 'tokens choose'):
    xg (G, t, d) -> the routing, f32 math.  The k-th pick of every token is
    placed before any (k+1)-th pick; within a pick, in token order."""
    logits = xg.float() @ router.float()                      # (G, t, E)
    probs = torch.softmax(logits, dim=-1)
    E = probs.shape[-1]
    usage = probs.new_zeros((probs.shape[0], E))  # tokens already assigned
    remaining = probs
    experts, gates, slots, keeps = [], [], [], []
    for _ in range(top_k):
        idx = torch.argmax(remaining, dim=-1)                 # (G, t)
        mask = F.one_hot(idx, E).to(probs.dtype)              # (G, t, E)
        gate = torch.sum(probs * mask, dim=-1)
        # position within the expert's buffer (0-indexed)
        pos = torch.cumsum(mask, dim=1) - 1.0 + usage[:, None, :]
        pos = torch.sum(pos * mask, dim=-1)
        keep = pos < C
        gate = gate * keep
        usage = usage + torch.sum(mask * keep[..., None], dim=1)
        remaining = remaining * (1.0 - mask)  # exclude the chosen expert
        experts.append(idx)
        gates.append(gate)
        slots.append(pos)
        keeps.append(keep)
    return Routing(probs, torch.stack(experts, -1), torch.stack(gates, -1),
                   torch.stack(slots, -1), torch.stack(keeps, -1))


def routing(p: MoE, x: torch.Tensor, cfg) -> Routing:
    """The routing ``moe_apply(p, x, cfg)`` computes, on its own."""
    B, S, d = x.shape
    G, tg = _groups(B * S)
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    return route(p.router, x.reshape(G, tg, d), K,
                 _capacity(tg, E, K, cfg.moe.capacity_factor))


def moe_apply(p: MoE, x: torch.Tensor,
              cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux_loss f32 scalar)."""
    B, S, d = x.shape
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    x = layers.rows_whole(x)  # groups fold the batch and the sequence
    tracer = _obs_trace.get_tracer()
    with tracer.span("moe.route"):
        r = routing(p, x, cfg)
    with tracer.span("moe.dispatch"):
        G, tg = r.experts.shape[:2]
        C = _capacity(tg, E, K, cfg.moe.capacity_factor)
        xg = x.reshape(G, tg, d)

        combine = xg.new_zeros((G, tg, E, C), dtype=torch.float32)
        gates_sum = xg.new_zeros((G, tg), dtype=torch.float32)
        for k in range(K):
            mask = F.one_hot(r.experts[..., k], E).float()    # (G, t, E)
            # a dropped pick (slot >= C) has gate 0; its slot is clamped and
            # masked, where the reference's one_hot of an index >= C gives 0
            keep = r.keep[..., k]
            slot = F.one_hot(r.slots[..., k].long().clamp(max=C - 1), C) \
                .float() * keep[..., None]                    # (G, t, C)
            gate = r.gates[..., k]
            combine = combine + (gate[..., None] * mask)[..., None] \
                * slot[:, :, None, :]
            gates_sum = gates_sum + gate

        # normalise the combine weights over the K picks (Mixtral
        # renormalises its top-k)
        combine = combine / torch.clamp(gates_sum, min=1e-9)[..., None, None]
        dispatch = (combine > 0.0).to(x.dtype)

        # aux load-balancing loss (Switch / GShard style, over the first
        # choice)
        frac_tokens = torch.mean(F.one_hot(r.experts[..., 0], E).float(),
                                 dim=1)
        frac_probs = torch.mean(r.probs, dim=1)               # (G, E)
        aux = E * torch.mean(torch.sum(frac_tokens * frac_probs, dim=-1))

        # dispatch -> expert FFN -> combine
        xe = torch.einsum("gtec,gtd->egcd", dispatch, xg)     # (E, G, C, d)
        xe = logical(xe, ("act_expert", "act_batch", None, "act_embed"))
    with tracer.span("moe.experts"):
        h_g = torch.einsum("egcd,edf->egcf", xe, p.gate)
        h_u = torch.einsum("egcd,edf->egcf", xe, p.up)
        h = F.silu(h_g) * h_u
        h = logical(h, ("act_expert", "act_batch", None, "act_ff"))
        ye = torch.einsum("egcf,efd->egcd", h, p.down)        # (E, G, C, d)
    with tracer.span("moe.combine"):
        y = torch.einsum("egcd,gtec->gtd", ye, combine.to(x.dtype))
        if sharding.is_dtensor(y):
            # the groups laid out as the tokens they fold, so that they
            # unfold into (B, S) (DTensor may have split them over more
            # ranks than divide the batch)
            y = y.redistribute(xg.device_mesh, xg.placements)
    return sharding.grad_in_layout(y.reshape(B, S, d)), aux.float()
