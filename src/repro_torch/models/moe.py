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

A ``dropless`` MoE (``_dropless_apply``) drops no token and builds no
(G, t, E, C) tensor: the picks are sorted by expert on the device, the
rows gathered in that order (``dispatch``), every expert's relu² product
computed at once over its rows (``expert_products``: PyTorch's grouped
GEMM on the card), and the rows put back and summed with their weights
(``combine``), in f32 as the router runs; a shared expert every token
passes through is added (the span ``moe.shared``).  Its router is a
sigmoid of each logit, the picks the top-k of the scores plus a
correction bias, their weights the unbiased scores renormalised and
scaled by ``routed_scale`` (the router and its bias held in f32).  Nothing
is read back to the host.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch._subclasses.fake_tensor import is_fake

from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import logical
from repro_torch.models import layers
from repro_torch.obs import trace as _obs_trace
from repro_torch.runtime import flags

GROUP_TOKENS = 2048  # dispatch group size (tokens)
#: why a dropless layer runs on one card only
NO_SHARDED_DISPATCH = ("the dropless MoE has no sharded dispatch (no expert "
                       "or tensor parallelism): it runs on one card")


class MoE(nn.Module):
    """The router and the E experts' weights of one layer: SwiGLU (gate,
    up, down) routed by a softmax for the GShard dispatch; relu² (up,
    down) routed by a sigmoid for the dropless one, with the router in f32
    and its correction bias (``router_bias``, f32, zero at init), and the
    shared expert (``shared_up`` (d, shared_ff), ``shared_down``
    (shared_ff, d)) where the configuration has one.  The bias steers the
    picks only, so no gradient reaches it: it is not trained
    (``requires_grad`` False), as the release moves it by the experts'
    load and not by the loss."""

    def __init__(self, cfg, dtype, device, generator: torch.Generator):
        super().__init__()
        m = cfg.moe
        d, ff, E = cfg.d_model, cfg.d_ff, m.n_experts
        if not m.dropless and (m.shared_ff or m.routed_scale != 1.0):
            raise ValueError(f"{cfg.name}: the GShard dispatch has no shared "
                             f"expert and no routed scale")
        self.router = nn.Parameter(layers.normal_(
            (d, E), torch.float32 if m.dropless else dtype, device,
            generator))
        if m.dropless:
            self.router_bias = nn.Parameter(
                torch.zeros(E, dtype=torch.float32, device=device),
                requires_grad=False)
        else:
            self.gate = nn.Parameter(
                layers.normal_((E, d, ff), dtype, device, generator))
        self.up = nn.Parameter(
            layers.normal_((E, d, ff), dtype, device, generator))
        self.down = nn.Parameter(
            layers.normal_((E, ff, d), dtype, device, generator))
        if m.shared_ff:
            self.shared_up = nn.Parameter(layers.normal_(
                (d, m.shared_ff), dtype, device, generator))
            self.shared_down = nn.Parameter(layers.normal_(
                (m.shared_ff, d), dtype, device, generator))


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


class Picks(NamedTuple):
    """The routing of a dropless layer's T tokens."""
    experts: torch.Tensor  # (T, K) int64, the k-th pick's expert
    weights: torch.Tensor  # (T, K) f32, its weight in the combine


def route(router: torch.Tensor, xg: torch.Tensor, top_k: int,
          C: Optional[int], bias: Optional[torch.Tensor] = None,
          scale: float = 1.0):
    """Token-choice top-K with capacity ``C`` (GShard 'tokens choose'):
    xg (G, t, d) -> the routing, f32 math.  The k-th pick of every token is
    placed before any (k+1)-th pick; within a pick, in token order.

    ``C`` None: no capacity (``route_dropless``; xg (T, d), ``bias`` and
    ``scale`` its own)."""
    if C is None:
        return route_dropless(router, xg, top_k, bias, scale)
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


def route_dropless(router: torch.Tensor, x: torch.Tensor, top_k: int,
                   bias: torch.Tensor, scale: float) -> Picks:
    """x (T, d) -> the top-K of the scores s = sigmoid of the f32 logits,
    plus ``bias``, weighted by their unbiased s renormalised over the K
    picks and times ``scale``; f32 math."""
    s = torch.sigmoid(x.float() @ router.float())             # (T, E)
    experts = torch.topk(s + bias.float(), top_k, dim=-1).indices
    w = torch.gather(s, -1, experts)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * scale
    return Picks(experts, w)


def routing(p: MoE, x: torch.Tensor, cfg):
    """The routing ``moe_apply(p, x, cfg)`` computes, on its own."""
    B, S, d = x.shape
    m = cfg.moe
    if m.dropless:
        return route(p.router, x.reshape(B * S, d), m.top_k, None,
                     p.router_bias, m.routed_scale)
    G, tg = _groups(B * S)
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    return route(p.router, x.reshape(G, tg, d), K,
                 _capacity(tg, E, K, cfg.moe.capacity_factor))


def dispatch(x: torch.Tensor, experts: torch.Tensor, E: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (T, d), experts (T, K) -> (the picks' rows sorted by expert (T·K,
    d), ``order`` (T·K,): the flat (token, k) index of each sorted row,
    ``offsets`` (E,) int32: where each expert's rows end).  A stable sort
    on the device; nothing is read back."""
    flat = experts.reshape(-1)
    ids, order = torch.sort(flat, stable=True)
    offsets = torch.searchsorted(
        ids, torch.arange(E, device=ids.device, dtype=ids.dtype),
        right=True).to(torch.int32)
    return x.index_select(0, order // experts.shape[-1]), order, offsets


def expert_products(x: torch.Tensor, offsets: torch.Tensor,
                    up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """Every expert's down(relu(up x)²) over its rows: x (R, d) sorted by
    expert, rows ``offsets[e-1]:offsets[e]`` expert e's; up (E, d, ff),
    down (E, ff, d) -> (R, d) in x's type.  On the card, PyTorch's grouped
    GEMM (``torch._grouped_mm``) twice; the plain version, one product an
    expert, only for CPU tensors or under ``flags.use_kernels(False)``.
    Fake tensors (a traced step) hold no offsets to loop over: they take
    the grouped GEMMs, whose shapes do not depend on the offsets."""
    if not is_fake(x) and (x.device.type == "cpu"
                           or not flags.kernels_enabled()):
        return _expert_products_plain(x, offsets, up, down)
    h = torch._grouped_mm(x, up, offs=offsets)
    return torch._grouped_mm(torch.square(F.relu(h)), down, offs=offsets)


def _expert_products_plain(x, offsets, up, down) -> torch.Tensor:
    out = torch.zeros_like(x)
    start = 0
    for e, end in enumerate(offsets.tolist()):
        if end > start:
            h = torch.square(F.relu(x[start:end] @ up[e]))
            out[start:end] = h @ down[e]
        start = end
    return out


def combine(y: torch.Tensor, order: torch.Tensor,
            weights: torch.Tensor) -> torch.Tensor:
    """The sorted rows' outputs y (T·K, d) back in (token, k) order, each
    times its weight (T, K) and summed over k, in f32 -> (T, d) f32."""
    T, K = weights.shape
    back = torch.empty_like(y).index_copy_(0, order, y)
    return (back.view(T, K, -1).float() * weights[..., None]).sum(1)


def _dropless_apply(p: MoE, x: torch.Tensor,
                    cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    if sharding.is_dtensor(x):
        raise NotImplementedError(NO_SHARDED_DISPATCH)
    B, S, d = x.shape
    m = cfg.moe
    tracer = _obs_trace.get_tracer()
    with tracer.span("moe.route", E=m.n_experts, K=m.top_k, score="sigmoid",
                     dropless=True):
        r = routing(p, x, cfg)
    xt = x.reshape(B * S, d)
    with tracer.span("moe.dispatch"):
        rows, order, offsets = dispatch(xt, r.experts, m.n_experts)
    with tracer.span("moe.experts"):
        y = expert_products(rows, offsets, p.up, p.down)
    with tracer.span("moe.combine"):
        out = combine(y, order, r.weights).to(x.dtype)
    if m.shared_ff:
        with tracer.span("moe.shared"):
            out = out + torch.square(F.relu(xt @ p.shared_up)) \
                @ p.shared_down
    return out.reshape(B, S, d), x.new_zeros((), dtype=torch.float32)


def moe_apply(p: MoE, x: torch.Tensor,
              cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux_loss f32 scalar; 0 for a
    dropless layer, whose bias balances the load)."""
    if cfg.moe.dropless:
        return _dropless_apply(p, x, cfg)
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
