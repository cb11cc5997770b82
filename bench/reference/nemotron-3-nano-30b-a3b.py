"""Plain reference of NVIDIA-Nemotron-3-Nano-30B-A3B as the benchmark runs
it: the token embedding, then one pre-norm residual block a letter of
``block_pattern`` ("M" a Mamba2 mixer, "E" the mixture of experts, "*"
grouped-query attention with no positional encoding and no FFN after it),
the final RMSNorm and the untied LM head.  The departures from the
published model that the configuration file lists are the
configuration's, and this file follows them.

* Mamba2: in_proj to [z, xBC, dt], the causal conv with its bias and SiLU
  on xBC, dt = softplus(dt + dt_bias), A = -exp(A_log), the SSD scan with
  head h reading group h // (heads / n_groups), + D·x, then RMSNorm of
  y · silu(z) over each group of d_inner / n_groups channels
  (``group_norm``), out_proj.
* MoE: the router in f32, scores s = sigmoid(x W); the top-k of s + the
  correction bias are picked, weighted by their unbiased s, divided by
  the picks' sum and times ``routed_scale``; each picked expert computes
  down(relu(up x)²), one expert at a time (its weights alone upcast), the
  weighted outputs summed in f32; the shared expert, the same function
  at ``shared_ff``, added.  No token is dropped.

``picks`` (one (T, K) tensor an MoE block) makes every MoE block take the
given experts; ``record`` collects each MoE block's selection scores (s +
bias, (T, E), what the picks are the top-k of) and picks.  ``logits`` runs
without autograd, each weight turned to f32 as it is used.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from reference import plain

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Leaf(NamedTuple):
    """A weight as the benchmark draws it (``benchkit.weights.Leaf``)."""
    name: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    init: str   # normal | ones | zeros | a_log


def ssm_sizes(cfg: dict) -> Dict[str, int]:
    """d_inner from the SSD heads; the conv's channels (x, B, C) and
    in_proj's outputs (z, xBC, dt)."""
    s = cfg["ssm"]
    din = s["heads"] * s["head_dim"]
    conv = din + 2 * s["n_groups"] * s["d_state"]
    return {"d_inner": din, "heads": s["heads"], "conv_dim": conv,
            "proj": din + conv + s["heads"]}


def param_spec(cfg: dict) -> List[Leaf]:
    """Every weight by the program's name.  The router and its correction
    bias are f32 and drawn N(0, init_scale²), the bias so that it changes
    picks; A_log, D, dt_bias, the conv's bias and the norms as
    mamba2-370m's."""
    dt, f32 = DTYPES[cfg["param_dtype"]], torch.float32
    d, V = cfg["d_model"], cfg["vocab_size"]
    H, KVH, dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    moe, ff, z = cfg["moe"], cfg["d_ff"], ssm_sizes(cfg)
    E, sff = moe["n_experts"], moe["shared_ff"]
    spec = [Leaf("embed.weight", (V, d), dt, "normal")]
    for i, kind in enumerate(cfg["block_pattern"]):
        p = f"blocks.{i}"
        spec.append(Leaf(f"{p}.ln.scale", (d,), dt, "ones"))
        if kind == "M":
            m = f"{p}.mixer"
            spec += [
                Leaf(f"{m}.in_proj.weight", (z["proj"], d), dt, "normal"),
                Leaf(f"{m}.conv_w", (cfg["ssm"]["d_conv"], z["conv_dim"]),
                     dt, "normal"),
                Leaf(f"{m}.conv_b", (z["conv_dim"],), dt, "zeros"),
                Leaf(f"{m}.A_log", (z["heads"],), f32, "a_log"),
                Leaf(f"{m}.D", (z["heads"],), f32, "ones"),
                Leaf(f"{m}.dt_bias", (z["heads"],), f32, "zeros"),
                Leaf(f"{m}.norm", (z["d_inner"],), dt, "ones"),
                Leaf(f"{m}.out_proj.weight", (d, z["d_inner"]), dt,
                     "normal")]
        elif kind == "E":
            m = f"{p}.moe"
            spec += [Leaf(f"{m}.router", (d, E), f32, "normal"),
                     Leaf(f"{m}.router_bias", (E,), f32, "normal"),
                     Leaf(f"{m}.up", (E, d, ff), dt, "normal"),
                     Leaf(f"{m}.down", (E, ff, d), dt, "normal"),
                     Leaf(f"{m}.shared_up", (d, sff), dt, "normal"),
                     Leaf(f"{m}.shared_down", (sff, d), dt, "normal")]
        else:
            a = f"{p}.attn"
            spec += [Leaf(f"{a}.wq.weight", (H * dh, d), dt, "normal"),
                     Leaf(f"{a}.wk.weight", (KVH * dh, d), dt, "normal"),
                     Leaf(f"{a}.wv.weight", (KVH * dh, d), dt, "normal"),
                     Leaf(f"{a}.wo.weight", (d, H * dh), dt, "normal")]
    return spec + [Leaf("final_ln.scale", (d,), dt, "ones"),
                   Leaf("head.weight", (V, d), dt, "normal")]


def routed_layers(cfg: dict) -> int:
    """The MoE blocks, whose picks a prefill's check replays."""
    return cfg["block_pattern"].count("E")


def _causal_pairs(S: int, window: Optional[int]) -> int:
    """(q, k) pairs of one sequence of S a causal (windowed) attention
    sees."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def forward_flops(cfg: dict, B: int, S: int) -> int:
    """Model FLOPs of one forward pass over B × S tokens: 2·m·n a token for
    every weight matrix the token passes through (the router, its 6
    routed and the shared relu² experts; the Mamba2 projections; the
    attention projections; the head), the SSD's 4·H·N·P a token and
    layer, and attention's 4·dh a visible pair and query head."""
    d, V, T = cfg["d_model"], cfg["vocab_size"], B * S
    H, KVH, dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    s, moe, z = cfg["ssm"], cfg["moe"], ssm_sizes(cfg)
    mamba = 2 * T * d * z["proj"] + 2 * T * z["d_inner"] * d \
        + 4 * T * z["heads"] * s["d_state"] * s["head_dim"]
    experts = 2 * T * d * moe["n_experts"] \
        + 2 * 2 * T * d * (moe["top_k"] * cfg["d_ff"] + moe["shared_ff"])
    attention = 2 * T * d * (2 * H * dh + 2 * KVH * dh) \
        + 4 * B * H * dh * _causal_pairs(S, cfg.get("sliding_window"))
    pattern = cfg["block_pattern"]
    return 2 * T * d * V + pattern.count("M") * mamba \
        + pattern.count("E") * experts + pattern.count("*") * attention


# ---------------------------------------------------------------------------
# The blocks
# ---------------------------------------------------------------------------


def group_norm(x: torch.Tensor, scale: torch.Tensor, groups: int,
               eps: float) -> torch.Tensor:
    """RMSNorm over each of ``groups`` equal groups of the last dim."""
    g = x.reshape(*x.shape[:-1], groups, x.shape[-1] // groups)
    g = g * torch.rsqrt((g * g).mean(-1, keepdim=True) + eps)
    return g.reshape(x.shape) * scale


def mamba2(w: Callable[[str], torch.Tensor], p: str, x: torch.Tensor,
           cfg: dict, ops) -> torch.Tensor:
    """The Mamba2 mixer of block ``p`` on its normed input x (B, L, d)."""
    s, z = cfg["ssm"], ssm_sizes(cfg)
    B, L, _ = x.shape
    din, H, P = z["d_inner"], z["heads"], s["head_dim"]
    G, N = s["n_groups"], s["d_state"]
    proj = ops.linear(x, w(f"{p}.mixer.in_proj.weight"))
    gate, xbc, dt = proj.split([din, z["conv_dim"], H], dim=-1)
    dt = F.softplus(dt + w(f"{p}.mixer.dt_bias"))
    A = -torch.exp(w(f"{p}.mixer.A_log"))
    xbc = plain.causal_conv(xbc, w(f"{p}.mixer.conv_w"),
                            w(f"{p}.mixer.conv_b"))
    xs, Bm, Cm = xbc.split([din, G * N, G * N], dim=-1)
    xs = xs.reshape(B, L, H, P)
    y = plain.ssd(ops.act(xs), dt, A, ops.act(Bm).reshape(B, L, G, N),
                  ops.act(Cm).reshape(B, L, G, N), chunk=s["chunk"])
    y = y + xs * w(f"{p}.mixer.D")[:, None]
    y = group_norm(y.reshape(B, L, din) * F.silu(gate),
                   w(f"{p}.mixer.norm"), G, cfg["norm_eps"])
    return ops.linear(y, w(f"{p}.mixer.out_proj.weight"))


def attention(w: Callable[[str], torch.Tensor], p: str, x: torch.Tensor,
              cfg: dict, ops) -> torch.Tensor:
    """Grouped-query attention of block ``p`` on its normed input, q and k
    not turned by position (the Mamba2 blocks carry position)."""
    B, S, _ = x.shape
    H, KVH, dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = ops.linear(x, w(f"{p}.attn.wq.weight")).view(B, S, H, dh)
    k = ops.linear(x, w(f"{p}.attn.wk.weight")).view(B, S, KVH, dh)
    v = ops.linear(x, w(f"{p}.attn.wv.weight")).view(B, S, KVH, dh)
    o = plain.attention(q, k, v, cfg.get("sliding_window"), ops)
    return ops.linear(o.reshape(B, S, H * dh), w(f"{p}.attn.wo.weight"))


def relu2(x: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
          ops) -> torch.Tensor:
    """down(relu(up x)²), weights (in, out)."""
    return ops.matmul(torch.square(F.relu(ops.matmul(x, up))), down)


def moe(weights: Dict[str, torch.Tensor], p: str, x: torch.Tensor,
        cfg: dict, ops, picks: Optional[torch.Tensor] = None,
        record: Optional[Dict[str, List]] = None) -> torch.Tensor:
    """The sigmoid-routed, dropless mixture of block ``p`` on its normed
    input x (B, S, d), with its shared expert."""
    m = cfg["moe"]
    B, S, d = x.shape
    xt = x.reshape(B * S, d)

    def w(name):
        return weights[f"{p}.moe.{name}"].float()

    s = torch.sigmoid(xt @ w("router"))                        # f32 router
    chosen = s + w("router_bias")
    if picks is None:
        picks = torch.topk(chosen, m["top_k"], dim=-1).indices
    gates = torch.gather(s, -1, picks)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-20) * m["routed_scale"]
    if record is not None:
        record.setdefault("probs", []).append(chosen.detach())
        record.setdefault("picks", []).append(picks)
    out = torch.zeros_like(xt)
    up, down = weights[f"{p}.moe.up"], weights[f"{p}.moe.down"]
    for e in range(m["n_experts"]):
        tok, kk = torch.nonzero(picks == e, as_tuple=True)
        if tok.numel():
            ye = relu2(xt[tok], up[e].float(), down[e].float(), ops)
            out.index_add_(0, tok, ye * gates[tok, kk][:, None])
    out = out + relu2(xt, w("shared_up"), w("shared_down"), ops)
    return out.reshape(B, S, d)


def _forward(weights: Dict[str, torch.Tensor], cfg: dict,
             tokens: torch.Tensor, ops,
             picks: Optional[Sequence[torch.Tensor]],
             record: Optional[Dict[str, List]]) -> torch.Tensor:
    w = plain.getter(weights)
    eps = cfg["norm_eps"]
    h = F.embedding(tokens.long(), weights["embed.weight"]).float()
    routed = 0
    for i, kind in enumerate(cfg["block_pattern"]):
        p = f"blocks.{i}"
        x = plain.rmsnorm(h, w(f"{p}.ln.scale"), eps)
        if kind == "M":
            h = h + mamba2(w, p, x, cfg, ops)
        elif kind == "E":
            h = h + moe(weights, p, x, cfg, ops,
                        None if picks is None else picks[routed], record)
            routed += 1
        else:
            h = h + attention(w, p, x, cfg, ops)
    return plain.head(w, h, cfg, ops)


@torch.no_grad()
def logits(weights: Dict[str, torch.Tensor], cfg: dict,
           tokens: torch.Tensor, precision: str = "f32",
           picks: Optional[Sequence[torch.Tensor]] = None,
           record: Optional[Dict[str, List]] = None) -> torch.Tensor:
    """tokens (B, S) -> f32 logits (B, S, V)."""
    with plain.exact_f32():
        return _forward(weights, cfg, tokens, plain.Ops(precision), picks,
                        record)


def loss(leaves: Dict[str, torch.Tensor], cfg: dict,
         batch: Dict[str, torch.Tensor], precision: str = "f32"
         ) -> torch.Tensor:
    """The mean next-token cross-entropy over ``batch`` (tokens, labels,
    loss_mask), differentiable in ``leaves`` (f32); the router's bias
    balances the load, so there is no auxiliary loss."""
    with plain.exact_f32():
        out = _forward(leaves, cfg, batch["tokens"], plain.Ops(precision),
                       None, None)
        return plain.xent(out, batch["labels"], batch.get("loss_mask"))
