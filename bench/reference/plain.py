"""Plain PyTorch building blocks of the references, f32 math.

Written from the published descriptions (RMSNorm, half-split RoPE,
causal / windowed softmax attention with grouped KV heads, SwiGLU, top-k
routing with GShard capacity, Mamba2's SSD recurrence in chunks, the
depthwise causal convolution), in the layouts the weights come in.  No
kernel, no cache, no batching beyond what the inputs hold.

``precision`` is ``"f32"`` (the reference) or ``"fp8"`` (the control):
under ``"fp8"`` every operand that the configuration holds in bf16 enters
its product rounded to float8 e4m3 (per-row scales for activations, one
scale a weight), the products still summed in f32.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """f32 products without TF32 (restored afterwards)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8(x: torch.Tensor, per_row: bool = True) -> torch.Tensor:
    """x rounded to float8 e4m3 and back to f32, with a scale per row (the
    last dim's rows) or one for the tensor, straight through for the
    gradient."""
    amax = (x.detach().abs().amax(-1, keepdim=True) if per_row
            else x.detach().abs().amax())
    scale = torch.clamp(amax, min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


class Ops:
    """The products of one precision."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.low = precision == "fp8"

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return fp8(x) if self.low else x

    def linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., in) · wᵀ, w (out, in)."""
        if self.low:
            return fp8(x) @ fp8(w, per_row=False).t()
        return x @ w.t()

    def matmul(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., in) · w, w (in, out)."""
        if self.low:
            return fp8(x) @ fp8(w, per_row=False)
        return x @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, dh) turned by position (0..S-1), half-split layout."""
    S, dh = x.shape[1], x.shape[-1]
    half = dh // 2
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float64),
                      -torch.arange(half, dtype=torch.float64) / half)
    ang = (torch.arange(S, dtype=torch.float64)[:, None] * freqs).float()
    ang = ang.to(x.device)[None, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: Optional[int], ops: Ops) -> torch.Tensor:
    """Causal softmax attention from position 0, one batch row at a time.
    q (B, S, H, dh), k / v (B, S, KVH, dh); query head h reads KV head
    h // (H / KVH)."""
    B, S, H, dh = q.shape
    G = H // k.shape[2]
    i = torch.arange(S, device=q.device)
    mask = i[:, None] >= i[None, :]
    if window is not None:
        mask &= (i[:, None] - i[None, :]) < window
    outs = []
    for b in range(B):
        qb = ops.act(q[b]).transpose(0, 1)                        # (H,S,dh)
        kb = ops.act(k[b]).transpose(0, 1).repeat_interleave(G, 0)
        vb = ops.act(v[b]).transpose(0, 1).repeat_interleave(G, 0)
        s = (qb @ kb.transpose(1, 2)) / math.sqrt(dh)
        s = s.masked_fill(~mask, float("-inf"))
        p = torch.softmax(s, dim=-1)
        outs.append((ops.act(p) @ vb).transpose(0, 1))           # (S,H,dh)
    return torch.stack(outs)


def attention_block(w: Callable[[str], torch.Tensor], p: str, x: torch.Tensor,
                    cfg: dict, ops: Ops) -> torch.Tensor:
    """The attention of block ``p`` on its normed input x (B, S, d)."""
    B, S, _ = x.shape
    H, KVH, dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = ops.linear(x, w(f"{p}.attn.wq.weight")).view(B, S, H, dh)
    k = ops.linear(x, w(f"{p}.attn.wk.weight")).view(B, S, KVH, dh)
    v = ops.linear(x, w(f"{p}.attn.wv.weight")).view(B, S, KVH, dh)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    o = attention(q, k, v, cfg.get("sliding_window"), ops)
    return ops.linear(o.reshape(B, S, H * dh), w(f"{p}.attn.wo.weight"))


def swiglu(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
           down: torch.Tensor, ops: Ops) -> torch.Tensor:
    """down(silu(gate x) ⊙ up x), weights (out, in)."""
    return ops.linear(F.silu(ops.linear(x, gate)) * ops.linear(x, up), down)


# ---------------------------------------------------------------------------
# Mixture of experts
# ---------------------------------------------------------------------------


def capacity(tokens: int, moe: dict) -> int:
    return max(int(math.ceil(moe["top_k"] * tokens * moe["capacity_factor"]
                             / moe["n_experts"])), 4)


def moe_layer(w: Callable[[str], torch.Tensor], p: str, x: torch.Tensor,
              moe: dict, ops: Ops, picks: Optional[torch.Tensor] = None,
              record: Optional[Dict[str, List]] = None) -> torch.Tensor:
    """Top-k token choice over groups of ``group_tokens`` tokens (in batch
    then position order), each expert taking at most ``capacity`` picks a
    group, the k-th picks of all tokens placed before any (k+1)-th, the
    kept gates renormalised over the token's picks.  The router runs in
    f32.  ``picks`` (G, t, K): take these experts instead of the top-k
    (the probabilities and all else are still this function's); ``record``
    collects the probabilities, the picks and the load-balancing term."""
    B, S, d = x.shape
    E, K = moe["n_experts"], moe["top_k"]
    T = B * S
    tg = min(moe["group_tokens"], T)
    G = T // tg
    C = capacity(tg, moe)
    xg = x.reshape(G, tg, d)
    probs = torch.softmax(xg @ w(f"{p}.moe.router"), dim=-1)    # f32 router
    if picks is None:
        picks = torch.topk(probs, K, dim=-1).indices
    onehot = F.one_hot(picks, E).to(probs.dtype)                # (G,t,K,E)
    # slot of each pick: its rank among the expert's picks of the group,
    # k-major
    order = onehot.transpose(1, 2).reshape(G, K * tg, E)
    slot = (torch.cumsum(order, dim=1) - 1.0).reshape(G, K, tg, E) \
        .transpose(1, 2)
    slot = (slot * onehot).sum(-1)                              # (G,t,K)
    keep = slot < C
    gates = torch.gather(probs, -1, picks) * keep
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    if record is not None:
        record.setdefault("probs", []).append(probs.detach())
        record.setdefault("picks", []).append(picks)
        first = F.one_hot(picks[..., 0], E).float().mean(1)
        record.setdefault("aux", []).append(
            E * (first * probs.mean(1)).sum(-1).mean())
    flat_x = xg.reshape(T, d)
    flat_picks, flat_gates = picks.reshape(T, K), gates.reshape(T, K)
    gate, up, down = (w(f"{p}.moe.{n}") for n in ("gate", "up", "down"))
    out = torch.zeros_like(flat_x)
    for e in range(E):
        tok, kk = torch.nonzero((flat_picks == e) & (flat_gates > 0),
                                as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = flat_x[tok]
        h = F.silu(ops.matmul(xe, gate[e])) * ops.matmul(xe, up[e])
        ye = ops.matmul(h, down[e])
        out = out.index_add(0, tok, ye * flat_gates[tok, kk][:, None])
    return out.reshape(B, S, d)


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------


def causal_conv(x: torch.Tensor, wt: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d and SiLU: x (B, L, C), wt (k, C):
    out[t] = silu(b + Σ_j wt[j] · x[t - k + 1 + j])."""
    k, L = wt.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = b + sum(pad[:, j:j + L] * wt[j] for j in range(k))
    return F.silu(out)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, chunk: int = 128) -> torch.Tensor:
    """Mamba2's scan h_t = exp(dt_t·A) h_{t-1} + dt_t x_t B_tᵀ,
    y_t = h_t C_t, from h = 0, computed chunk by chunk in f32.
    x (B, L, H, P), dt (B, L, H), A (H,), Bm / Cm (B, L, G, N) with head h
    in group h // (H / G)."""
    Bz, L, H, P = x.shape
    rep = H // Bm.shape[2]
    Bh = Bm.repeat_interleave(rep, dim=2)
    Ch = Cm.repeat_interleave(rep, dim=2)
    N = Bh.shape[-1]
    h = x.new_zeros((Bz, H, P, N))
    ys = []
    for c0 in range(0, L, chunk):
        sl = slice(c0, min(c0 + chunk, L))
        xq, dq, bq, cq = x[:, sl], dt[:, sl], Bh[:, sl], Ch[:, sl]
        Q = xq.shape[1]
        cum = torch.cumsum(dq * A, dim=1)                       # (B,Q,H)
        tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
        seg = cum[:, :, None] - cum[:, None, :]                 # (B,i,j,H)
        decay = torch.exp(torch.where(tri[None, :, :, None], seg,
                                      torch.full_like(seg, float("-inf"))))
        W = torch.einsum("bihn,bjhn->bijh", cq, bq) * decay * dq[:, None]
        y = torch.einsum("bijh,bjhp->bihp", W, xq) \
            + torch.einsum("bihn,bhpn->bihp", cq * torch.exp(cum)[..., None],
                           h)
        tail = torch.exp(cum[:, -1:] - cum) * dq                # (B,Q,H)
        h = h * torch.exp(cum[:, -1])[:, :, None, None] \
            + torch.einsum("bjhp,bjhn->bhpn", xq, bq * tail[..., None])
        ys.append(y)
    return torch.cat(ys, dim=1)


def mamba2_mixer(w: Callable[[str], torch.Tensor], p: str, x: torch.Tensor,
                 cfg: dict, ops: Ops) -> torch.Tensor:
    """Mamba2's mixer on its normed input x (B, L, d): in_proj to
    [z, xBC, dt], causal conv on xBC, the SSD scan, + D·x, gated RMSNorm
    with silu(z), out_proj."""
    s = cfg["ssm"]
    B, L, d = x.shape
    din = s["expand"] * d
    H, P = din // s["head_dim"], s["head_dim"]
    GN = s["n_groups"] * s["d_state"]
    proj = ops.linear(x, w(f"{p}.mixer.in_proj.weight"))
    z, xbc, dt = proj.split([din, din + 2 * GN, H], dim=-1)
    dt = F.softplus(dt + w(f"{p}.mixer.dt_bias"))
    A = -torch.exp(w(f"{p}.mixer.A_log"))
    xbc = causal_conv(xbc, w(f"{p}.mixer.conv_w"), w(f"{p}.mixer.conv_b"))
    xs, Bm, Cm = xbc.split([din, GN, GN], dim=-1)
    xs = xs.reshape(B, L, H, P)
    y = ssd(ops.act(xs), dt, A,
            ops.act(Bm).reshape(B, L, s["n_groups"], s["d_state"]),
            ops.act(Cm).reshape(B, L, s["n_groups"], s["d_state"]))
    y = y + xs * w(f"{p}.mixer.D")[:, None]
    y = rmsnorm(y.reshape(B, L, din) * F.silu(z), w(f"{p}.mixer.norm"),
                cfg["norm_eps"])
    return ops.linear(y, w(f"{p}.mixer.out_proj.weight"))


# ---------------------------------------------------------------------------
# Head and loss
# ---------------------------------------------------------------------------


def head(w: Callable[[str], torch.Tensor], h: torch.Tensor, cfg: dict,
         ops: Ops) -> torch.Tensor:
    h = rmsnorm(h, w("final_ln.scale"), cfg["norm_eps"])
    table = w("embed.weight") if cfg.get("tie_embeddings") \
        else w("head.weight")
    return ops.linear(h, table)


def xent(logits: torch.Tensor, labels: torch.Tensor,
         mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean next-token cross-entropy, mask-weighted where a mask is
    given."""
    nll = torch.logsumexp(logits, -1) \
        - torch.gather(logits, -1, labels[..., None].long())[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def getter(weights: Dict[str, torch.Tensor]) -> Callable[[str],
                                                         torch.Tensor]:
    """name -> the weight in f32 (a copy where it is held in another
    type)."""
    return lambda name: weights[name].float()
