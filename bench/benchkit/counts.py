"""Operations and bytes the algorithms need, from shapes alone.

Whatever kernel computes a call, its count is what the algorithm needs:
no padding, no chunk recomputes, no split products.  The peaks are the
datasheet rates of one NVIDIA H100 SXM (dense bf16 on the tensor cores,
HBM3 bandwidth), the numbers the program's ``gpu-h100`` seed states.
"""
from __future__ import annotations

from types import ModuleType
from typing import Optional

from benchkit.weights import ssm_sizes

PEAK_FLOPS = 989e12      # bf16 / fp16 dense, tensor cores
PEAK_BYTES_S = 3.35e12   # HBM3

BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def visible_pairs(Sq: int, Skv: int, causal: bool,
                  window: Optional[int]) -> int:
    """(q, k) pairs a causal (and windowed) attention sees, q at positions
    Skv - Sq .. Skv - 1 and k at 0 .. Skv - 1."""
    total = 0
    off = Skv - Sq
    for i in range(Sq):
        q = off + i
        hi = q + 1 if causal else Skv
        lo = max(0, q - window + 1) if window is not None else 0
        total += max(0, hi - lo)
    return total


def attention_ops(B: int, Hq: int, Sq: int, Skv: int, dh: int,
                  causal: bool = True, window: Optional[int] = None) -> int:
    """Q Kᵀ and P V: 2 · 2 · dh operations a visible pair and query head."""
    return 4 * B * Hq * visible_pairs(Sq, Skv, causal, window) * dh


def attention_bytes(B: int, Hq: int, Hkv: int, Sq: int, Skv: int, dh: int,
                    itemsize: int, lse: bool = False) -> int:
    """q, k, v read once, o written once (and the f32 row log-sum-exp)."""
    io = (B * Sq * Hq * dh * 2 + 2 * B * Skv * Hkv * dh) * itemsize
    return io + (B * Hq * Sq * 4 if lse else 0)


def ssd_ops(B: int, H: int, L: int, N: int, P: int) -> int:
    """The recurrent form: per step and head, h = a·h + x Bᵀ (2·N·P) and
    y = C h (2·N·P)."""
    return 4 * B * H * L * N * P


def ssd_bytes(B: int, H: int, L: int, P: int, G: int, N: int,
              x_size: int, dt_size: int, a_size: int, bc_size: int,
              y_size: int) -> int:
    """x, dt, A, B and C read once, y written once."""
    return (B * H * L * P * x_size + B * H * L * dt_size + H * a_size
            + 2 * B * G * L * N * bc_size + B * H * L * P * y_size)


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the chip could take: the slower of its compute and
    its memory bounds."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES_S)


def forward_flops(cfg: dict, B: int, S: int,
                  ref: Optional[ModuleType] = None) -> int:
    """Model FLOPs of one forward pass over B sequences of S tokens:
    ``ref``'s ``forward_flops(cfg, B, S)`` where the configuration's
    reference module defines one; else, for today's families, 2·m·n a
    token for every weight matrix the token passes through (the MoE's
    experts only for the top-k routed tokens, no capacity slack; not the
    embedding lookup), plus attention and the SSD as counted above."""
    if hasattr(ref, "forward_flops"):
        return ref.forward_flops(cfg, B, S)
    d, V = cfg["d_model"], cfg["vocab_size"]
    T = B * S
    flops = 2 * T * d * V  # LM head

    def attention_block() -> int:
        H, KVH, dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
        proj = 2 * T * d * (2 * H * dh + 2 * KVH * dh)  # q, k, v, o
        return proj + attention_ops(B, H, S, S, dh, True,
                                    cfg.get("sliding_window"))

    def mlp() -> int:
        moe = cfg.get("moe")
        ffn = 2 * T * 3 * d * cfg["d_ff"]
        if not moe:
            return ffn
        router = 2 * T * d * moe["n_experts"]
        return router + moe["top_k"] * ffn

    if cfg["family"] in ("ssm", "hybrid"):
        s, z = cfg["ssm"], ssm_sizes(cfg)
        ssm_layer = (2 * T * d * z["proj"] + 2 * T * z["d_inner"] * d
                     + ssd_ops(B, z["heads"], S, s["d_state"], s["head_dim"]))
        flops += cfg["n_layers"] * ssm_layer
        if cfg["family"] == "hybrid":
            sites = cfg["n_layers"] // cfg["hybrid"]["attn_every"]
            flops += sites * (attention_block() + mlp())
    else:
        flops += cfg["n_layers"] * (attention_block() + mlp())
    return flops


def train_flops(cfg: dict, B: int, S: int,
                ref: Optional[ModuleType] = None) -> int:
    """Forward + backward, the backward counted as twice the forward;
    remat's recompute is not counted."""
    return 3 * forward_flops(cfg, B, S, ref)
