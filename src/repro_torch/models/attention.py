"""Attention: GQA, RoPE, sliding window, and KV-cache decode.

Prefill goes through the hand-written flash-attention kernel
(``repro_torch.kernels.flash_attention``); ``_plain_attention`` is the
materialised-logits path of the same contraction, taken under
``flags.use_kernels(False)``.  Decode over the cache is plain tensor code, as
in the reference.

Not ported yet: ``apply_mrope`` (vision-language family), the
context-parallel branch (multi-device) and the chunked online-softmax path
with its custom backward (training).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.distributed.sharding import context_parallel_factor, logical
from repro_torch.kernels import ops as kops
from repro_torch.models import layers
from repro_torch.runtime import flags

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def _rope_angles(positions: torch.Tensor, half: int,
                 theta: float) -> torch.Tensor:
    """positions (..., S) -> angles (..., S, half)  [f32]."""
    exponent = -torch.arange(half, dtype=torch.float32,
                             device=positions.device) / half
    freqs = torch.pow(theta, exponent)  # scalar base: no host-to-device copy
    return positions.float()[..., None] * freqs


def _rope_cos_sin(positions: torch.Tensor, half: int, theta: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> cos, sin (B, S, 1, half) in f32; one pair serves q and k."""
    ang = _rope_angles(positions, half, theta)  # (B, S, half)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def _rotate(x: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (B, S, H, dh); positions (B, S) int.  Half-split layout, f32 math."""
    return _rotate(x, *_rope_cos_sin(positions, x.shape[-1] // 2, theta))


# ---------------------------------------------------------------------------
# Attention core
# ---------------------------------------------------------------------------


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    """q_pos (Sq,), k_pos (Sk,) -> bool (Sq, Sk), True = attend."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        m &= q_pos[:, None] - k_pos[None, :] < window
    return m


def _plain_attention(q, k, v, q_pos, k_pos, causal, window, scale):
    """Materialised-logits path.  GQA via head grouping.

    q (B,Sq,H,dh) × k,v (B,Skv,KVH,dh) -> (B,Sq,H,dh)."""
    B, Sq, H, dh = q.shape
    KVH = k.shape[2]
    G = H // KVH
    qg = q.reshape(B, Sq, KVH, G, dh)
    s = torch.einsum("bqkgd,bskd->bqkgs", qg.float(), k.float()) * scale
    m = _mask(q_pos, k_pos, causal, window)  # (Sq, Sk)
    s = torch.where(m[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqkgs,bskd->bqkgd", p, v.float())
    return o.reshape(B, Sq, H, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention block (parameters + apply, with KV cache support)
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, Smax, KVH, dh)
    v: torch.Tensor


class Attention(nn.Module):
    """The four projections of one attention block."""

    def __init__(self, cfg, dtype, device, generator: torch.Generator):
        super().__init__()
        d, H, KVH, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        b = cfg.use_qkv_bias
        self.wq = layers.Dense(d, H * dh, dtype, device, generator, bias=b)
        self.wk = layers.Dense(d, KVH * dh, dtype, device, generator, bias=b)
        self.wv = layers.Dense(d, KVH * dh, dtype, device, generator, bias=b)
        self.wo = layers.Dense(H * dh, d, dtype, device, generator)


def _positions_for(cfg, B: int, S: int, offset: int = 0,
                   device=None) -> torch.Tensor:
    if cfg.m_rope:
        raise NotImplementedError(
            "M-RoPE positions wait for the vision-language slice")
    pos = offset + torch.arange(S, device=device)
    return pos.expand(B, S)


def attn_apply(p: Attention, x: torch.Tensor, cfg, *,
               positions: Optional[torch.Tensor] = None,
               cache: Optional[KVCache] = None,
               cache_pos: Optional[int] = None
               ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """x (B, S, d).  If ``cache`` is given, S is the decode step width (1),
    k/v are written at ``cache_pos`` (a host integer) and attention runs over
    the cache.  The cache is updated IN PLACE and returned."""
    B, S, d = x.shape
    H, KVH, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    if cfg.m_rope:
        raise NotImplementedError(
            "M-RoPE (apply_mrope) waits for the vision-language slice")
    if positions is None:
        offset = 0 if cache is None else cache_pos
        positions = _positions_for(cfg, B, S, offset, x.device)

    q = p.wq(x).reshape(B, S, H, dh)
    k = p.wk(x).reshape(B, S, KVH, dh)
    v = p.wv(x).reshape(B, S, KVH, dh)
    q = logical(q, ("act_batch", None, "act_heads", None))
    k = logical(k, ("act_batch", None, "act_kv_heads", None))
    v = logical(v, ("act_batch", None, "act_kv_heads", None))

    cos, sin = _rope_cos_sin(positions, dh // 2, cfg.rope_theta)
    q = _rotate(q, cos, sin)
    k = _rotate(k, cos, sin)

    new_cache = None
    if cache is None:
        if context_parallel_factor(H, S) > 1:
            raise NotImplementedError(
                "context-parallel attention waits for the multi-device slice")
        if flags.attention_stubbed():  # cost-attribution mode
            o = v.repeat_interleave(H // KVH, dim=2)
        elif flags.kernels_enabled():
            # the kernel takes (B, H, S, dh): strided views, no copies.  The
            # reference asks the autotuner for the tiling here; until that is
            # ported the kernel's default tiles are used.
            o = kops.flash_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=True, window=cfg.sliding_window,
            ).transpose(1, 2)
        else:
            o = _plain_attention(
                q, k, v, torch.arange(S, device=x.device),
                torch.arange(S, device=x.device), True, cfg.sliding_window,
                1.0 / math.sqrt(dh))
    else:
        # decode: write into the cache ring/window and attend over it
        Smax = cache.k.shape[1]
        ring = cfg.sliding_window is not None and Smax <= cfg.sliding_window
        slot = cache_pos % Smax if ring else cache_pos
        if slot + S > Smax:
            raise ValueError(
                f"KV cache is full: position {cache_pos} with a cache of "
                f"{Smax} rows (max_len); raise max_len or end the sequence")
        cache.k[:, slot:slot + S] = k  # in place
        cache.v[:, slot:slot + S] = v
        new_cache = cache
        o = _decode_attention(q, cache.k, cache.v, cfg, cache_pos)

    o = logical(o, ("act_batch", "act_seq", "act_heads", None))
    out = p.wo(o.reshape(B, S, H * dh))
    return out, new_cache


def _decode_attention(q, ck, cv, cfg, cache_pos: int):
    """Single-token decode over the cache: materialises (B, H, Smax) logits,
    O(S) per token."""
    B, S, H, dh = q.shape  # S == 1
    Smax, KVH = ck.shape[1], ck.shape[2]
    G = H // KVH
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(B, S, KVH, G, dh).float()
    s = torch.einsum("bqkgd,bskd->bqkgs", qg, ck.float()) * scale
    k_pos = torch.arange(Smax, device=q.device)
    if cfg.sliding_window is not None and Smax <= cfg.sliding_window:
        valid = torch.ones((Smax,), dtype=torch.bool,
                           device=q.device)  # ring buffer: all slots valid
    else:
        valid = k_pos <= cache_pos
        if cfg.sliding_window is not None:
            valid &= cache_pos - k_pos < cfg.sliding_window
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqkgs,bskd->bqkgd", p, cv.float())
    return o.reshape(B, S, H, dh).to(q.dtype)


def cache_shape(cfg, B: int, max_len: int) -> Tuple[int, int, int, int]:
    """(B, Smax, KVH, dh); a sliding window caps the rows kept."""
    if cfg.sliding_window is not None:
        max_len = min(max_len, cfg.sliding_window)
    return (B, max_len, cfg.n_kv_heads, cfg.head_dim_)


def init_cache(cfg, B: int, max_len: int, dtype, device="cuda") -> KVCache:
    shape = cache_shape(cfg, B, max_len)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))
