"""Attention: GQA, RoPE / M-RoPE or no positional encoding (``use_rope``
off), sliding window, the chunked online-softmax path with its flash-style
backward, and KV-cache decode.

Train and prefill go through the hand-written flash-attention kernel
(``repro_torch.kernels.flash_attention``) inside ``_FlashAttention``, an
autograd Function: its forward is the kernel, which also writes the row
log-sum-exp, and its backward is the reference's ``_flash_xla_bwd`` in torch
ops (``_flash_bwd``): the tiles of P re-derived from the saved (o, lse) chunk
by chunk, f32 math.  The JAX package has no backward kernel, so none is
ported.  Under ``flags.use_kernels(False)``, ``attention_core`` dispatches
as the reference does: the chunked path (``_chunked_attention`` under the
same backward, ``_FlashXLA``) above ``CHUNKED_ABOVE`` query-key pairs, the
materialised-logits ``_plain_attention`` below.  Under a sharding context
whose model axis the heads cannot fill, the plain path splits q into
``context_parallel_factor`` slices (context parallelism); the kernel path
ignores the split, as the reference's does.  Decode over the cache is plain
tensor code, as in the reference.  On DTensors (a sharded step) the kernel
and the context-parallel slices run under ``local_map`` on each rank's
shard, and the decode cache is written shard by shard
(``sharding.write_rows``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import context_parallel_factor, logical
from repro_torch.kernels import ops as kops
from repro_torch.models import layers
from repro_torch.runtime import flags

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def _rope_freqs(half: int, theta: float, device) -> torch.Tensor:
    """theta ** (-i / half), i < half, in f32.  The power is taken in f64
    and rounded once, so each frequency is the f32 value nearest the exact
    one, as the reference's are (PyTorch's f32 ``pow`` is off by an ulp at a
    few of them, which at positions in the thousands turns the angle by
    ~1e-6)."""
    exponent = -torch.arange(half, dtype=torch.float32, device=device) / half
    # scalar base: no host-to-device copy
    return torch.pow(theta, exponent.double()).float()


def _rope_angles(positions: torch.Tensor, half: int,
                 theta: float) -> torch.Tensor:
    """positions (..., S) -> angles (..., S, half)  [f32]."""
    return positions.float()[..., None] * _rope_freqs(half, theta,
                                                      positions.device)


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


def _mrope_cos_sin(positions: torch.Tensor, half: int, theta: float,
                   sections) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (B, S, 3) = (t, h, w) ids -> cos, sin (B, S, 1, half) in
    f32.  The ``half`` frequency slots are split into ``sections`` (t, h,
    w); each slot turns by the position component of its section."""
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"head_dim // 2 = {half}")
    sec_id = torch.tensor([i for i, n in enumerate(sections)
                           for _ in range(n)], device=positions.device)
    pos = positions.float()[..., sec_id]                       # (B, S, half)
    ang = pos * _rope_freqs(half, theta, positions.device)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections) -> torch.Tensor:
    """Qwen2-VL M-RoPE.  x (B, S, H, dh); positions (B, S, 3) = (t, h, w)
    ids.  Half-split layout, f32 math."""
    return _rotate(x, *_mrope_cos_sin(positions, x.shape[-1] // 2, theta,
                                      sections))


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
    qg = sharding.split_dim(q, 2, KVH)
    s = torch.einsum("bqkgd,bskd->bqkgs", qg.float(), k.float()) * scale
    m = _mask(q_pos, k_pos, causal, window)  # (Sq, Sk)
    s = torch.where(m[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqkgs,bskd->bqkgd", p, v.float())
    return o.reshape(B, Sq, H, dh).to(q.dtype)


_BIAS_NEG = -1e9   # additive mask bias (finite: keeps exp() well-defined)
_M_INIT = -1e4     # running-max floor; masked rows renormalise to 0

#: ``attention_core`` takes the chunked path above this many (q, k) pairs
CHUNKED_ABOVE = 2048 * 2048


#: logical axes of the grouped layout (B, KVH, G, S, d) of the chunked path
_GROUPED = ("act_batch", "act_kv_heads", "act_heads", None, None)


def _grouped(t: torch.Tensor, KVH: int) -> torch.Tensor:
    """(B, S, H, d) -> (B, KVH, G, S, d) f32: a head's rows next to those
    of the other heads of its group, so that one product per (b, kv head)
    covers the whole group."""
    return sharding.split_dim(t.float(), 2, KVH).permute(0, 2, 3, 1, 4)


def _chunk_needed(q0, q1, k0, k1, causal, window) -> bool:
    """Does the (q rows q0..q1-1) × (keys k0..k1-1) pair hold a visible
    pair?  The reference skips the others (``lax.cond``)."""
    return (not causal or k0 <= q1 - 1) and \
        (window is None or q0 - (k1 - 1) < window)


def _chunk_bias(q0, q1, k0, k1, causal, window, device):
    """The additive mask of a chunk pair, or None where every pair is
    visible (adding a bias of 0 changes no value)."""
    if (not causal or k1 - 1 <= q0) and \
            (window is None or (q1 - 1) - k0 < window):
        return None
    m = _mask(torch.arange(q0, q1, device=device),
              torch.arange(k0, k1, device=device), causal, window)
    return torch.where(m, 0.0, _BIAS_NEG)


def _chunked_attention(q, k, v, q_offset, causal, window, scale,
                       chunk_q: int, chunk_kv: int):
    """Online-softmax double loop over q chunks × kv chunks, f32 math.

    q (B,Sq,H,dh) × k,v (B,Skv,KVH,dh) -> (out (B,Sq,H,dh) in q's type,
    lse (B,Sq,KVH,G) f32).  Live memory is O(B·H·chunk_q·chunk_kv) logits;
    fully masked chunk pairs are skipped, the mask is the reference's
    additive ``_BIAS_NEG`` and the running max is floored at ``_M_INIT``,
    so fully masked rows stay zero.  ``q_offset`` is the absolute position
    of q[0].  A length that is not a multiple of its chunk leaves a shorter
    last chunk (the reference asserts divisibility)."""
    B, Sq, H, dh = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    # the grouped layout sharded on G (= H / KVH) where the model axis
    # cannot shard KVH, as the reference's (its KVH < tp case)
    qg = logical(_grouped(q, KVH), _GROUPED)   # (B, KVH, G, Sq, dh)
    kf = k.float().transpose(1, 2)             # (B, KVH, Skv, dh)
    vf = v.float().transpose(1, 2)
    out = q.new_empty((B, KVH, G, Sq, dh), dtype=torch.float32)
    lse = q.new_empty((B, KVH, G, Sq), dtype=torch.float32)
    for q0 in range(0, Sq, chunk_q):
        q1 = min(q0 + chunk_q, Sq)
        cq = q1 - q0
        qb = qg[:, :, :, q0:q1].reshape(B, KVH, G * cq, dh)
        m_run = q.new_full((B, KVH, G * cq, 1), _M_INIT, dtype=torch.float32)
        l_run = q.new_zeros((B, KVH, G * cq, 1), dtype=torch.float32)
        acc = q.new_zeros((B, KVH, G * cq, dh), dtype=torch.float32)
        for k0 in range(0, Skv, chunk_kv):
            k1 = min(k0 + chunk_kv, Skv)
            a0, a1 = q_offset + q0, q_offset + q1
            if not _chunk_needed(a0, a1, k0, k1, causal, window):
                continue
            s = torch.matmul(qb, kf[:, :, k0:k1].transpose(-1, -2)) * scale
            bias = _chunk_bias(a0, a1, k0, k1, causal, window, q.device)
            if bias is not None:
                s = (s.view(B, KVH, G, cq, k1 - k0) + bias).view_as(s)
            m_new = torch.clamp(torch.maximum(m_run, s.amax(-1, True)),
                                min=_M_INIT)
            alpha = torch.exp(m_run - m_new)
            p = torch.exp(s - m_new)            # masked lanes -> 0
            l_run = l_run * alpha + p.sum(-1, True)
            acc = acc * alpha + torch.matmul(p, vf[:, :, k0:k1])
            m_run = m_new
        l_run = torch.clamp(l_run, min=1e-20)
        out[:, :, :, q0:q1] = (acc / l_run).view(B, KVH, G, cq, dh)
        lse[..., q0:q1] = (m_run + torch.log(l_run)).view(B, KVH, G, cq)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, dh).to(q.dtype)
    return out, lse.permute(0, 3, 1, 2)


def _flash_bwd(q, k, v, o, lse, do, q_offset, causal, window, scale,
               chunk_q: int, chunk_kv: int):
    """The reference's ``_flash_xla_bwd`` in torch ops: dq, dk, dv from the
    saved (o, lse), every tile of P re-derived inside the chunk loops.

    q, o, do (B,Sq,H,dh); k, v (B,Skv,KVH,dh); lse (B,H,Sq) f32.  Outer loop
    over kv chunks, inner over q chunks, fully masked pairs skipped, the
    additive ``_BIAS_NEG`` mask, ``D = rowsum(do ⊙ o)``; f32 math, the
    gradients cast to the inputs' types."""
    B, Sq, H, dh = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    # the reference's four annotations of the grouped layout
    qg = logical(_grouped(q, KVH), _GROUPED)        # (B, KVH, G, Sq, dh)
    dog = logical(_grouped(do, KVH), _GROUPED)
    og = logical(_grouped(o, KVH), _GROUPED)
    lseg = logical(lse.float().reshape(B, KVH, G, Sq), _GROUPED[:-1])
    D = (dog * og).sum(-1)                          # (B, KVH, G, Sq)
    kf = k.float().transpose(1, 2)                  # (B, KVH, Skv, dh)
    vf = v.float().transpose(1, 2)
    dq = torch.zeros_like(qg)
    dk = torch.empty_like(kf)
    dv = torch.empty_like(vf)
    for k0 in range(0, Skv, chunk_kv):
        k1 = min(k0 + chunk_kv, Skv)
        kb, vb = kf[:, :, k0:k1], vf[:, :, k0:k1]
        dk_blk = torch.zeros_like(kb)
        dv_blk = torch.zeros_like(vb)
        for q0 in range(0, Sq, chunk_q):
            q1 = min(q0 + chunk_q, Sq)
            cq = q1 - q0
            a0, a1 = q_offset + q0, q_offset + q1
            if not _chunk_needed(a0, a1, k0, k1, causal, window):
                continue
            qb = qg[:, :, :, q0:q1].reshape(B, KVH, G * cq, dh)
            dob = dog[:, :, :, q0:q1].reshape(B, KVH, G * cq, dh)
            s = torch.matmul(qb, kb.transpose(-1, -2)).mul_(scale)
            bias = _chunk_bias(a0, a1, k0, k1, causal, window, q.device)
            if bias is not None:
                s.view(B, KVH, G, cq, k1 - k0).add_(bias)
            lse_b = lseg[..., q0:q1].reshape(B, KVH, G * cq, 1)
            p = s.sub_(lse_b).exp_()                # the re-derived tile
            dv_blk += torch.matmul(p.transpose(-1, -2), dob)
            dp = torch.matmul(dob, vb.transpose(-1, -2))
            D_b = D[..., q0:q1].reshape(B, KVH, G * cq, 1)
            ds = dp.sub_(D_b).mul_(p)
            dq[:, :, :, q0:q1] += torch.matmul(ds, kb).mul_(scale).view(
                B, KVH, G, cq, dh)
            dk_blk += torch.matmul(ds.transpose(-1, -2), qb).mul_(scale)
        dk[:, :, k0:k1] = dk_blk
        dv[:, :, k0:k1] = dv_blk
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, dh).to(q.dtype)
    return dq, dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype)


class _FlashXLA(torch.autograd.Function):
    """The reference's ``_flash_xla``: the chunked forward, saving only
    (o, lse), and the flash-style backward.  q (B,Sq,H,dh), k, v
    (B,Skv,KVH,dh)."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, causal, window, chunk_q, chunk_kv):
        scale = 1.0 / math.sqrt(q.shape[-1])
        o, lse = _chunked_attention(q, k, v, q_offset, causal, window, scale,
                                    chunk_q, chunk_kv)
        B, Sq, H = q.shape[:3]
        ctx.save_for_backward(q, k, v, o,
                              lse.reshape(B, Sq, H).transpose(1, 2))
        ctx.args = (q_offset, causal, window, scale, chunk_q, chunk_kv)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, o, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


class _FlashAttention(_FlashXLA):
    """Attention through the hand-written kernel, differentiable: the
    forward is ``kops.flash_attention`` (on a CPU tensor its plain
    version), asked for the row log-sum-exp only when a gradient will be
    needed (``grad``: autograd was on at the call); the backward is
    ``_FlashXLA``'s, from the saved (q, k, v, o, lse).  q (B,Sq,H,dh), k, v
    (B,Skv,KVH,dh) — the kernel reads them as (B,H,S,dh) views, no copies;
    causal from position 0."""

    @staticmethod
    def forward(ctx, q, k, v, window, chunk_q, chunk_kv, grad):
        scale = 1.0 / math.sqrt(q.shape[-1])
        need = grad and any(ctx.needs_input_grad[:3])
        out = kops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=True, window=window, return_lse=need,
            block_sizes="auto")  # cost-model-chosen tile (autotune)
        o, lse = out if need else (out, None)
        o = o.transpose(1, 2)
        if need:
            ctx.save_for_backward(q, k, v, o, lse)
            ctx.args = (0, True, window, scale, chunk_q, chunk_kv)
        return o

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv = _FlashXLA.backward(ctx, do)[:3]
        return dq, dk, dv, None, None, None, None


def _kernel_attention(q, k, v, cfg):
    S = q.shape[1]
    return _FlashAttention.apply(q, k, v, cfg.sliding_window, min(1024, S),
                                 min(1024, S), torch.is_grad_enabled())


def _head_placements(q, k):
    """(q's, k/v's, k/v's gradients') placements for a call on local heads:
    the batch over the data axes, the heads over the model axis where they
    divide it, the sequence whole.  Where q's heads are split and the kv
    heads are not (``n_kv_heads`` does not divide the model axis), each
    rank reads the kv heads its q heads use
    (``sharding.groups_of_local_heads``), so the gradient of k / v is a
    partial sum over the model axis."""
    ctx = sharding.current()
    q_pl = ctx.placements(ctx.act_spec(("act_batch", None, "act_heads",
                                        None), q.shape))
    kv_pl = ctx.placements(ctx.act_spec(("act_batch", None, "act_kv_heads",
                                         None), k.shape))
    tp = ctx.plan.tp_axis
    split = sharding.is_sharded_on(q_pl, tp, 2) and \
        not sharding.is_sharded_on(kv_pl, tp, 2)
    grad_pl = sharding.partial_on(kv_pl, tp) if split else kv_pl
    return q_pl, kv_pl, grad_pl, split


def _kernel_on_local_heads(q, k, v, cfg):
    """``_FlashAttention`` on plain tensors; on DTensors, under
    ``local_map`` on each rank's shard (batch rows over the data axes,
    heads over the model axis, the whole sequence), so that the kernel's
    wrapper is handed this rank's tensors and never a DTensor."""
    if not sharding.is_dtensor(q):
        return _kernel_attention(q, k, v, cfg)
    from torch.distributed.tensor.experimental import local_map
    q_pl, kv_pl, grad_pl, split = _head_placements(q, k)
    rank, n = sharding.axis_index(sharding.current().plan.tp_axis)
    H = q.shape[2]

    def local(ql, kl, vl):
        if split:
            kl = sharding.groups_of_local_heads(kl, 2, H, rank, n)
            vl = sharding.groups_of_local_heads(vl, 2, H, rank, n)
        return _kernel_attention(ql, kl, vl, cfg)

    return local_map(local, out_placements=list(q_pl),
                     in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, grad_pl, grad_pl),
                     device_mesh=sharding.current().mesh,
                     redistribute_inputs=True)(q, k, v)


def _context_parallel(qs, k, v, cfg):
    """Each q slice of ``qs`` (B, cp, S/cp, H, dh) against the whole of k,
    v at its own absolute offset, stacked on dim 1.  On DTensors each rank
    of the model axis takes its own slice (``local_map``: qs sharded on
    the slice dim, k / v whole there, their gradients partial sums), as
    the reference's ``vmap`` over the sharded slice dim does."""
    Scp = qs.shape[2]

    def slices(ql, kl, vl, first: int = 0):
        return torch.stack([attention_core(
            ql[:, i], kl, vl, causal=True, window=cfg.sliding_window,
            q_offset=(first + i) * Scp) for i in range(ql.shape[1])], dim=1)

    if not sharding.is_dtensor(qs):
        return slices(qs, k, v)
    from torch.distributed.tensor.experimental import local_map
    ctx = sharding.current()
    q_pl = ctx.placements(ctx.act_spec(("act_batch", "act_cp", None, None,
                                        None), qs.shape))
    kv_pl = ctx.placements(ctx.act_spec(("act_batch", None, None, None),
                                        k.shape))
    grad_pl = sharding.partial_on(kv_pl, ctx.plan.tp_axis)
    rank, n = sharding.axis_index(ctx.plan.tp_axis)

    def local(ql, kl, vl):
        return slices(ql, kl, vl, first=rank * ql.shape[1])

    return local_map(local, out_placements=list(q_pl),
                     in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, grad_pl, grad_pl),
                     device_mesh=ctx.mesh, redistribute_inputs=True)(qs, k, v)


def attention_core(q, k, v, *, causal: bool = True,
                   window: Optional[int] = None, q_offset: int = 0,
                   chunk_q: int = 1024, chunk_kv: int = 1024,
                   force_chunked: bool = False) -> torch.Tensor:
    """q (B,Sq,H,dh) × k,v (B,Skv,KVH,dh) -> (B,Sq,H,dh), the plain paths.

    ``q_offset``: absolute position of q[0].  Dispatches as the reference
    does: the chunked path (with its flash-style backward) when ``Sq·Skv``
    exceeds ``CHUNKED_ABOVE`` (or ``force_chunked``) and both lengths are
    multiples of 512 with ``Sq > 1``; the materialised-logits path
    otherwise."""
    B, Sq, H, dh = q.shape
    Skv = k.shape[1]
    big = Sq * Skv > CHUNKED_ABOVE
    if (big or force_chunked) and Sq % 512 == 0 and Skv % 512 == 0 \
            and Sq > 1:
        return _FlashXLA.apply(q, k, v, q_offset, causal, window,
                               min(chunk_q, Sq), min(chunk_kv, Skv))
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Skv, device=q.device)
    return _plain_attention(q, k, v, q_pos, k_pos, causal, window,
                            1.0 / math.sqrt(dh))


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
    """(B, S) ids; (B, S, 3) (t, h, w) ids for M-RoPE, all three the text
    position (the reference's stub: no vision grid)."""
    pos = (offset + torch.arange(S, device=device)).expand(B, S)
    if cfg.m_rope:
        return pos[..., None].expand(B, S, 3)
    return pos


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
    if positions is None:
        offset = 0 if cache is None else cache_pos
        positions = _positions_for(cfg, B, S, offset, x.device)

    x = layers.rows_whole(x)    # gathered once for the three projections
    q = sharding.split_last(p.wq(x), H, dh)
    k = sharding.split_last(p.wk(x), KVH, dh)
    v = sharding.split_last(p.wv(x), KVH, dh)
    q = logical(q, ("act_batch", None, "act_heads", None))
    k = logical(k, ("act_batch", None, "act_kv_heads", None))
    v = logical(v, ("act_batch", None, "act_kv_heads", None))

    if cfg.use_rope:
        if cfg.m_rope:
            cos, sin = _mrope_cos_sin(positions, dh // 2, cfg.rope_theta,
                                      cfg.mrope_sections)
        else:
            cos, sin = _rope_cos_sin(positions, dh // 2, cfg.rope_theta)
        q = _rotate(q, cos, sin)
        k = _rotate(k, cos, sin)

    new_cache = None
    if cache is None:
        cp = context_parallel_factor(H, S)
        if flags.attention_stubbed():  # cost-attribution mode
            o = v.repeat_interleave(H // KVH, dim=2)
        elif flags.kernels_enabled():
            # the kernel, differentiable, at the autotuner's tile (as the
            # reference asks for it), on each rank's heads under a sharding
            # context; its backward chunks as attention_core's chunked
            # path does
            o = _kernel_on_local_heads(q, k, v, cfg)
        elif cp > 1:
            # context parallelism: n_heads % tp != 0, so attention divides
            # over the model axis by q-SLICE instead of by head; k/v stay
            # whole and each slice runs with its own absolute offset
            Scp = S // cp
            qs = logical(q.reshape(B, cp, Scp, H, dh),
                         ("act_batch", "act_cp", None, None, None))
            o = _context_parallel(qs, k, v, cfg)
            o = logical(o, ("act_batch", "act_cp", None, None, None))
            o = o.reshape(B, S, H, dh)
        else:
            o = attention_core(q, k, v, causal=True,
                               window=cfg.sliding_window)
    else:
        # decode: write into the cache ring/window and attend over it
        Smax = cache.k.shape[1]
        ring = cfg.sliding_window is not None and Smax <= cfg.sliding_window
        slot = cache_pos % Smax if ring else cache_pos
        if slot + S > Smax:
            raise ValueError(
                f"KV cache is full: position {cache_pos} with a cache of "
                f"{Smax} rows (max_len); raise max_len or end the sequence")
        sharding.write_rows(cache.k, slot, k)  # in place
        sharding.write_rows(cache.v, slot, v)
        names = ("act_batch", "act_seq_dp", "act_kv_heads", None)
        new_cache = KVCache(logical(cache.k, names), logical(cache.v, names))
        o = _decode_attention(q, new_cache.k, new_cache.v, cfg, cache_pos)

    o = logical(o, ("act_batch", "act_seq", "act_heads", None))
    out = p.wo(sharding.merge_last(o))
    return out, new_cache


def _decode_attention(q, ck, cv, cfg, cache_pos: int):
    """Single-token decode over the cache: materialises (B, H, Smax) logits,
    O(S) per token."""
    B, S, H, dh = q.shape  # S == 1
    Smax, KVH = ck.shape[1], ck.shape[2]
    G = H // KVH
    scale = 1.0 / math.sqrt(dh)
    qg = sharding.split_dim(q, 2, KVH).float()
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
