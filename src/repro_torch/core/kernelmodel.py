"""Kernel-level symbolic property vectors — the per-kernel unit of
prediction (paper §6.2, and the follow-up cross-machine models).

Where ``core.archcount`` emits one property vector per *training step*,
this module emits one per *kernel launch*, parameterized over both the
problem shape AND the launch configuration (block/tile sizes) as
``symcount`` variables.

Per kernel we count (closed-form in the block variables):

  * ``mxu:<bits>``    — dot MACs×2 at *block-rounded* granularity, so a
                        block that overshoots the shape pays for its padding;
  * ``local:<bits>``  — on-chip block traffic per grid cell;
  * ``barrier``       — grid steps (sequential-dimension synchronisations);
  * ``groups``        — parallel grid cells (launch/occupancy proxy);
  * ``const1``        — 1 per launch.

``step_kernel_vectors`` recomposes a whole forward pass out of these
per-kernel vectors (projections/FFN/head → matmul, attention → flash,
SSD → ssd_scan), which is what ``core.predictor`` uses for its compute
term.

A partial copy of the reference's ``core/kernelmodel.py``: the per-kernel
vector builders and the step composition, with the reference's default
blocks, so that the port's step counts equal the reference's.  **These
vectors count the reference's Pallas block schedule (128-wide matmul and
attention tiles, the SSD chunk), not what the CUDA kernels execute.**  The
kernel registry, its candidate grids and the TPU's VMEM budget are not
ported; the autotuner slice (ROADMAP A11) brings them and re-points these
vectors to the tiles the CUDA sources report (``flash_attention_tile``,
``matmul_tile``, ``ssd_scan_tile``, ``transpose_tile``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.core import properties as props
from repro_torch.core.symcount import (
    CeilDiv, Const, Expr, ExprLike, Max, Min, Var, add_vectors, as_expr,
    scale_vector,
)

# Free variables of the step-level composition (same names as archcount)
B = Var("B")   # global batch
S = Var("S")   # sequence length


# ---------------------------------------------------------------------------
# Per-kernel symbolic property vectors
# ---------------------------------------------------------------------------


def matmul_vector(M: ExprLike, N: ExprLike, K: ExprLike, *,
                  block_m: ExprLike = 128, block_n: ExprLike = 128,
                  block_k: ExprLike = 128, bits: int = 32
                  ) -> Dict[str, ExprLike]:
    """(M,K)@(K,N) tiled matmul: (bm×bk)+(bk×bn) tiles stream HBM→VMEM per
    grid cell, fp32 (bm×bn) accumulator carried across the sequential k
    walk."""
    M, N, K = as_expr(M), as_expr(N), as_expr(K)
    bm, bn, bk = as_expr(block_m), as_expr(block_n), as_expr(block_k)
    n_m, n_n, n_k = CeilDiv(M, bm), CeilDiv(N, bn), CeilDiv(K, bk)
    cells = n_m * n_n * n_k
    local = cells * (bm * bk + bk * bn + bm * bn)
    return {
        props.local_key(bits): local,
        props.BARRIER: cells,
        props.GROUPS: n_m * n_n,
        props.mxu_key(bits): 2 * cells * bm * bn * bk,
        props.CONST1: 1.0,
    }


def _fa_exec_blocks(n_q: Expr, n_k: Expr, *, causal: bool,
                    window: Optional[int], block_q: ExprLike,
                    block_k: ExprLike) -> Expr:
    """Executed (non-skipped) (q-block, k-block) pairs per (batch, head).

    causal: ceil((n_q·n_k + max(n_q, n_k)) / 2) — exact for the square
    case (block_q == block_k, Sq == Skv): triangle + diagonal.
    window w: at most ceil(w / block_k) + 1 k-blocks intersect a q-row's
    band; combined with causal by taking the tighter bound.
    """
    full = n_q * n_k
    execd = full
    if causal:
        execd = CeilDiv(full + Max(n_q, n_k), Const(2))
    if window is not None:
        band = Min(n_k, CeilDiv(Const(window), as_expr(block_k)) + 1)
        execd = Min(execd, n_q * band)
    return execd


def flash_attention_vector(B_: ExprLike, H: ExprLike, KVH: ExprLike,
                           Sq: ExprLike, Skv: ExprLike, dh: ExprLike, *,
                           causal: bool = True, window: Optional[int] = None,
                           block_q: ExprLike = 128, block_k: ExprLike = 128,
                           bits: int = 16) -> Dict[str, ExprLike]:
    """Online-softmax attention: q/k/v tiles stream per executed pair; the
    (bq×bk) logit tile never leaves VMEM; fully-masked pairs are skipped
    (but their grid steps still barrier)."""
    bq, bk = as_expr(block_q), as_expr(block_k)
    n_q, n_k = CeilDiv(as_expr(Sq), bq), CeilDiv(as_expr(Skv), bk)
    cells = as_expr(B_) * as_expr(H) * n_q * n_k
    execd = _fa_exec_blocks(n_q, n_k, causal=causal, window=window,
                            block_q=bq, block_k=bk)
    exec_cells = as_expr(B_) * as_expr(H) * execd
    local = exec_cells * (bq * as_expr(dh) + 2 * bk * as_expr(dh))
    return {
        props.local_key(bits): local,
        props.BARRIER: cells,
        props.GROUPS: cells,
        props.mxu_key(bits): 4 * exec_cells * bq * bk * as_expr(dh),
        props.CONST1: 1.0,
    }


def ssd_scan_vector(Bz: ExprLike, H: ExprLike, L: ExprLike, P: ExprLike,
                    N: ExprLike, *, chunk: ExprLike = 128, bits: int = 16
                    ) -> Dict[str, ExprLike]:
    """Chunked SSD: per (batch, head, chunk) cell the x/B/C blocks move
    HBM→VMEM and the (P×N) state stays VMEM-resident.  Intra-chunk work is
    quadratic in the chunk; the state update is paid once per chunk — the
    block-size tradeoff the tuner balances."""
    Q = as_expr(chunk)
    nc = CeilDiv(as_expr(L), Q)
    cells = as_expr(Bz) * as_expr(H) * nc
    local = cells * (Q * as_expr(P) + 2 * Q * as_expr(N)
                     + as_expr(P) * as_expr(N))
    mxu = cells * 2 * (Q * Q * as_expr(N)          # C·Bᵀ
                       + Q * Q * as_expr(P)        # W·x (intra)
                       + Q * as_expr(P) * as_expr(N) * 2)  # inter + state
    return {
        props.local_key(bits): local,
        props.BARRIER: cells,
        props.GROUPS: cells,
        props.mxu_key(bits): mxu,
        props.CONST1: 1.0,
    }


def transpose_vector(M: ExprLike, N: ExprLike, *, block: ExprLike = 256,
                     bits: int = 32) -> Dict[str, ExprLike]:
    """VMEM-tile relayout: each (b×b) tile passes through VMEM twice
    (stream in, stream out) so both HBM directions stay stride-1."""
    b = as_expr(block)
    bm, bn = Min(b, as_expr(M)), Min(b, as_expr(N))
    cells = CeilDiv(as_expr(M), bm) * CeilDiv(as_expr(N), bn)
    return {
        props.local_key(bits): cells * 2 * bm * bn,
        props.BARRIER: cells,
        props.GROUPS: cells,
        props.CONST1: 1.0,
    }


# ---------------------------------------------------------------------------
# Step-level composition — the predictor's compute term, per kernel
# ---------------------------------------------------------------------------


def _attn_matmul_shapes(cfg, T: ExprLike) -> List[Tuple[ExprLike, ExprLike,
                                                        ExprLike]]:
    """Dense projection matmuls of one attention layer, (M, N, K) with the
    token dim ``T`` symbolic."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    return [(T, H * hd, d), (T, KV * hd, d), (T, KV * hd, d), (T, d, H * hd)]


def _ffn_matmul_shapes(cfg, T: ExprLike) -> List[Tuple[ExprLike, ExprLike,
                                                       ExprLike]]:
    return [(T, cfg.d_ff, cfg.d_model), (T, cfg.d_ff, cfg.d_model),
            (T, cfg.d_model, cfg.d_ff)]


def step_kernel_vectors(cfg, workload="train"
                        ) -> Dict[str, Dict[str, ExprLike]]:
    """Per-kernel symbolic property vectors for ONE pass of ``cfg``, at the
    kernels' default block sizes, for any ``workload``
    (``repro_torch.core.workload.WorkloadLike``; bare phase strings are the
    deprecated legacy form and warn).

    Returns ``{kernel_name: property_vector}`` with the same free variables
    as ``archcount`` (B, S — plus AS/SL/MI when a decode spec sets the
    corresponding refinement).  The composition mirrors
    ``archcount._layer_macs`` contraction-for-contraction, so the mxu totals
    agree in the leading term; kernel-level block rounding and the VMEM
    (``local:``) traffic are what this granularity adds.  Contractions with
    no Pallas kernel (MoE dispatch einsum, the SSM short conv, embedding
    gather) stay with archcount's step counts and are NOT counted here.

    Decode emits the per-token dense matmuls only (projections, FFN, LM
    head, token dim = occupied slots × speculative length): the
    cache-streaming attention / recurrent-state update of a decode step has
    no Pallas kernel in this repo, so those counts stay with
    ``archcount.decode_counts``.
    """
    from repro_torch.core import archcount  # late import: archcount is heavier
    from repro_torch.core import workload as wl
    spec = wl.as_spec(workload, _stacklevel=4)
    bits = 16 if "16" in cfg.compute_dtype else 32
    L = cfg.n_layers
    out: Dict[str, Dict[str, ExprLike]] = {}

    decode = spec.phase == "decode"
    flags = frozenset(spec.structure()[1:])
    if decode:
        rows = archcount.AS if "as" in flags else B
        T = rows * archcount.SL if "sl" in flags else rows
    else:
        T = B * S

    mm_shapes: List[Tuple[ExprLike, ExprLike, ExprLike, ExprLike]] = []
    n_attn = 0
    if cfg.family == "ssm":
        n_ssm = L
    elif cfg.family == "hybrid":
        n_ssm = L
        n_attn = L // cfg.hybrid.attn_every
    else:
        n_ssm = 0
        n_attn = L

    if n_attn:
        for (m, n, k) in _attn_matmul_shapes(cfg, T):
            mm_shapes.append((m, n, k, float(n_attn)))
        if cfg.moe is not None:
            active = cfg.moe.top_k * cfg.moe.capacity_factor
            expert_mult: ExprLike = float(n_attn) * active
            if decode and "mi" in flags:
                expert_mult = as_expr(expert_mult) * archcount.MI
            for (m, n, k) in _ffn_matmul_shapes(cfg, T):
                mm_shapes.append((m, n, k, expert_mult))
        else:
            for (m, n, k) in _ffn_matmul_shapes(cfg, T):
                mm_shapes.append((m, n, k, float(n_attn)))
    if n_ssm:
        s = cfg.ssm
        d, din = cfg.d_model, cfg.d_inner
        G, N = s.n_groups, s.d_state
        # in_proj (x, z, B, C, dt) + out_proj
        mm_shapes.append((T, 2 * din + 2 * G * N + cfg.ssm_heads, d,
                          float(n_ssm)))
        mm_shapes.append((T, d, din, float(n_ssm)))
    # LM head
    mm_shapes.append((T, cfg.vocab_size * cfg.n_output_heads, cfg.d_model,
                      1.0))

    mm_pv: Dict[str, ExprLike] = {}
    for (m, n, k, mult) in mm_shapes:
        mm_pv = add_vectors(mm_pv, scale_vector(
            matmul_vector(m, n, k, bits=bits), mult))
    out["matmul"] = mm_pv

    if n_attn and not decode:
        out["flash_attention"] = scale_vector(
            flash_attention_vector(B, cfg.n_heads, cfg.n_kv_heads, S, S,
                                   cfg.head_dim_, causal=True,
                                   window=cfg.sliding_window, bits=bits),
            float(n_attn))
    if n_ssm and not decode:
        s = cfg.ssm
        out["ssd_scan"] = scale_vector(
            ssd_scan_vector(B, cfg.ssm_heads, S, s.head_dim, s.d_state,
                            chunk=s.chunk, bits=bits),
            float(n_ssm))

    # contractions with no Pallas kernel: keep their archcount-style MAC
    # closed forms so the kernel-composed mxu total replaces the step count
    # without dropping terms (MoE dense dispatch/combine, SSM short conv)
    extra = as_expr(0)
    if n_attn and cfg.moe is not None:
        dispatch = archcount._moe_dispatch_macs(cfg, tokens=T) if decode \
            else archcount._moe_dispatch_macs(cfg)
        extra = extra + dispatch * float(n_attn)
    if n_ssm and not decode:
        s = cfg.ssm
        extra = extra + float((cfg.d_inner + 2 * s.n_groups * s.d_state)
                              * s.d_conv * n_ssm)
    if not (isinstance(extra, Const) and extra.v == 0):
        out["unkernelized"] = {props.mxu_key(bits): 2 * extra * T}
    return out


def step_compute_vector(cfg, workload="train") -> Dict[str, ExprLike]:
    """The summed compute-side (mxu + VMEM local) vector of one forward
    pass, built from the per-kernel vectors.  barrier/groups/const1 stay at
    STEP granularity (archcount's), not per-launch — a fitted per-launch
    barrier weight does not add up across thousands of fused launches.

    Entries are CANONICALIZED (``exprops.simplify``): the layer-by-layer
    composition piles up dozens of structurally repeated addends (every
    projection matmul contributes the same CeilDiv tiles), and collapsing
    them here shrinks both the per-property compiled closures and the
    fused basis programs built downstream."""
    from repro_torch.core import exprops
    from repro_torch.core import workload as wl
    total = add_vectors(
        *step_kernel_vectors(cfg, wl.as_spec(workload, _stacklevel=4))
        .values())
    keep = ("mxu:", "local:")
    return {k: exprops.simplify(v) for k, v in total.items()
            if k.startswith(keep)}
