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
term: on the card, the library GEMMs and the CUDA kernels at the tiles the
main paths launch; under ``PALLAS_KERNELS``, the reference's composition.

A copy of the reference's ``core/kernelmodel.py`` with the CUDA kernels'
schedule beside the Pallas one:

  * each vector builder takes ``variant``, the CUDA kernel that runs the
    blocks given (``None``, the default, is the reference's Pallas schedule
    and its vector).  With a variant the blocks are the tile that kernel
    executes, and its products count on the pipe it uses: ``mxu:16`` on
    the ``wgmma`` tensor cores, ``mxu:32`` on the FP32 pipes (``paper16``
    and ``fma128`` matmuls, the FP32 attention and SSD kernels) whatever
    the input type, and the grid is priced as the card runs it: in waves
    of the blocks an SM holds (``resident``), with the waits of a wave's
    walk and the shared-memory operand reads of the FP32 pipes;
  * ``KERNELS``, the registry the autotuner (``kernels/autotune.py``)
    sweeps, lists the tiles the CUDA sources build (their Python mirrors:
    ``matmul.tile_rule``, ``flash_attention.pick_tiles`` / ``tile_rule``,
    ``ssd_scan.variant_rule`` / ``tile_rule``, ``transpose.tile_rule``),
    each with its block's shared memory, under ``SMEM_LIMIT`` (the CUDA
    sources' ``kSmemLimit``);
  * ``PALLAS_KERNELS`` is the reference's registry — its power-of-two
    grids, VMEM footprints and a v5e core's VMEM budget — kept for the
    parity tests that hold the autotuner to the reference's; nothing on the
    card is priced or bounded by it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from repro_torch.core import properties as props
from repro_torch.core.symcount import (
    CeilDiv, Const, Expr, ExprLike, Max, Min, Var, add_vectors, as_expr,
    scale_vector,
)
# bytes of shared memory one thread block may use on sm_90 (``kSmemLimit``,
# csrc/hopper.cuh): the budget of every CUDA candidate
from repro_torch.kernels.flash_attention import SMEM_LIMIT

# Free variables of the step-level composition (same names as archcount)
B = Var("B")   # global batch
S = Var("S")   # sequence length


# ---------------------------------------------------------------------------
# Per-kernel symbolic property vectors
# ---------------------------------------------------------------------------


def _pipe_bits(variant: Optional[str], bits: int) -> int:
    """The operand bits a product is counted under: the input's in the
    reference's schedule (``variant`` None), 16 on the ``wgmma`` tensor
    cores, 32 on the FP32 pipes (any other CUDA kernel)."""
    if variant is None:
        return bits
    return 16 if variant == "wgmma" else 32


# --- what paces a grid on the card (the CUDA schedule) ---------------------
#
# The TPU walks the reference's grid cell by cell, so its vectors count a
# ``barrier`` and a ``group`` per cell.  The card runs thread blocks in
# parallel, as many at once on each of its SMs as shared memory, threads and
# registers allow, so a grid is paced by waves of blocks: ``groups`` counts
# waves, ``barrier`` the block-wide waits along one wave's walk (waves x
# steps a block walks x waits a step), and the products of a partly filled
# last wave are paid as if the wave were full (the idle slots cost time).

#: the H100 SXM's SMs, and what one SM holds (NVIDIA's Hopper tuning
#: guide): 228 KB of shared memory of which each block also reserves 1 KB,
#: 2048 threads, 32 blocks, 64 K registers in four sub-partitions allocated
#: per warp in steps of 8 registers a thread
SMS = 132
SMEM_PER_SM = 233472
SMEM_RESERVED_PER_BLOCK = 1024
THREADS_PER_SM = 2048
BLOCKS_PER_SM = 32
REGS_PER_PARTITION = 16384


def resident_blocks(threads: int, registers: int, smem: float) -> int:
    """Blocks of ``threads`` threads at ``registers`` registers a thread
    and ``smem`` bytes of shared memory that one SM holds at once: the
    least of what shared memory, threads and registers allow (the
    CUDA occupancy calculator's rule)."""
    if not math.isfinite(smem):
        return 0
    by_smem = SMEM_PER_SM // (int(smem) + SMEM_RESERVED_PER_BLOCK)
    warps = -(-threads // 32)
    per_warp = -(-registers // 8) * 8 * 32
    by_regs = 4 * (REGS_PER_PARTITION // per_warp) // warps
    return max(0, min(by_smem, THREADS_PER_SM // threads, BLOCKS_PER_SM,
                      by_regs))


def _waves(blocks: Expr, resident: ExprLike) -> Tuple[Expr, Expr]:
    """(waves, slot factor) of a grid of ``blocks`` blocks at ``resident``
    blocks an SM: the scheduler spreads blocks over the SMs first, so an SM
    holds at most ceil(blocks / SMS) of them; the slot factor is the slots
    the waves hold over the blocks that fill them (1 for full waves)."""
    per_sm = Min(as_expr(resident), CeilDiv(blocks, Const(SMS)))
    waves = CeilDiv(blocks, SMS * per_sm)
    return waves, waves * SMS * per_sm / blocks


#: warps each of an SM's four schedulers needs resident to hide the latency
#: of the FP32 pipes' shared-memory operand reads
HIDING_WARPS = 4


def _unhidden(threads: int, resident: ExprLike) -> Expr:
    """How far the operand reads of blocks of ``threads`` threads at
    ``resident`` blocks an SM stretch: 1 where every scheduler holds
    ``HIDING_WARPS`` warps, else the warps it lacks over those it holds
    (one 8-warp block an SM leaves each scheduler 2 warps: 2)."""
    per_scheduler = as_expr(resident) * (-(-threads // 32) / 4)
    return Max(Const(1.0), Const(HIDING_WARPS) / per_scheduler)


def _grid_keys(waves: Expr, steps: ExprLike, syncs: ExprLike
               ) -> Dict[str, ExprLike]:
    return {props.BARRIER: waves * as_expr(steps) * as_expr(syncs),
            props.GROUPS: waves, props.CONST1: 1.0}


def _need_resident(variant, resident) -> None:
    if variant is not None and resident is None:
        raise ValueError(f"the CUDA kernel {variant!r} is priced by the "
                         f"blocks an SM holds: pass resident=")


def matmul_vector(M: ExprLike, N: ExprLike, K: ExprLike, *,
                  block_m: ExprLike = 128, block_n: ExprLike = 128,
                  block_k: ExprLike = 128, bits: int = 32,
                  variant: Optional[str] = None,
                  resident: Optional[ExprLike] = None
                  ) -> Dict[str, ExprLike]:
    """(M,K)@(K,N) tiled matmul: (bm×bk)+(bk×bn) tiles stream HBM→VMEM per
    grid cell, fp32 (bm×bn) accumulator carried across the sequential k
    walk.  ``variant`` (``paper16``, ``fma128``, ``wgmma``): the CUDA
    kernel running the tile (bm, bn, bk) at ``resident`` blocks an SM; its
    products count ``mxu:16`` on ``wgmma``, ``mxu:32`` otherwise, the
    tiles keep the input's bits, and on the FP32 pipes each product's
    operands come from shared memory (``local:32``, by the thread's output
    tile ``matmul.THREAD_TILE``); a block walks K in steps of bk."""
    M, N, K = as_expr(M), as_expr(N), as_expr(K)
    bm, bn, bk = as_expr(block_m), as_expr(block_n), as_expr(block_k)
    n_m, n_n, n_k = CeilDiv(M, bm), CeilDiv(N, bn), CeilDiv(K, bk)
    cells = n_m * n_n * n_k
    local = cells * (bm * bk + bk * bn + bm * bn)
    if variant is None:
        return {
            props.local_key(bits): local,
            props.BARRIER: cells,
            props.GROUPS: n_m * n_n,
            props.mxu_key(bits): 2 * cells * bm * bn * bk,
            props.CONST1: 1.0,
        }
    from repro_torch.kernels import matmul as mm
    _need_resident(variant, resident)
    waves, slots = _waves(n_m * n_n, resident)
    macs = cells * bm * bn * bk
    out = {props.local_key(bits): local,
           props.mxu_key(_pipe_bits(variant, bits)): 2 * macs * slots,
           **_grid_keys(waves, n_k, mm.SYNCS_PER_STEP)}
    if variant in mm.THREAD_TILE:
        tm, tn = mm.THREAD_TILE[variant]
        key = props.local_key(32)
        out[key] = as_expr(out.get(key, 0)) + macs * ((tm + tn) / (tm * tn))
    return out


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
                           bits: int = 16, variant: Optional[str] = None,
                           resident: Optional[ExprLike] = None
                           ) -> Dict[str, ExprLike]:
    """Online-softmax attention: q/k/v tiles stream per executed pair; the
    (bq×bk) logit tile never leaves VMEM; fully-masked pairs are skipped
    (but their grid steps still barrier).  ``variant`` (``wgmma``, the bf16
    kernel; ``fma``, the f32 one): the CUDA kernel running the tile
    (bq, bk) at ``resident`` blocks an SM, whose pipe sets the bits of
    every key.  A block owns a q tile and walks its key tiles (the longest
    walk, the last q tile's, paces a wave); on the FP32 pipes each product
    reads its operands from shared memory, by the thread's register tile
    (16 x 16 threads: bq/16 x bk/16 logits, bq/16 x dh/16 outputs),
    stretched where the blocks an SM holds leave their latency unhidden
    (``_unhidden``)."""
    bits = _pipe_bits(variant, bits)
    bq, bk = as_expr(block_q), as_expr(block_k)
    n_q, n_k = CeilDiv(as_expr(Sq), bq), CeilDiv(as_expr(Skv), bk)
    cells = as_expr(B_) * as_expr(H) * n_q * n_k
    execd = _fa_exec_blocks(n_q, n_k, causal=causal, window=window,
                            block_q=bq, block_k=bk)
    exec_cells = as_expr(B_) * as_expr(H) * execd
    local = exec_cells * (bq * as_expr(dh) + 2 * bk * as_expr(dh))
    mxu = 4 * exec_cells * bq * bk * as_expr(dh)
    if variant is None:
        return {
            props.local_key(bits): local,
            props.BARRIER: cells,
            props.GROUPS: cells,
            props.mxu_key(bits): mxu,
            props.CONST1: 1.0,
        }
    from repro_torch.kernels import flash_attention as fa
    _need_resident(variant, resident)
    waves, slots = _waves(as_expr(B_) * as_expr(H) * n_q, resident)
    steps = n_k if window is None else \
        Min(n_k, CeilDiv(Const(window), bk) + 1)
    if variant != "wgmma":
        dhp = fa.padded_head_dim(int(dh))
        reads = exec_cells * 16 * ((bq + bk) * dhp + bk * (bq + dhp))
        local = local + reads * _unhidden(fa.F32_THREADS, resident)
    return {props.local_key(bits): local,
            props.mxu_key(bits): mxu * slots,
            **_grid_keys(waves, steps, fa.SYNCS_PER_TILE)}


def ssd_scan_vector(Bz: ExprLike, H: ExprLike, L: ExprLike, P: ExprLike,
                    N: ExprLike, *, chunk: ExprLike = 128, bits: int = 16,
                    variant: Optional[str] = None,
                    p_block: Optional[ExprLike] = None,
                    resident: Optional[ExprLike] = None,
                    backward: bool = False) -> Dict[str, ExprLike]:
    """Chunked SSD: per (batch, head, chunk) cell the x/B/C blocks move
    HBM→VMEM and the (P×N) state stays VMEM-resident.  Intra-chunk work is
    quadratic in the chunk; the state update is paid once per chunk — the
    block-size tradeoff the tuner balances.  ``variant`` (``wgmma``;
    ``fma``, the FP32 kernel, which holds everything in f32): the CUDA
    kernel running the chunk at ``resident`` blocks an SM, whose pipe sets
    the bits of every key; a block owns a (batch, head, P slice) and walks
    the chunks.  ``p_block``: the P slice one CUDA thread block owns; each
    slice is a cell of its own, which recomputes the chunk's C·Bᵀ (None,
    or a slice that holds all of P: the reference's cells).

    The products are the kernels' own: ``wgmma`` skips the 64 x 64 tiles
    of C·Bᵀ and W above the diagonal; the FP32 kernel builds W a strip of
    32 rows at a time in blocks of 64 columns, over the state padded to
    16/32/64/128, each product's operands read from shared memory (a thread
    owns 2 x 4 or 4 x 4 outputs: 0.75 reads a product, 0.5 in the state
    update).

    ``backward``: the call runs under autograd, so the chunk also sets the
    backward's recompute: the plain chunked version, forward and backward,
    dispatched operator by operator on the host (``const1`` each,
    ``ssd_scan.RECOMPUTE_DISPATCHES_PER_CHUNK`` a chunk), its products
    three times the reference's count in f32 (``mxu:32``)."""
    bits = _pipe_bits(variant, bits)
    Q = as_expr(chunk)
    nc = CeilDiv(as_expr(L), Q)
    blocks = as_expr(Bz) * as_expr(H)
    Pc = as_expr(P)
    if p_block is not None:
        blocks = blocks * CeilDiv(Pc, as_expr(p_block))
        Pc = Min(Pc, as_expr(p_block))
    cells = blocks * nc
    N_ = as_expr(N)
    local = cells * (Q * Pc + 2 * Q * N_ + Pc * N_)
    if variant is None:
        mxu = cells * 2 * (Q * Q * N_           # C·Bᵀ
                           + Q * Q * Pc         # W·x (intra)
                           + Q * Pc * N_ * 2)   # inter + state
        return {
            props.local_key(bits): local,
            props.BARRIER: cells,
            props.GROUPS: cells,
            props.mxu_key(bits): mxu,
            props.CONST1: 1.0,
        }
    from repro_torch.kernels import ssd_scan as ssd
    _need_resident(variant, resident)
    waves, slots = _waves(blocks, resident)
    if variant == "wgmma":
        tri = (Q + 64) / (2 * Q)      # 64 x 64 tiles on and below the diagonal
        prod = tri * Q * Q * (N_ + Pc) + 2 * Q * Pc * N_
        syncs: ExprLike = ssd.WGMMA_SYNCS_PER_CHUNK
    else:
        NP = ssd._padded_state(int(N))
        strips, m = CeilDiv(Q, Const(32)), CeilDiv(Q, Const(64))
        col_blocks = m * (m + 1) - (2 * m - strips) * m   # Σ ⌈rows/64⌉
        cb = 32 * 64 * NP * col_blocks
        wx = 512 * Pc * strips * (strips + 1)
        ch = 32 * strips * NP * Pc
        st = Q * NP * Pc
        prod = cb + wx + ch + st
        local = local + cells * (0.75 * (cb + wx + ch) + 0.5 * st)
        syncs = ssd.fma_syncs_per_chunk(Q)
    out = {props.local_key(bits): local,
           props.mxu_key(bits): 2 * cells * prod * slots,
           **_grid_keys(waves, nc, syncs)}
    if backward:
        rows = as_expr(Bz) * as_expr(H) * nc
        P_, key = as_expr(P), props.mxu_key(32)
        recompute = 3 * 2 * rows * (Q * Q * N_ + Q * Q * P_ + 2 * Q * P_ * N_)
        out[key] = as_expr(out.get(key, 0)) + recompute
        out[props.CONST1] = 1.0 + nc * ssd.RECOMPUTE_DISPATCHES_PER_CHUNK
    return out


def transpose_vector(M: ExprLike, N: ExprLike, *, block: ExprLike = 256,
                     bits: int = 32, variant: Optional[str] = None,
                     resident: Optional[ExprLike] = None
                     ) -> Dict[str, ExprLike]:
    """VMEM-tile relayout: each (b×b) tile passes through VMEM twice
    (stream in, stream out) so both HBM directions stay stride-1.
    ``variant`` (``vec16``, ``scalar``): the CUDA kernel running the edge
    ``block`` at ``resident`` blocks an SM, one barrier a block; it also
    counts its stride-1 accesses to device memory, each direction M·N
    elements in accesses of 16 bytes (``vec16``) or one element
    (``scalar``): the keys count accesses, and the card pays an access,
    not a byte, where a kernel is short of bytes in flight."""
    b = as_expr(block)
    bm, bn = Min(b, as_expr(M)), Min(b, as_expr(N))
    cells = CeilDiv(as_expr(M), bm) * CeilDiv(as_expr(N), bn)
    if variant is None:
        return {
            props.local_key(bits): cells * 2 * bm * bn,
            props.BARRIER: cells,
            props.GROUPS: cells,
            props.CONST1: 1.0,
        }
    _need_resident(variant, resident)
    waves, _ = _waves(cells, resident)
    per_access = 128 // bits if variant == "vec16" else 1
    accesses = as_expr(M) * as_expr(N) * (1.0 / per_access)
    return {props.local_key(bits): cells * 2 * bm * bn,
            props.mem_key("load", bits, "s1"): accesses,
            props.mem_key("store", bits, "s1"): accesses,
            **_grid_keys(waves, 1, 1)}


# ---------------------------------------------------------------------------
# Kernel registries — shape/block parameter spaces + on-chip footprints
# ---------------------------------------------------------------------------

#: the reference's budget, a v5e core's VMEM and the share it leaves the
#: kernel: ``PALLAS_KERNELS`` only
VMEM_BYTES = 16 * 2 ** 20
VMEM_BUDGET = 0.75


def _pow2_divisors(n: int, lo: int, hi: int) -> List[int]:
    out, b = [], lo
    while b <= min(n, hi):
        if n % b == 0:
            out.append(b)
        b *= 2
    return out or [min(n, hi)]


def _no_variant(shape, blocks) -> None:
    return None


@dataclass(frozen=True)
class KernelModel:
    """One kernel family: symbolic vector builder + its config space."""
    name: str
    shape_params: Tuple[str, ...]
    block_params: Tuple[str, ...]
    #: (shape, blocks, variant) -> Dict[str, ExprLike]; entries of either
    #: mapping may be symcount Exprs, so one builder serves sweeps and step
    #: composition
    builder: Callable[..., Dict[str, ExprLike]]
    #: shape -> list of concrete candidate block dicts (before the budget)
    candidates: Callable[[Mapping[str, int]], List[Dict[str, int]]]
    #: (shape, blocks) -> bytes of on-chip memory of one block / grid cell
    footprint: Callable[[Mapping[str, int], Mapping[str, int]], float]
    #: the most ``footprint`` may be
    budget: float
    #: (shape, blocks) -> the kernel that runs the blocks (a variant name of
    #: the CUDA source), or None where one schedule serves every candidate
    variant: Callable[[Mapping[str, int], Mapping[str, int]],
                      Optional[str]] = _no_variant
    #: which schedule the counts describe: "cuda" or "pallas"
    schedule: str = "cuda"

    def vector(self, shape: Mapping[str, ExprLike],
               blocks: Mapping[str, ExprLike],
               variant: Optional[str] = None) -> Dict[str, ExprLike]:
        return self.builder(shape, blocks, variant)

    def symbolic_blocks(self) -> Dict[str, Var]:
        return {b: Var(b) for b in self.block_params}


def _bits(shape, default: int) -> int:
    return int(shape.get("bits", default))


# --- the reference's Pallas registry (parity tests) ------------------------


def _mm_builder(shape, blocks, variant=None):
    return matmul_vector(shape["M"], shape["N"], shape["K"],
                         block_m=blocks["block_m"], block_n=blocks["block_n"],
                         block_k=blocks["block_k"], bits=_bits(shape, 32),
                         variant=variant, resident=blocks.get("resident"))


def _mm_candidates(shape):
    return [{"block_m": bm, "block_n": bn, "block_k": bk}
            for bm in _pow2_divisors(int(shape["M"]), 32, 512)
            for bn in _pow2_divisors(int(shape["N"]), 32, 512)
            for bk in _pow2_divisors(int(shape["K"]), 32, 512)]


def _mm_vmem(shape, blocks):
    by = _bits(shape, 32) // 8
    bm, bn, bk = blocks["block_m"], blocks["block_n"], blocks["block_k"]
    return (bm * bk + bk * bn) * by + bm * bn * (4 + by)  # tiles + f32 acc


def _fa_builder(shape, blocks, variant=None):
    return flash_attention_vector(
        shape["B"], shape["H"], shape["KVH"], shape["Sq"], shape["Skv"],
        shape["dh"], causal=bool(shape.get("causal", True)),
        window=shape.get("window"), block_q=blocks["block_q"],
        block_k=blocks["block_k"], bits=_bits(shape, 16), variant=variant,
        resident=blocks.get("resident"))


def _fa_candidates(shape):
    return [{"block_q": bq, "block_k": bk}
            for bq in _pow2_divisors(int(shape["Sq"]), 32, 512)
            for bk in _pow2_divisors(int(shape["Skv"]), 32, 512)]


def _fa_vmem(shape, blocks):
    by = _bits(shape, 16) // 8
    dh = int(shape["dh"])
    bq, bk = blocks["block_q"], blocks["block_k"]
    # q/k/v tiles + (m, l, acc) f32 scratch + the (bq×bk) logit tile
    return ((bq + 2 * bk) * dh * by + (2 * bq + bq * dh) * 4
            + bq * bk * 4)


def _ssd_builder(shape, blocks, variant=None):
    return ssd_scan_vector(shape["Bz"], shape["H"], shape["L"], shape["P"],
                           shape["N"], chunk=blocks["chunk"],
                           bits=_bits(shape, 16), variant=variant,
                           p_block=blocks.get("p_block"),
                           resident=blocks.get("resident"),
                           backward=bool(shape.get("grad", False)))


def _ssd_candidates(shape):
    return [{"chunk": c} for c in _pow2_divisors(int(shape["L"]), 16, 256)]


def _ssd_vmem(shape, blocks):
    by = _bits(shape, 16) // 8
    P, N = int(shape["P"]), int(shape["N"])
    Q = blocks["chunk"]
    # x/dt/B/C tiles + f32 state + the three (Q×Q) f32 intermediates
    return (Q * (P + 2 * N + 1) * by + P * N * 4 + 3 * Q * Q * 4)


def _tr_builder(shape, blocks, variant=None):
    return transpose_vector(shape["M"], shape["N"], block=blocks["block"],
                            bits=_bits(shape, 32), variant=variant,
                            resident=blocks.get("resident"))


def _tr_candidates(shape):
    M, N = int(shape["M"]), int(shape["N"])
    blocks = sorted(set(_pow2_divisors(M, 32, 512))
                    & set(_pow2_divisors(N, 32, 512))) \
        or sorted(set(_pow2_divisors(M, 32, 512))
                  | set(_pow2_divisors(N, 32, 512)))
    return [{"block": b} for b in blocks]


def _tr_vmem(shape, blocks):
    by = _bits(shape, 32) // 8
    b = blocks["block"]
    return 2 * b * b * by


_PALLAS_BUDGET = VMEM_BYTES * VMEM_BUDGET

PALLAS_KERNELS: Dict[str, KernelModel] = {
    "matmul": KernelModel(
        "matmul", ("M", "N", "K"), ("block_m", "block_n", "block_k"),
        _mm_builder, _mm_candidates, _mm_vmem, _PALLAS_BUDGET,
        schedule="pallas"),
    "flash_attention": KernelModel(
        "flash_attention", ("B", "H", "KVH", "Sq", "Skv", "dh"),
        ("block_q", "block_k"), _fa_builder, _fa_candidates, _fa_vmem,
        _PALLAS_BUDGET, schedule="pallas"),
    "ssd_scan": KernelModel(
        "ssd_scan", ("Bz", "H", "L", "P", "N"), ("chunk",),
        _ssd_builder, _ssd_candidates, _ssd_vmem, _PALLAS_BUDGET,
        schedule="pallas"),
    "transpose": KernelModel(
        "transpose", ("M", "N"), ("block",),
        _tr_builder, _tr_candidates, _tr_vmem, _PALLAS_BUDGET,
        schedule="pallas"),
}


# --- the CUDA registry: the tiles the sources build ------------------------
#
# A candidate is the tile a kernel executes, written as the request that
# the wrapper of ``kernels/ops.py`` hands on and the CUDA source serves with
# that same tile, with what the source derives from it: ``resident``, the
# blocks of that kernel one SM holds (``resident_blocks`` of the kernel
# modules' ``block_resources`` mirrors and the block's shared memory), and
# for the SSD scan the P slice.  ``ops`` reads only the request.  Layout
# facts the sources read beside the shape are optional shape entries,
# defaulting to contiguous rows at an aligned base: ``va``/``vb`` (matmul:
# A / B readable 16 bytes at a time), ``tma`` (ssd_scan: x, B, C bf16 and
# readable by TMA), ``grad`` (ssd_scan: the call runs under autograd),
# ``aligned`` (transpose: a 16-byte base and leading stride).


def _mm_layout(shape):
    by = _bits(shape, 32) // 8
    K, N = int(shape["K"]), int(shape["N"])
    return (bool(shape.get("va", K * by % 16 == 0)),
            bool(shape.get("vb", N * by % 16 == 0)))


def _mm_tile(shape, blocks):
    from repro_torch.kernels import matmul as mm
    va, vb = _mm_layout(shape)
    return mm.tile_rule(int(shape["M"]), int(shape["N"]),
                        int(blocks["block_m"]), int(blocks["block_n"]),
                        int(blocks["block_k"]), bf16=_bits(shape, 32) == 16,
                        va=va, vb=vb)


def _mm_resident(shape, t) -> int:
    from repro_torch.kernels import matmul as mm
    va, vb = _mm_layout(shape)
    threads, regs = mm.block_resources(t.variant, bf16=_bits(shape, 32) == 16,
                                       va=va, vb=vb)
    return resident_blocks(threads, regs, t.smem)


def _mm_cuda_candidates(shape):
    """The tiles a request of the paper's 16³ and of the 128 tile get:
    ``paper16`` and, by type and layout, ``fma128`` or ``wgmma``."""
    out = {}
    for req in (16, 128):
        t = _mm_tile(shape, {"block_m": req, "block_n": req, "block_k": req})
        out.setdefault((t.bm, t.bn, t.bk),
                       {"block_m": t.bm, "block_n": t.bn, "block_k": t.bk,
                        "resident": _mm_resident(shape, t)})
    return list(out.values())


def _fa_cuda_candidates(shape):
    """bf16: the one tile of the tensor-core kernel (``tile_rule``); f32:
    every tile ``pick_tiles`` serves a request of ``TILES``² with."""
    from repro_torch.kernels import flash_attention as fa
    dh, bits = int(shape["dh"]), _bits(shape, 16)
    if bits == 16:
        tiles = [fa.tile_rule(dh)[:2]]
    else:
        tiles = list(dict.fromkeys(fa.pick_tiles(q, k, dh)
                                   for q in fa.TILES for k in fa.TILES))
    out = []
    for bq, bk in tiles:
        blocks = {"block_q": bq, "block_k": bk}
        threads, regs = fa.block_resources(bits, bq, bk, dh)
        blocks["resident"] = resident_blocks(threads, regs,
                                             _fa_cuda_smem(shape, blocks))
        out.append(blocks)
    return out


def _fa_cuda_variant(shape, blocks):
    return "wgmma" if _bits(shape, 16) == 16 else "fma"


def _fa_cuda_smem(shape, blocks):
    from repro_torch.kernels import flash_attention as fa
    dh = int(shape["dh"])
    if _bits(shape, 16) == 16:
        return fa.tile_rule(dh)[3]
    return fa.smem_bytes(blocks["block_q"], blocks["block_k"], dh)


def _ssd_cuda_candidates(shape):
    """The chunks of the reference's grid, each with the P slice its
    kernel takes (``tile_rule``; 0 where the kernel takes no tile)."""
    from repro_torch.kernels import ssd_scan as ssd
    out = []
    for c in _ssd_candidates(shape):
        t = _ssd_cuda_tile(shape, c)
        resident = 0
        if math.isfinite(t.smem):
            chunk = min(int(c["chunk"]), int(shape["L"]))
            resident = resident_blocks(*ssd.block_resources(
                t.variant, chunk, int(shape["N"]), t.p_block), t.smem)
        out.append({"chunk": c["chunk"], "p_block": t.p_block,
                    "resident": resident})
    return out


def _ssd_cuda_variant(shape, blocks):
    from repro_torch.kernels import ssd_scan as ssd
    P, N = int(shape["P"]), int(shape["N"])
    tma = shape.get("tma", _bits(shape, 16) == 16 and P % 8 == 0
                    and N % 8 == 0)
    return ssd.variant_rule(P, N, min(int(blocks["chunk"]), int(shape["L"])),
                            bool(tma))


def _ssd_cuda_tile(shape, blocks):
    """The tile ``ssd_scan_tile`` reports for the chunk, or one of infinite
    shared memory where the kernel takes no tile (N above 128, say: the
    wrapper raises on the card)."""
    from repro_torch.kernels import ssd_scan as ssd
    variant = _ssd_cuda_variant(shape, blocks)
    try:
        return ssd.tile_rule(int(shape["P"]), int(shape["N"]),
                             min(int(blocks["chunk"]), int(shape["L"])),
                             variant)
    except ValueError:
        return ssd.Tile(variant, 0, 0, math.inf)


def _tr_dtype(shape):
    import torch
    return torch.bfloat16 if _bits(shape, 32) == 16 else torch.float32


def _tr_cuda_candidates(shape):
    from repro_torch.kernels import transpose as tr
    out = []
    for b in tr.EDGES:
        t = tr.tile_rule(b, _tr_dtype(shape),
                         _tr_cuda_variant(shape, {"block": b}))
        regs = tr.REGISTERS[(t.variant, _tr_dtype(shape))]
        out.append({"block": b,
                    "resident": resident_blocks(t.threads, regs, t.smem)})
    return out


def _tr_cuda_variant(shape, blocks):
    from repro_torch.kernels import transpose as tr
    return tr.variant_rule(_tr_dtype(shape), int(shape["M"]),
                           int(shape["N"]), int(blocks["block"]),
                           bool(shape.get("aligned", True)))


def _tr_cuda_smem(shape, blocks):
    from repro_torch.kernels import transpose as tr
    return tr.tile_rule(int(blocks["block"]), _tr_dtype(shape),
                        _tr_cuda_variant(shape, blocks)).smem


KERNELS: Dict[str, KernelModel] = {
    "matmul": KernelModel(
        "matmul", ("M", "N", "K"),
        ("block_m", "block_n", "block_k", "resident"),
        _mm_builder, _mm_cuda_candidates,
        lambda shape, blocks: _mm_tile(shape, blocks).smem, SMEM_LIMIT,
        lambda shape, blocks: _mm_tile(shape, blocks).variant),
    "flash_attention": KernelModel(
        "flash_attention", ("B", "H", "KVH", "Sq", "Skv", "dh"),
        ("block_q", "block_k", "resident"), _fa_builder, _fa_cuda_candidates,
        _fa_cuda_smem, SMEM_LIMIT, _fa_cuda_variant),
    "ssd_scan": KernelModel(
        "ssd_scan", ("Bz", "H", "L", "P", "N"), ("chunk", "p_block",
                                                 "resident"),
        _ssd_builder, _ssd_cuda_candidates,
        lambda shape, blocks: _ssd_cuda_tile(shape, blocks).smem, SMEM_LIMIT,
        _ssd_cuda_variant),
    "transpose": KernelModel(
        "transpose", ("M", "N"), ("block", "resident"),
        _tr_builder, _tr_cuda_candidates, _tr_cuda_smem, SMEM_LIMIT,
        _tr_cuda_variant),
}


def get(kernel, kernels: Optional[Mapping[str, KernelModel]] = None
        ) -> KernelModel:
    """``kernel`` itself if it is a ``KernelModel``, else its entry in
    ``kernels`` (default ``KERNELS``, the CUDA registry)."""
    if isinstance(kernel, KernelModel):
        return kernel
    kernels = KERNELS if kernels is None else kernels
    try:
        return kernels[kernel]
    except KeyError:
        raise KeyError(f"unknown kernel {kernel!r}; "
                       f"known: {sorted(kernels)}") from None


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


def _is_cuda(kernels) -> bool:
    return all(km.schedule == "cuda"
               for km in (KERNELS if kernels is None else kernels).values())


def step_kernel_blocks(cfg, workload="train", kernels=None
                       ) -> Optional[Dict[str, Dict[str, int]]]:
    """The tiles the card's main paths launch for one step of ``cfg``
    under ``workload``: ``block_sizes="auto"`` of the attention and SSD
    wrappers (``kernels/ops.py``) at the step's shapes on one device, scored
    through the card's model (``ops.CARD_MODEL``, as ``ops.default_model``
    names it for a CUDA tensor): the bf16 attention's one tile, the f32
    attention's pick, the SSD chunk ``ssm_apply`` resolves.  None for the
    reference's registry (its composition takes the default blocks)."""
    if not _is_cuda(kernels):
        return None
    from repro_torch.core import workload as wl
    from repro_torch.kernels import autotune
    from repro_torch.kernels.ops import CARD_MODEL
    spec = wl.as_spec(workload, _stacklevel=4)
    if spec.phase == "decode":
        return {}
    shapes = autotune.workload_kernel_shapes(cfg, spec)
    if "ssd_scan" in shapes:    # a train step's SSD runs under autograd
        shapes["ssd_scan"]["grad"] = spec.phase == "train"
    return {k: autotune.best_block_sizes(get(k, kernels), shapes[k],
                                         CARD_MODEL)
            for k in ("flash_attention", "ssd_scan") if k in shapes}


def step_kernel_vectors(cfg, workload="train", kernels=None
                        ) -> Dict[str, Dict[str, ExprLike]]:
    """Per-kernel symbolic property vectors for ONE pass of ``cfg`` for any
    ``workload`` (``repro_torch.core.workload.WorkloadLike``; bare phase
    strings are the deprecated legacy form and warn), as the card runs it
    (``kernels`` None or ``KERNELS``) or as the reference's Pallas blocks
    count it (``PALLAS_KERNELS``).

    Returns ``{kernel_name: property_vector}`` with the same free variables
    as ``archcount`` (B, S — plus AS/SL/MI when a decode spec sets the
    corresponding refinement).  The composition mirrors
    ``archcount._layer_macs`` contraction-for-contraction, so the mxu totals
    agree in the leading term.

    On the card: the projections, FFN and LM head run as library GEMMs
    (``torch.matmul``), counted as their products, ``mxu`` at the compute
    type's bits, with no tile and no shared-memory traffic of the port's
    own; the attention and the SSD scan are the CUDA kernels at the tiles
    ``step_kernel_blocks`` resolves, with their shared-memory (``local:``)
    traffic.  Under ``PALLAS_KERNELS``: the reference's composition, every
    contraction a Pallas kernel at its default 128-wide blocks with its
    VMEM (``local:``) traffic.  Contractions with no kernel (MoE dispatch
    einsum, the SSM short conv) stay as archcount's closed forms
    (``unkernelized``).

    Decode emits the per-token dense matmuls only (projections, FFN, LM
    head, token dim = occupied slots × speculative length): the
    cache-streaming attention / recurrent-state update of a decode step
    launches no kernel, so those counts stay with
    ``archcount.decode_counts``.
    """
    from repro_torch.core import archcount  # late import: archcount is heavier
    from repro_torch.core import workload as wl
    spec = wl.as_spec(workload, _stacklevel=4)
    picks = step_kernel_blocks(cfg, spec, kernels)
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
        pv = {props.mxu_key(bits): 2 * as_expr(m) * n * k} \
            if picks is not None else matmul_vector(m, n, k, bits=bits)
        mm_pv = add_vectors(mm_pv, scale_vector(pv, mult))
    out["matmul"] = mm_pv

    if n_attn and not decode:
        kw = {}
        if picks is not None:
            fa = get("flash_attention", kernels)
            blocks = picks["flash_attention"]
            kw = dict(block_q=blocks["block_q"], block_k=blocks["block_k"],
                      resident=blocks["resident"],
                      variant=fa.variant({"bits": bits}, blocks))
        out["flash_attention"] = scale_vector(
            flash_attention_vector(B, cfg.n_heads, cfg.n_kv_heads, S, S,
                                   cfg.head_dim_, causal=True,
                                   window=cfg.sliding_window, bits=bits,
                                   **kw),
            float(n_attn))
    if n_ssm and not decode:
        s = cfg.ssm
        kw = dict(chunk=s.chunk)
        if picks is not None:
            blocks = picks["ssd_scan"]
            vshape = {"P": s.head_dim, "N": s.d_state, "L": blocks["chunk"],
                      "bits": bits}
            kw = dict(chunk=blocks["chunk"], p_block=blocks["p_block"],
                      resident=blocks["resident"],
                      variant=get("ssd_scan", kernels).variant(vshape,
                                                               blocks))
        out["ssd_scan"] = scale_vector(
            ssd_scan_vector(B, cfg.ssm_heads, S, s.head_dim, s.d_state,
                            bits=bits, **kw),
            float(n_ssm))

    # contractions with no kernel: keep their archcount-style MAC closed
    # forms so the kernel-composed mxu total replaces the step count
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


def step_compute_vector(cfg, workload="train", kernels=None
                        ) -> Dict[str, ExprLike]:
    """The summed compute-side (mxu + on-chip ``local``) vector of one
    forward pass, built from the per-kernel vectors of
    ``step_kernel_vectors`` (the card's CUDA schedule, or the reference's
    Pallas blocks with ``kernels=PALLAS_KERNELS``).  barrier/groups/const1
    stay at STEP granularity (archcount's), not per-launch — a fitted
    per-launch barrier weight does not add up across thousands of fused
    launches.

    Entries are CANONICALIZED (``exprops.simplify``): the layer-by-layer
    composition piles up dozens of structurally repeated addends (every
    projection matmul contributes the same CeilDiv tiles), and collapsing
    them here shrinks both the per-property compiled closures and the
    fused basis programs built downstream."""
    from repro_torch.core import exprops
    from repro_torch.core import workload as wl
    total = add_vectors(
        *step_kernel_vectors(cfg, wl.as_spec(workload, _stacklevel=4),
                             kernels).values())
    keep = ("mxu:", "local:")
    return {k: exprops.simplify(v) for k, v in total.items()
            if k.startswith(keep)}
