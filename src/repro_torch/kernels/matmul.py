"""Tiled matrix product: the wrapper of the hand-written CUDA kernels, and
their plain version.

Replaces the TPU kernel ``repro.kernels.matmul.matmul`` (Pallas,
``_kernel``), the paper's tiled *Matrix Multiplication* measurement kernel.
The CUDA source is ``csrc/matmul.cu``; it is compiled at the first call on a
CUDA tensor (``_build.load``) and bound with ``ctypes``.

What bounds it on an H100: operations.  f32 inputs must give IEEE f32
products (the reference's f32 tolerance rules out TF32), so the f32 bound is
``2·M·N·K`` operations on the FP32 pipes (67 TFLOP/s); bf16 runs on the
tensor cores (989 TFLOP/s).  The bytes, each input read once and the product
written once, take far less at the calibration's shapes.  One thread block
owns a tile of the product and walks K itself, the tiles of the coming k
steps in flight into a ring of shared-memory stages, its f32 sums in
registers — the loop inside the block that replaces the Pallas kernel's
VMEM accumulator carried over its "arbitrary" k axis.  Three kernels, which
the CUDA source chooses among (``tile`` and ``tile_for`` report the choice,
``VARIANTS`` names them):

* ``paper16``: the paper's 16×16×16 tile, one output per thread, one barrier
  per 16-deep k step (what ``mm_tiled`` and ``skinny_mm`` declare), fed by
  ``cp.async`` through a 4-stage ring with 16-byte shared reads;
* ``fma128``: a warp-tiled 128×128 tile on the FP32 pipes (8×8 outputs per
  thread), for f32 and for bf16 that TMA cannot read;
* ``wgmma``: bf16 on the tensor cores (``wgmma``), a 128×256 tile, A and B
  through a TMA ring, for bf16 whose base addresses are 16-byte aligned and
  whose leading strides are multiples of 8 elements.

A request nearer the 16 tile than the 128 tile (on a log scale, the block
first clipped to M and N) gets ``paper16``; see the note at the top of the
CUDA source.

Accepted: a ``(M, K)`` and b ``(K, N)``, any ``M, N, K >= 1`` (ragged edges
are masked by the kernels, a superset of the reference, which asserts that
the blocks divide the shape), both f32 or both bf16, each row-major (last
dimension contiguous, any leading stride and base address).  The product is
``(M, N)``, contiguous, in the inputs' type, summed in f32.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.runtime import flags

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
             + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 4
             + [ctypes.c_void_p])


def matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version: an f32 product cast back to a's type."""
    return (a.float() @ b.float()).to(a.dtype)


#: the kernels of the CUDA source, by the code ``matmul_tile`` reports
VARIANTS = ("paper16", "fma128", "wgmma")


class Tile(NamedTuple):
    """What one call launches: the tile (bm, bn, bk), the bytes of shared
    memory of one block, the kernel (one of ``VARIANTS``) and the stages of
    its ring."""
    bm: int
    bn: int
    bk: int
    smem: int
    variant: str
    stages: int


def tile(M: int, N: int, K: int, block_m: int = 128, block_n: int = 128,
         block_k: int = 128, *, dtype: torch.dtype = torch.float32,
         lda: Optional[int] = None, ldb: Optional[int] = None,
         a_ptr: int = 0, b_ptr: int = 0) -> Tile:
    """The kernel and tile a call launches, as the CUDA source chooses them,
    for inputs of type ``dtype`` with leading strides ``lda``/``ldb``
    (default: contiguous) at base addresses ``a_ptr``/``b_ptr`` (only their
    alignment matters).  Builds the source if need be; needs ``nvcc``."""
    fn = _build.load("matmul").matmul_tile
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 7 + [ctypes.c_ulonglong] * 2
                       + [ctypes.c_longlong] * 2
                       + [ctypes.POINTER(ctypes.c_int)] * 5
                       + [ctypes.POINTER(ctypes.c_longlong)])
        fn.restype = ctypes.c_int
    out = [ctypes.c_int() for _ in range(5)]
    smem = ctypes.c_longlong()
    lda = K if lda is None else lda
    ldb = N if ldb is None else ldb
    if fn(M, N, K, block_m, block_n, block_k, int(dtype == torch.bfloat16),
          a_ptr, b_ptr, lda, ldb, *(ctypes.byref(o) for o in out),
          ctypes.byref(smem)) != 0:
        raise ValueError(f"the kernel takes no tile for M={M}, N={N}, K={K}, "
                         f"blocks {block_m}x{block_n}x{block_k}, lda={lda}, "
                         f"ldb={ldb}")
    bm, bn, bk, stages, variant = (o.value for o in out)
    return Tile(bm, bn, bk, smem.value, VARIANTS[variant], stages)


#: shared memory, stages and k step of each kernel's block (csrc/matmul.cu:
#: ``Paper16``, ``Fma128``, ``WgTile``), by element bytes where it depends on
#: them
_PAPER16_STAGES, _BT_STRIDE = 4, 20
_FMA_AT_STRIDE = 128 + 4
_WGMMA_SMEM = 1024 + 4 * (128 * 64 * 2 + 2 * 2 * 64 * 64 * 2) + 8 * 2 * 4


def tile_rule(M: int, N: int, block_m: int = 128, block_n: int = 128,
              block_k: int = 128, *, bf16: bool = False, va: bool = True,
              vb: bool = True) -> Tile:
    """``tile`` as a pure function: the CUDA source's ``pick_tile`` and the
    shared memory ``matmul_tile`` reports, without building anything.
    ``va``/``vb``: A / B readable 16 bytes at a time (a 16-byte-aligned base
    and a leading stride of a multiple of 16 bytes); for bf16 both together
    are TMA's rule.  ``chip_smoke.py`` holds it against the C query."""
    by = 2 if bf16 else 4
    bm, bn = min(block_m, M), min(block_n, N)
    want = float(bm) * float(bn)  # compared with edge² on a log scale
    r16, r128 = 16.0 * 16.0 / want, 128.0 * 128.0 / want
    d16 = r16 if r16 >= 1.0 else 1.0 / r16
    d128 = r128 if r128 >= 1.0 else 1.0 / r128
    if d16 <= d128:
        return Tile(16, 16, 16, by * _PAPER16_STAGES * (16 * 16
                                                       + 16 * _BT_STRIDE),
                    "paper16", _PAPER16_STAGES)
    if bf16 and va and vb:
        return Tile(128, 256, 64, _WGMMA_SMEM, "wgmma", 4)
    bk, stages = (32, 3) if va else (16, 4)
    return Tile(128, 128, bk, by * stages * bk * (_FMA_AT_STRIDE + 128),
                "fma128", stages)


#: what a block of each kernel holds besides shared memory: threads, and
#: registers a thread as ``nvcc -Xptxas -v`` reports them for this source
#: (CUDA 12.9, sm_90a), by (variant, bf16, A read 16 bytes at a time, B
#: too; fma128's k step follows A's reads); ``chip_smoke.py`` holds them
#: against the build's report, ``tests/test_torch_gpu.py`` the blocks an SM
#: holds against the CUDA occupancy calculator.  ``THREAD_TILE``: the outputs one thread of
#: the FP32 kernels owns, rows x columns (each product reads rows + columns
#: operands from shared memory per step of k).
THREADS = {"paper16": 256, "fma128": 256, "wgmma": 384}
REGISTERS = {
    ("paper16", False, False): 44, ("paper16", False, True): 52,
    ("paper16", True, False): 32, ("paper16", True, True): 40,
    ("fma128", False, False, False): 165, ("fma128", False, False, True): 128,
    ("fma128", False, True, False): 185, ("fma128", False, True, True): 128,
    ("fma128", True, False, False): 162, ("fma128", True, False, True): 123,
    ("fma128", True, True, False): 160, ("fma128", True, True, True): 119,
    ("wgmma",): 168,
}
THREAD_TILE = {"paper16": (1, 1), "fma128": (8, 8)}
#: block-wide waits of one step of k on the critical path
SYNCS_PER_STEP = 1


def block_resources(variant: str, *, bf16: bool, va: bool,
                    vb: bool) -> Tuple[int, int]:
    """(threads, registers a thread) of the block ``variant`` launches for
    inputs of that type and layout (paper16 reads B element by element
    whatever its layout)."""
    key = ("wgmma",) if variant == "wgmma" else \
        (variant, bf16, va) if variant == "paper16" else \
        (variant, bf16, va, vb)
    return THREADS[variant], REGISTERS[key]


def schedule_props(M: int, N: int, K: int, *, block_m: int = 128,
                   block_n: int = 128, block_k: int = 128, bits: int = 32,
                   va: Optional[bool] = None,
                   vb: Optional[bool] = None) -> dict:
    """Schedule-derived property vector of one call (the reference's
    ``schedule_props``, ``src/repro/kernels/matmul.py:66``) at the tile the
    CUDA source serves the request with (``tile_rule``; ``va``/``vb``
    default to contiguous rows at an aligned base).  The products count
    ``mxu:16`` on ``wgmma``, ``mxu:32`` on the FP32 pipes (``paper16``,
    ``fma128``, bf16 too).  Where the tile is the request, this is the
    reference's vector."""
    from repro_torch.core import properties as props
    by = bits // 8
    va = K * by % 16 == 0 if va is None else va
    vb = N * by % 16 == 0 if vb is None else vb
    t = tile_rule(M, N, block_m, block_n, block_k, bf16=bits == 16, va=va,
                  vb=vb)
    n_m, n_n = -(-M // t.bm), -(-N // t.bn)
    cells = n_m * n_n * -(-K // t.bk)
    local = cells * (t.bm * t.bk + t.bk * t.bn + t.bm * t.bn)
    return {
        props.local_key(bits): float(local),
        props.BARRIER: float(cells),
        props.GROUPS: float(n_m * n_n),
        props.mxu_key(16 if t.variant == "wgmma" else 32): 2.0 * M * N * K,
    }


def tile_for(a: torch.Tensor, b: torch.Tensor, block_m: int = 128,
             block_n: int = 128, block_k: int = 128) -> Tile:
    """The kernel and tile ``matmul(a, b, ...)`` launches for these
    tensors."""
    _check(a, b)
    return tile(a.shape[0], b.shape[1], a.shape[1], block_m, block_n,
                block_k, dtype=a.dtype, lda=a.stride(0), ldb=b.stride(0),
                a_ptr=a.data_ptr(), b_ptr=b.data_ptr())


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"expected a (M, K) and b (K, N); got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dimensions disagree: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if min(a.shape[0], a.shape[1], b.shape[1]) < 1:
        raise ValueError("empty dimension")
    if a.dtype != b.dtype or a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"a and b must share a dtype, float32 or bfloat16; "
                        f"got {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError("a and b lie on different devices")


def matmul(a: torch.Tensor, b: torch.Tensor, *, block_m: int = 128,
           block_n: int = 128, block_k: int = 128) -> torch.Tensor:
    """(M, K) @ (K, N) with f32 sums, in the inputs' type.

    A CUDA tensor goes through the kernel, or the call raises.  The plain
    version is taken only for tensors that lie on the CPU, and under
    ``flags.use_kernels(False)`` (for comparisons)."""
    _check(a, b)
    if a.device.type == "cpu" or not flags.kernels_enabled():
        return matmul_reference(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        raise NotImplementedError(
            "the matmul kernel has no backward (the TPU kernel has none); "
            "call it under torch.no_grad()")
    if min(block_m, block_n, block_k) < 1:
        raise ValueError(f"blocks must be >= 1, got "
                         f"{block_m}x{block_n}x{block_k}")
    for name, t in (("a", a), ("b", b)):
        if t.stride(1) != 1 or t.stride(0) < t.shape[1]:
            raise ValueError(f"{name}: rows must be contiguous (row-major, "
                             f"any leading stride); got strides {t.stride()}")
    M, K = a.shape
    N = b.shape[1]
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)

    fn = _build.load("matmul").matmul_forward
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K,
                 a.stride(0), b.stride(0), c.stride(0),
                 block_m, block_n, block_k, int(a.dtype == torch.bfloat16),
                 torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"matmul_forward: CUDA error {err} at launch (a {tuple(a.shape)}, "
            f"b {tuple(b.shape)}, blocks {block_m}x{block_n}x{block_k})")
    matmul.launches += 1
    return c


#: how many times the kernel was launched (and only that: the plain version
#: does not count)
matmul.launches = 0
