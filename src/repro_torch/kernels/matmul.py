"""Tiled matrix product: the wrapper of the hand-written CUDA kernel, and its
plain version.

Replaces the TPU kernel ``repro.kernels.matmul.matmul`` (Pallas,
``_kernel``), the paper's tiled *Matrix Multiplication* measurement kernel.
The CUDA source is ``csrc/matmul.cu``; it is compiled at the first call on a
CUDA tensor (``_build.load``) and bound with ``ctypes``.

What bounds it on an H100: operations.  f32 inputs must give IEEE f32
products (the reference's f32 tolerance rules out TF32), so the bound is
``2·M·N·K`` operations on the FP32 pipes (67 TFLOP/s); the bytes, each input
read once and the product written once, take far less at the calibration's
shapes.  One thread block owns a tile of the product and walks K in steps,
with the A and B tiles staged in shared memory (double buffered, one barrier
per step) and the f32 sums in registers — the loop inside the block that
replaces the Pallas kernel's VMEM accumulator carried over its "arbitrary" k
axis.  The tiles built are 16×16×16 (the paper's kernel, one output per
thread), 64×64×16 and 128×128×32; the CUDA source serves each request with
the nearest (``tile`` reports which).  The 16³ tile reads both operands of
every multiply-add from shared memory and stays far below the bound; see the
note at the top of the CUDA source.

Accepted: a ``(M, K)`` and b ``(K, N)``, any ``M, N, K >= 1`` (ragged edges
are masked by the kernel, a superset of the reference, which asserts that
the blocks divide the shape), both f32 or both bf16, each row-major (last
dimension contiguous, any leading stride).  The product is ``(M, N)``,
contiguous, in the inputs' type, summed in f32.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.runtime import flags

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
             + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 4
             + [ctypes.c_void_p])


def matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version: an f32 product cast back to a's type."""
    return (a.float() @ b.float()).to(a.dtype)


def tile(M: int, N: int, K: int, block_m: int = 128, block_n: int = 128,
         block_k: int = 128) -> Tuple[int, int, int, int]:
    """The tile the kernel launches for this request, as the CUDA source
    chooses it: (BM, BN, BK, bytes of shared memory of one block).  The same
    for f32 and bf16 (the tiles are staged in f32).  Builds the source if
    need be; needs ``nvcc``."""
    fn = _build.load("matmul").matmul_tile
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)] * 3
                       + [ctypes.POINTER(ctypes.c_longlong)])
        fn.restype = ctypes.c_int
    bm, bn, bk = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    smem = ctypes.c_longlong()
    if fn(M, N, K, block_m, block_n, block_k, ctypes.byref(bm),
          ctypes.byref(bn), ctypes.byref(bk), ctypes.byref(smem)) != 0:
        raise ValueError(f"the kernel takes no tile for M={M}, N={N}, K={K}, "
                         f"blocks {block_m}x{block_n}x{block_k}")
    return bm.value, bn.value, bk.value, smem.value


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
