"""Tiled transpose: the wrapper of the hand-written CUDA kernel, and its plain
version.

Replaces the TPU kernel ``repro.kernels.transpose.transpose`` (Pallas,
``_kernel``), the prefetch variant of the paper's *Transpose* measurement
kernel.  The CUDA source is ``csrc/transpose.cu``; it is compiled at the
first call on a CUDA tensor (``_build.load``) and bound with ``ctypes``.

What bounds it on an H100: bytes — ``2·M·N`` elements cross device memory
and nothing is computed.  Each thread block passes a T×T tile through shared
memory, padded by one element per row against bank conflicts, so that both
the reads of X and the writes of Y are stride 1 (coalesced).  The Pallas
default ``block=256`` is a VMEM tile that would not fit a block's shared
memory; the tiles built are 16, 32 and 64: 16 is served exactly (one barrier
per 16×16 tile, as the measurement class declares), larger requests get the
largest built tile not above them (``tile`` reports which).

Accepted: x ``(M, N)``, any ``M, N >= 1`` (ragged edges are masked), f32 or
bf16, row-major (last dimension contiguous, any leading stride).  The result
is ``(N, M)``, contiguous, bit-for-bit equal to ``x.t()``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.runtime import flags

_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
             + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
             + [ctypes.c_void_p])


def transpose_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain version: a contiguous copy of ``x.t()``."""
    return x.t().contiguous()


def tile(block: int = 256, dtype: torch.dtype = torch.float32
         ) -> Tuple[int, int]:
    """The tile edge the kernel launches for a requested ``block``, as the
    CUDA source chooses it, and the bytes of shared memory of one block.
    Builds the source if need be; needs ``nvcc``."""
    fn = _build.load("transpose").transpose_tile
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int),
                                            ctypes.POINTER(ctypes.c_longlong)]
        fn.restype = ctypes.c_int
    edge, smem = ctypes.c_int(), ctypes.c_longlong()
    nbytes = torch.empty((), dtype=dtype).element_size()
    if fn(block, nbytes, ctypes.byref(edge), ctypes.byref(smem)) != 0:
        raise ValueError(f"the kernel takes no tile for block={block}, "
                         f"dtype {dtype}")
    return edge.value, smem.value


def transpose(x: torch.Tensor, *, block: int = 256) -> torch.Tensor:
    """(M, N) -> (N, M), contiguous.

    A CUDA tensor goes through the kernel, or the call raises.  The plain
    version is taken only for tensors that lie on the CPU, and under
    ``flags.use_kernels(False)`` (for comparisons)."""
    if x.ndim != 2 or min(x.shape) < 1:
        raise ValueError(f"expected a non-empty (M, N) tensor; got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16; got {x.dtype}")
    if x.device.type == "cpu" or not flags.kernels_enabled():
        return transpose_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            "the transpose kernel has no backward (the TPU kernel has none); "
            "call it under torch.no_grad()")
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    if x.stride(1) != 1 or x.stride(0) < x.shape[1]:
        raise ValueError(f"x: rows must be contiguous (row-major, any "
                         f"leading stride); got strides {x.stride()}")
    M, N = x.shape
    y = torch.empty((N, M), dtype=x.dtype, device=x.device)

    fn = _build.load("transpose").transpose_forward
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), y.data_ptr(), M, N, x.stride(0), y.stride(0),
                 block, x.element_size(),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"transpose_forward: CUDA error {err} at launch "
                           f"(x {tuple(x.shape)}, block {block})")
    transpose.launches += 1
    return y


#: how many times the kernel was launched (and only that: the plain version
#: does not count)
transpose.launches = 0
