"""Tiled transpose: the wrapper of the hand-written CUDA kernels, and their
plain version.

Replaces the TPU kernel ``repro.kernels.transpose.transpose`` (Pallas,
``_kernel``), the prefetch variant of the paper's *Transpose* measurement
kernel.  The CUDA source is ``csrc/transpose.cu``; it is compiled at the
first call on a CUDA tensor (``_build.load``) and bound with ``ctypes``.

What bounds it on an H100: bytes — ``2·M·N`` elements cross device memory
and nothing is computed.  Each thread block passes a T×T tile through shared
memory, so that both the reads of X and the writes of Y are stride 1
(coalesced).  ``pick_variant`` chooses the kernel before the launch, from
type, shape, strides, base address and the requested ``block`` alone:

* ``"vec16"`` (``transpose_vec_kernel``): a request of the 16 tile (any
  ``block`` below 32), the base 16-byte aligned, and the leading stride, M
  and N multiples of one 16-byte access (4 f32 or 8 bf16 elements).  One
  block of 64 (f32) or 32 (bf16) threads per 16×16 tile, each thread one
  16-byte load and one 16-byte store, one barrier, a swizzled shared tile
  without bank conflicts.  The calibration's tiled transpose (n × n f32,
  ``block=16``) lands here.
* ``"scalar"`` (``transpose_kernel``): everything else.  One element a
  thread at the tile the request gets (16: 256 threads, the first design;
  32; 64 — the largest built tile not above the request, so the Pallas
  default 256 gets 64), any layout, any M, N >= 1.

``tile`` and ``tile_for`` report the variant, tile edge, threads and shared
memory of a launch, as the CUDA source sets them.

Accepted: x ``(M, N)``, any ``M, N >= 1`` (ragged edges are masked), f32 or
bf16, row-major (last dimension contiguous, any leading stride).  The result
is ``(N, M)``, contiguous, bit-for-bit equal to ``x.t()``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.runtime import flags

#: the kernels of the CUDA source, by the number it takes them by
VARIANTS = ("scalar", "vec16")
#: elements of one vec16 access (16 bytes), as the CUDA source's VecWidth
VEC_ELEMS = {torch.float32: 4, torch.bfloat16: 8}
#: the tile edges the CUDA source builds
EDGES = (16, 32, 64)

_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
             + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
             + [ctypes.c_void_p])


class Tile(NamedTuple):
    variant: str      # one of VARIANTS
    edge: int         # the tile's edge, 16, 32 or 64
    threads: int      # threads of one block
    smem: int         # bytes of shared memory of one block


def transpose_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain version: a contiguous copy of ``x.t()``."""
    return x.t().contiguous()


def pick_variant(x: torch.Tensor, block: int,
                 base: Optional[int] = None) -> str:
    """The kernel ``transpose(x, block=block)`` goes to, from type, shape,
    strides and base address alone (see the module's note).  ``base``: the
    byte address of x (default ``x.data_ptr()``; for meta tensors the
    storage offset in bytes)."""
    if base is None:
        base = x.storage_offset() * x.element_size() if x.is_meta \
            else x.data_ptr()
    M, N = x.shape
    return _pick(x.dtype, M, N, x.stride(0), base, block)


def _pick(dtype: torch.dtype, M: int, N: int, ld: int, base: int,
          block: int) -> str:
    """``pick_variant`` on values the caller has already read (the
    launch's own, so that choosing costs it no second look at x)."""
    v = VEC_ELEMS.get(dtype)
    return variant_rule(dtype, M, N, block,
                        v is not None and base % 16 == 0 and ld % v == 0)


def variant_rule(dtype: torch.dtype, M: int, N: int, block: int,
                 aligned: bool) -> str:
    """The variant of ``pick_variant`` from the type, shape and request,
    and ``aligned``: a 16-byte-aligned base and a leading stride of whole
    16-byte accesses."""
    v = VEC_ELEMS.get(dtype)
    if v is None or not aligned or block >= 32 or M % v or N % v:
        return "scalar"
    return "vec16"


def edge_rule(block: int) -> int:
    """The largest tile edge the CUDA source builds not above ``block`` (16
    at least): the edge a request is served with (``pick_tile`` in the
    source)."""
    return 64 if block >= 64 else (32 if block >= 32 else 16)


def tile_rule(block: int = 256, dtype: torch.dtype = torch.float32,
              variant: str = "scalar") -> Tile:
    """``tile`` as a pure function: what ``transpose_tile`` reports,
    without building anything; raises ``ValueError`` where it refuses.
    ``chip_smoke.py`` holds it against the C query."""
    edge = edge_rule(block)
    if block < 1 or dtype not in VEC_ELEMS or variant not in VARIANTS \
            or (variant == "vec16" and edge != 16):
        raise ValueError(f"the {variant} kernel takes no tile for "
                         f"block={block}, dtype {dtype}")
    nbytes = 16 // VEC_ELEMS[dtype]
    if variant == "vec16":
        return Tile(variant, 16, 16 * (16 // VEC_ELEMS[dtype]),
                    16 * 16 * nbytes)
    return Tile(variant, edge, 256, edge * (edge + 1) * nbytes)


def schedule_props(M: int, N: int, *, block: int = 256,
                   bits: int = 32) -> dict:
    """The reference's ``schedule_props``
    (``src/repro/kernels/transpose.py:42``) at the edge the CUDA source
    serves ``block`` with (``edge_rule``: 16, 32 or 64; ``vec16`` and
    ``scalar`` share the 16 edge).  Where the edge is the request, this is
    the reference's vector."""
    from repro_torch.core import properties as props
    e = edge_rule(block)
    cells = -(-M // e) * -(-N // e)
    return {
        props.local_key(bits): float(M * N),
        props.BARRIER: float(cells),
        props.GROUPS: float(cells),
    }


def tile(block: int = 256, dtype: torch.dtype = torch.float32,
         variant: str = "scalar") -> Tile:
    """The tile ``variant`` launches for a requested ``block``, as the CUDA
    source sets it.  Builds the source if need be; needs ``nvcc``."""
    fn = _build.load("transpose").transpose_tile
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2 \
            + [ctypes.POINTER(ctypes.c_longlong)]
        fn.restype = ctypes.c_int
    edge, threads, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    nbytes = torch.empty((), dtype=dtype).element_size()
    if variant not in VARIANTS or fn(
            block, nbytes, VARIANTS.index(variant), ctypes.byref(edge),
            ctypes.byref(threads), ctypes.byref(smem)) != 0:
        raise ValueError(f"the {variant} kernel takes no tile for "
                         f"block={block}, dtype {dtype}")
    return Tile(variant, edge.value, threads.value, smem.value)


def tile_for(x: torch.Tensor, block: int = 256) -> Tile:
    """The tile of the launch ``transpose(x, block=block)`` makes."""
    return tile(block, x.dtype, pick_variant(x, block))


_fns = {}


def _lib_fn(name: str, argtypes):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("transpose"), name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _fns[name] = fn
    return fn


def transpose(x: torch.Tensor, *, block: int = 256,
              variant: Optional[str] = None) -> torch.Tensor:
    """(M, N) -> (N, M), contiguous.

    A CUDA tensor goes through the kernel ``pick_variant`` names (or the one
    ``variant`` names, which the CUDA source refuses where the layout does
    not allow it), or the call raises.  The plain version is taken only for
    tensors that lie on the CPU, and under ``flags.use_kernels(False)`` (for
    comparisons)."""
    if x.ndim != 2 or min(x.shape) < 1:
        raise ValueError(f"expected a non-empty (M, N) tensor; got "
                         f"{tuple(x.shape)}")
    dtype, dev = x.dtype, x.device
    if dtype not in VEC_ELEMS:
        raise TypeError(f"x must be float32 or bfloat16; got {dtype}")
    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}; got {variant!r}")
    if dev.type == "cpu" or not flags.kernels_enabled():
        return transpose_reference(x)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if x.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "the transpose kernel has no backward (the TPU kernel has none); "
            "call it under torch.no_grad()")
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    M, N = x.shape
    ld, s1 = x.stride()
    if s1 != 1 or ld < N:
        raise ValueError(f"x: rows must be contiguous (row-major, any "
                         f"leading stride); got strides {(ld, s1)}")
    xp = x.data_ptr()
    variant = variant or _pick(dtype, M, N, ld, xp, block)
    y = torch.empty((N, M), dtype=dtype, device=dev)

    fn = _lib_fn("transpose_forward", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(xp, y.data_ptr(), M, N, ld, M, block, x.element_size(),
                 VARIANTS.index(variant),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"transpose_forward: CUDA error {err} at launch "
                           f"of {variant} (x {tuple(x.shape)}, strides "
                           f"{x.stride()}, block {block})")
    transpose.launches += 1
    return y


#: how many times a kernel was launched, any variant (and only that: the
#: plain version does not count)
transpose.launches = 0


def launch_empty(M: int, N: int, *, block: int = 16,
                 dtype: torch.dtype = torch.float32, variant: str = "vec16",
                 device: Optional[torch.device] = None) -> None:
    """Launch an empty kernel over the grid and block shape ``variant``
    launches for an (M, N) input: the floor that dispatching one block per
    tile sets (timed beside the kernel; counts no launch of it)."""
    fn = _lib_fn("transpose_empty", [ctypes.c_int] * 5 + [ctypes.c_void_p])
    nbytes = torch.empty((), dtype=dtype).element_size()
    err = fn(M, N, block, nbytes, VARIANTS.index(variant),
             torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"transpose_empty: CUDA error {err} at launch "
                           f"({variant}, {M}x{N}, block {block})")
