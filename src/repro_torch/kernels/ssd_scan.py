"""Mamba2 SSD (state-space duality) scan: the wrapper of the hand-written
CUDA kernels, and their plain version.

Replaces the TPU kernel ``repro.kernels.ssd_scan.ssd_scan`` (Pallas,
``_kernel``).  The CUDA source is ``csrc/ssd_scan.cu``; it is compiled at the
first call on a CUDA tensor (``_build.load``) and bound with ``ctypes``.

Per (batch, head, chunk of Q steps)::

    cum   = cumsum(dt·A)
    W     = (C Bᵀ) ⊙ tril(exp(cum_i − cum_j)) ⊙ dt_j
    y     = W x + (C ⊙ exp(cum)) h_prevᵀ
    h_new = exp(cum_Q) h_prev + (B ⊙ dt ⊙ exp(cum_Q − cum))ᵀ x

with the (P, N) f32 state carried across chunks.  In both kernels one thread
block owns a (b, h, P slice) and walks the chunks with the state on the chip,
so the state never goes back to device memory between chunks; B and C are
read at group ``h // (H/G)``, never repeated.

What bounds it on an H100: bytes at the shapes of the serving paths (x in and
y out dominate; the operations, 2·(Q²N + Q²P + 2QPN) per (b, h, chunk), take
less time on the bf16 tensor cores).  ``pick_variant`` chooses the kernel
before the launch, from types, shapes, strides and bases alone:

* ``"wgmma"`` (``ssd_wgmma_kernel``): x, B and C all bf16, chunk 64, 128
  or 256, P and N multiples of 16 up to 128, and each of x, B, C readable
  by TMA (a 16-byte-aligned base, the last dimension contiguous, the other
  strides multiples of 16 bytes).  The serving and training paths of
  zamba2-2.7b and mamba2-370m hand over exactly that.  Its four products
  run on the bf16 tensor cores with f32 accumulators, fed by a TMA ring of
  chunk stages; the f32 intermediates W, h and x·w_end enter the products
  as hi + lo bf16 pairs, so it rounds nothing the f32 plain version does
  not.  A P slice of 64 per block; the state in registers.  A chunk of 256
  is walked as two halves of 128 rows by the chunk-128 instance
  (``wgmma_rows``): the chunked recurrence is exact for any chunk.
* ``"fma"`` (``ssd_fwd_kernel``): everything else (f32, mixed types, other
  chunks, layouts TMA cannot read).  All arithmetic in f32 on the FP32
  pipes, which alone take about ten times the byte bound; the state in
  shared memory.

See the note at the top of the CUDA source.  ``tile`` and ``tile_for``
report the variant, P slice, ring stages and shared memory of a launch.

The backward (``ssd_scan_backward``, ``csrc/ssd_scan_bwd.cu``): four
kernels whatever L, walking steps of ``BACKWARD_STEP`` rows whatever
chunk the forward ran (the steps' own state terms; a pass over the steps
for h at each step's start and dh at its end; each step's gradients,
with C Bᵀ, W and dS kept on chip; the sums of dB, dC over a group's
heads and of dA, in a fixed order), every product on the tensor cores
in TF32 with each f32 operand as a hi + lo pair.  ``backward_path``
decides before the launch which inputs it takes (bf16 x, B, C; the rest
keeps the recompute of ``ssd_scan_reference`` under autograd);
``ssd_scan_backward_reference`` is its arithmetic in plain PyTorch.

Accepted shapes: x ``(Bz, H, L, P)``, dt ``(Bz, H, L)`` f32, A ``(H,)`` f32,
B and C ``(Bz, G, L, N)`` with ``H % G == 0``; ``chunk`` (clipped to L, as in
the reference) must divide L.  The kernels take chunks up to 256, N up to 128,
P and N multiples of 4; x and B/C each f32 or bf16.  The last dimension of x,
B and C must be contiguous and every row 16-byte aligned; the other
dimensions may be strided (``(B, L, H, P)`` views of the conv output, viewed
as ``(B, H, L, P)``, are taken as they are).  y has x's type and x's dimension
order (``torch.empty_like``), h_final is ``(Bz, H, P, N)`` f32.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import SMEM_LIMIT, tma_layout_error
from repro_torch.runtime import flags

NEG_INF = -1e30

#: the longest chunk the kernel takes
MAX_CHUNK = 256

#: the kernels of the CUDA source, by the number it takes them by
VARIANTS = ("fma", "wgmma")
#: chunks the tensor-core kernel takes
WGMMA_CHUNKS = (64, 128, 256)
#: the most chunk rows an instance of the tensor-core kernel walks at a time
WGMMA_ROWS = 128

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 15 + [ctypes.c_int] * 3
             + [ctypes.c_void_p])


def ssd_scan_reference(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor, *,
                       chunk: int = 128
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the chunked math of the Pallas body in the
    kernel's layout, f32, vectorised over (batch, head), a loop over chunks.
    It is also the model's plain path, the counterpart of the reference's
    ``_ssd_chunked`` (which forms ``C Bᵀ`` in the input type; here, as in
    the kernels, it is f32).

    -> (y (Bz,H,L,P) in x's type, h_final (Bz,H,P,N) f32)."""
    Bz, H, L, P = x.shape
    G, N = B.shape[1], B.shape[3]
    rep = H // G
    chunk = min(chunk, L)
    if L % chunk:
        raise ValueError(f"L={L} is not a multiple of chunk={chunk}")
    Af = A.float()[None, :, None]
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()
    h = torch.zeros((Bz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, L, chunk):
        sl = slice(c0, c0 + chunk)
        xq = x[:, :, sl].float()                               # (Bz,H,Q,P)
        dtq = dt[:, :, sl].float()                             # (Bz,H,Q)
        Bq = B[:, :, sl].float().repeat_interleave(rep, dim=1)  # (Bz,H,Q,N)
        Cq = C[:, :, sl].float().repeat_interleave(rep, dim=1)
        cum = torch.cumsum(dtq * Af, dim=-1)
        # mask the exponent, not the product: above the diagonal the
        # difference is positive and exp would overflow
        diff = torch.where(tri, cum[..., :, None] - cum[..., None, :],
                           torch.full_like(cum[..., None], NEG_INF))
        W = (Cq @ Bq.transpose(-1, -2)) * torch.exp(diff) \
            * dtq[..., None, :]
        y = W @ xq + (Cq * torch.exp(cum)[..., None]) @ h.transpose(-1, -2)
        decay_end = torch.exp(cum[..., -1:] - cum)
        h = h * torch.exp(cum[..., -1])[..., None, None] \
            + xq.transpose(-1, -2) @ (Bq * (dtq * decay_end)[..., None])
        ys.append(y)
    return torch.cat(ys, dim=2).to(x.dtype), h


class Tile(NamedTuple):
    variant: str      # "wgmma" or "fma"
    p_block: int      # the P slice one thread block owns
    stages: int       # chunk stages of the TMA ring (1: no ring)
    smem: int         # bytes of shared memory of one block


def tma_readable(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                 bases: Optional[Sequence[int]] = None) -> bool:
    """x, B and C all bf16 and each readable by TMA (see the module's
    note).  ``bases``: the byte addresses of x, B, C (default their
    ``data_ptr()``; for meta tensors the storage offset in bytes)."""
    if any(t.dtype != torch.bfloat16 for t in (x, B, C)):
        return False
    if bases is None:
        bases = [t.data_ptr() for t in (x, B, C)]
    return not any(tma_layout_error(n, t.shape, t.stride(), base, t.dtype)
                   for n, t, base in zip("xBC", (x, B, C), bases))


def variant_rule(P: int, N: int, chunk: int, tma: bool) -> str:
    """``pick_variant`` on what it reads: the head width P, the state width
    N, the chunk after clipping to L, and whether x, B, C are bf16 and
    readable by TMA (``tma_readable``)."""
    if not tma or chunk not in WGMMA_CHUNKS \
            or P % 16 or P > 128 or N % 16 or N > 128:
        return "fma"
    return "wgmma"


def wgmma_rows(chunk: int) -> int:
    """The chunk rows of the ``ssd_wgmma_kernel`` instance that runs
    ``chunk``, its step through L: the chunk itself, or halves of 128 for
    256 (``wg_rows`` in the CUDA source)."""
    return min(chunk, WGMMA_ROWS)


def pick_variant(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                 chunk: int, bases: Optional[Sequence[int]] = None) -> str:
    """The kernel a call goes to, from types, shapes, strides and base
    addresses alone (see the module's note).  ``chunk`` is the chunk after
    clipping to L.  ``bases``: the byte addresses of x, B, C (default their
    ``data_ptr()``; for meta tensors the storage offset in bytes)."""
    P, N = x.shape[3], B.shape[3]
    if variant_rule(P, N, chunk, True) == "fma":
        return "fma"   # decided without reading the layouts
    return variant_rule(P, N, chunk, tma_readable(x, B, C, bases))


#: the CUDA source's constants (csrc/ssd_scan.cu): the W strip of the FP32
#: kernel, the P slice and tile rows (bytes) of the tensor-core kernel
_STRIP, _WG_P_BLOCK, _WG_ROW = 32, 64, 128


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def _padded_state(N: int) -> int:
    return 16 if N <= 16 else (32 if N <= 32 else (64 if N <= 64 else 128))


def _fma_smem(chunk: int, N: int, p_block: int) -> int:
    qa, npad = _round_up(chunk, 64), _padded_state(N)
    return 4 * (qa * (npad + 4) + qa * p_block + _STRIP * (npad + 4)
                + _STRIP * (qa + 4) + npad * p_block + 4 * qa + 32)


def _wgmma_smem(chunk: int, N: int, stages: int) -> int:
    chunk = wgmma_rows(chunk)                    # the instance's stage rows
    halves = 1 if N <= 64 else 2                 # 64-column halves of N
    stage = chunk * _WG_ROW + 2 * halves * chunk * _WG_ROW
    h_bytes = halves * _WG_P_BLOCK * _WG_ROW
    return 1024 + stages * (stage + 3 * chunk * 4) + 2 * h_bytes + 16 * stages


def tile_rule(P: int, N: int, chunk: int, variant: str = "fma") -> Tile:
    """``tile`` as a pure function: the tile ``ssd_scan_tile`` reports for
    (P, N, chunk), without building anything; raises ``ValueError`` for a
    shape the variant does not take.  ``chip_smoke.py`` holds it against
    the C query."""
    if variant == "wgmma":
        if variant_rule(P, N, chunk, True) != "wgmma":
            raise ValueError(f"the wgmma kernel takes no tile for P={P}, "
                             f"N={N}, chunk={chunk}")
        stages = 3 if _wgmma_smem(chunk, N, 3) <= SMEM_LIMIT else 2
        return Tile("wgmma", _WG_P_BLOCK, stages,
                    _wgmma_smem(chunk, N, stages))
    if variant != "fma" or not (0 < chunk <= MAX_CHUNK and 0 < N <= 128
                                and P > 0 and N % 4 == 0 and P % 4 == 0):
        raise ValueError(f"the {variant} kernel takes no tile for P={P}, "
                         f"N={N}, chunk={chunk}")
    pb = 16 if P <= 16 else (32 if P <= 32 else 64)
    while _fma_smem(chunk, N, pb) > SMEM_LIMIT:
        if pb == 16:
            raise ValueError(f"no P slice fits shared memory at N={N}, "
                             f"chunk={chunk}")
        pb //= 2
    return Tile("fma", pb, 1, _fma_smem(chunk, N, pb))


#: what a block of each kernel holds besides shared memory: threads, and
#: registers a thread as ``nvcc -Xptxas -v`` reports them for this source
#: (CUDA 12.9, sm_90a): the FP32 kernel's instances by (padded N, P slice),
#: the tensor-core kernel's by (chunk rows of the instance, ``wgmma_rows``;
#: padded N), its threads by those rows (a consumer warpgroup per 64 rows
#: and a producer warp, or warpgroup at 128).
#: ``chip_smoke.py`` holds them against the build's report,
#: ``tests/test_torch_gpu.py`` the blocks an SM holds against the CUDA
#: occupancy calculator.
FMA_THREADS = 256
FMA_REGISTERS = {(128, 64): 128, (128, 32): 128, (128, 16): 128,
                 (64, 64): 128, (64, 32): 128, (64, 16): 128,
                 (32, 64): 128, (32, 32): 128, (32, 16): 128,
                 (16, 64): 106, (16, 32): 128, (16, 16): 128}
WGMMA_THREADS = {64: 160, 128: 384}
WGMMA_REGISTERS = {(64, 128): 191, (64, 64): 153, (128, 128): 168,
                   (128, 64): 168}
#: block-wide waits of one chunk on the critical path: the tensor-core
#: consumers' stage ``mbarrier`` and the named barrier over h; the FP32
#: kernel's ``__syncthreads``, three a chunk and three a strip of 32 rows
WGMMA_SYNCS_PER_CHUNK = 2


def fma_syncs_per_chunk(chunk):
    """The FP32 kernel's ``__syncthreads`` of one chunk (an int or a
    ``symcount`` expression of the chunk)."""
    if isinstance(chunk, int):
        return 3 + 3 * -(-chunk // _STRIP)
    from repro_torch.core.symcount import CeilDiv, as_expr
    return 3 + 3 * CeilDiv(as_expr(chunk), as_expr(_STRIP))


def fma_memory_waits_per_chunk(chunk):
    """Those of the FP32 kernel's ``__syncthreads`` of one chunk that wait
    on a round trip to device memory (its tiles are loaded with nothing
    prefetched): after dt, B and x, once a chunk, and after C, once a strip
    of 32 rows."""
    if isinstance(chunk, int):
        return 1 + -(-chunk // _STRIP)
    from repro_torch.core.symcount import CeilDiv, as_expr
    return 1 + CeilDiv(as_expr(chunk), as_expr(_STRIP))


#: the operators one chunk of the plain version dispatches forward and
#: backward: the cost, chunk by chunk, of the backward's plain path, which
#: recomputes ``ssd_scan_reference`` under autograd at the chunk the forward
#: ran (``models/ssm._SSDScan``, for the inputs ``backward_path`` does not
#: send to the backward kernels); ``tests/test_torch_ssm.py`` counts them
#: (each chunk past the first, PyTorch 2.13 on meta tensors)
RECOMPUTE_DISPATCHES_PER_CHUNK = 175

#: the rows the backward kernels (csrc/ssd_scan_bwd.cu, ``kT``) walk a step,
#: whatever chunk the forward ran: the chunked recurrence is exact for any
#: chunk
BACKWARD_STEP = 64
#: the kernels one ``ssd_scan_backward`` call launches, whatever L: the steps'
#: own state terms, the pass over the steps, the gradients of each step, the
#: sums over heads
BACKWARD_LAUNCHES = 4


def block_resources(variant: str, chunk: int, N: int,
                    p_block: int) -> Tuple[int, int]:
    """(threads, registers a thread) of the block that runs ``variant`` at
    (chunk, N, P slice)."""
    if variant == "wgmma":
        rows = wgmma_rows(chunk)
        return (WGMMA_THREADS[rows],
                WGMMA_REGISTERS[(rows, 64 if N <= 64 else 128)])
    return FMA_THREADS, FMA_REGISTERS[(_padded_state(N), p_block)]


def schedule_props(Bz: int, H: int, L: int, P: int, N: int, *,
                   chunk: int = 128, bits: int = 16,
                   tma: Optional[bool] = None) -> dict:
    """Schedule-derived properties (the reference's ``schedule_props``,
    ``src/repro/kernels/ssd_scan.py:125``: per (batch, head, chunk) cell the
    x/B/C blocks move on chip and the (P, N) state stays there) at the
    chunk the call runs (clipped to L), counted on the kernel that runs it:
    ``wgmma`` (bf16 ``mxu:16`` and ``local:16``; a cell per chunk rows its
    instance walks, ``wgmma_rows``: two halves of 128 at chunk 256) or the
    FP32 kernel (``mxu:32``, ``local:32``: it holds everything in f32), a
    cell per P slice of a thread block (``tile_rule``; each recomputes
    C·Bᵀ).
    ``tma``: x, B, C bf16 and readable by TMA (default: ``bits == 16`` with
    P and N multiples of 8, contiguous).  Where the kernel computes in the
    input's type and one slice holds all of P, this is the reference's
    vector."""
    from repro_torch.core import properties as props
    chunk = min(chunk, L)
    if tma is None:
        tma = bits == 16 and P % 8 == 0 and N % 8 == 0
    t = tile_rule(P, N, chunk, variant_rule(P, N, chunk, tma))
    kbits = 16 if t.variant == "wgmma" else 32
    if t.variant == "wgmma":
        chunk = wgmma_rows(chunk)
    Pc = min(P, t.p_block)
    cells = Bz * H * -(-L // chunk) * -(-P // t.p_block)
    local = cells * (chunk * Pc + 2 * chunk * N + Pc * N)
    mxu = cells * 2.0 * (chunk * chunk * N      # CB
                         + chunk * chunk * Pc   # y_intra
                         + chunk * Pc * N * 2)  # y_inter + state update
    return {
        props.local_key(kbits): float(local),
        props.BARRIER: float(cells),
        props.GROUPS: float(cells),
        props.mxu_key(kbits): mxu,
    }


def tile(P: int, N: int, chunk: int, variant: str = "fma") -> Tile:
    """The tile ``variant`` launches for (P, N, chunk), as the CUDA source
    sets it.  Builds the source if need be; needs ``nvcc``."""
    fn = _build.load("ssd_scan").ssd_scan_tile
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 2 \
            + [ctypes.POINTER(ctypes.c_longlong)]
        fn.restype = ctypes.c_int
    pb, stages, nbytes = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    if fn(P, N, chunk, VARIANTS.index(variant), ctypes.byref(pb),
          ctypes.byref(stages), ctypes.byref(nbytes)) != 0:
        raise ValueError(f"the {variant} kernel takes no tile for P={P}, "
                         f"N={N}, chunk={chunk}")
    return Tile(variant, pb.value, stages.value, nbytes.value)


def tile_for(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
             chunk: int) -> Tile:
    """The tile of the launch ``ssd_scan(x, dt, A, B, C, chunk=chunk)``
    makes."""
    chunk = min(int(chunk), x.shape[2])
    return tile(x.shape[3], B.shape[3], chunk, pick_variant(x, B, C, chunk))


def _check(x, dt, A, B, C) -> None:
    if x.ndim != 4 or dt.ndim != 3 or A.ndim != 1 or B.ndim != 4 \
            or C.ndim != 4:
        raise ValueError("expected x (Bz,H,L,P), dt (Bz,H,L), A (H,), "
                         "B and C (Bz,G,L,N)")
    Bz, H, L, P = x.shape
    G, N = B.shape[1], B.shape[3]
    if tuple(dt.shape) != (Bz, H, L) or tuple(A.shape) != (H,) \
            or tuple(B.shape) != (Bz, G, L, N) or C.shape != B.shape:
        raise ValueError(
            f"shapes disagree: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
            f"A {tuple(A.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)}")
    if min(Bz, H, L, P, G, N) < 1 or H % G:
        raise ValueError(f"H={H} is not a multiple of G={G}, or a dimension "
                         "is empty")
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
    if B.dtype != C.dtype:
        raise TypeError(f"B and C must share a dtype: {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32, got {dt.dtype}, "
                        f"{A.dtype}")
    if len({t.device for t in (x, dt, A, B, C)}) != 1:
        raise ValueError("x, dt, A, B, C lie on different devices")


def _rows_of_4(t: torch.Tensor, base: int) -> bool:
    """The last dimension contiguous, and every row aligned to 4 elements
    (the kernels move 4 elements at a time: 16 bytes of f32, 8 of bf16).
    ``base``: the byte address of the first element."""
    return t.stride(-1) == 1 and not any(s % 4 for s in t.stride()[:-1]) \
        and base % (4 * t.element_size()) == 0


def _check_layout(name: str, t: torch.Tensor) -> None:
    if not _rows_of_4(t, t.data_ptr()):
        raise ValueError(
            f"{name}: the last dimension must be contiguous and every row "
            f"aligned to 4 elements; got strides {t.stride()}")


def _priced(x, dt, A, B, C, chunk: int):
    """A call on fake tensors under ``flags.price_kernels`` (the dry run:
    no data, nothing to launch): the kernel is priced, not run.  Its
    products are
    ``schedule_props``' for the kernel ``variant_rule`` names at this
    chunk, its bytes x, dt, A, B, C read once and y, h written once; the
    outputs are stand-ins of their shapes."""
    from repro_torch.core import extract
    from repro_torch.core import properties as props
    Bz, H, L, P = x.shape
    N = B.shape[3]
    bits = 16 if x.dtype == torch.bfloat16 else 32
    vec = schedule_props(Bz, H, L, P, N, chunk=chunk, bits=bits,
                         tma=bits == 16 and P % 8 == 0 and N % 8 == 0)
    flops = sum(v for key, v in vec.items() if key.startswith("mxu:"))
    y = torch.empty_like(x)
    h = x.new_empty((Bz, H, P, N), dtype=torch.float32)
    extract.price_kernel("ssd_scan", flops, (x, dt, A, B, C), (y, h))
    return y, h


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (Bz,H,L,P), dt (Bz,H,L), A (H,), B/C (Bz,G,L,N) -> (y, h_final).

    A CUDA tensor goes through the kernel ``pick_variant`` names, or the call
    raises.  The plain version is taken only for tensors that lie on the
    CPU, and under ``flags.use_kernels(False)`` (for comparisons).  Under
    ``flags.price_kernels`` fake tensors are priced (``_priced``)."""
    _check(x, dt, A, B, C)
    Bz, H, L, P = x.shape
    G, N = B.shape[1], B.shape[3]
    chunk = min(int(chunk), L)
    if chunk < 1 or L % chunk:
        raise ValueError(f"L={L} is not a multiple of chunk={chunk}")
    if flags.kernels_priced() and flags.kernels_enabled() and is_fake(x):
        return _priced(x, dt, A, B, C, chunk)
    if x.device.type == "cpu" or not flags.kernels_enabled():
        return ssd_scan_reference(x, dt, A, B, C, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B, C)):
        raise NotImplementedError(
            "the SSD-scan kernel is differentiated only through "
            "repro_torch.models.ssm._SSDScan (its backward runs "
            "ssd_scan_backward or recomputes the plain chunked math); call "
            "the kernel directly under torch.no_grad()")
    if chunk > MAX_CHUNK:
        raise ValueError(f"chunk {chunk} > {MAX_CHUNK} is not supported by "
                         "the kernel")
    if N > 128 or N % 4 or P % 4:
        raise ValueError(f"P and N must be multiples of 4, N at most 128; "
                         f"got P={P}, N={N}")
    y = torch.empty_like(x)  # x's dimension order: (B, L, H, P) in memory
    h = torch.empty((Bz, H, P, N), dtype=torch.float32, device=x.device)
    A = A.contiguous()
    variant = pick_variant(x, B, C, chunk)
    if variant == "fma":
        for name, t in (("x", x), ("B", B), ("C", C), ("y", y)):
            _check_layout(name, t)

    fn = _build.load("ssd_scan").ssd_scan_forward
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                 C.data_ptr(), y.data_ptr(), h.data_ptr(),
                 Bz, H, G, L, P, N, chunk,
                 *x.stride()[:3], *dt.stride(), *B.stride()[:3],
                 *C.stride()[:3], *y.stride()[:3],
                 int(x.dtype == torch.bfloat16),
                 int(B.dtype == torch.bfloat16), VARIANTS.index(variant),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"ssd_scan_forward: CUDA error {err} at launch of the {variant} "
            f"kernel (x {tuple(x.shape)}, B {tuple(B.shape)}, chunk {chunk})")
    ssd_scan.launches += 1
    return y, h


#: how many times the kernel was launched (and only that: the plain version
#: does not count)
ssd_scan.launches = 0


# ---------------------------------------------------------------------------
# the backward (csrc/ssd_scan_bwd.cu)

_BWD_ARGTYPES = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 6
                 + [ctypes.c_longlong] * 18 + [ctypes.c_void_p])


def backward_rule(P: int, N: int, L: int, bf16: bool) -> str:
    """``backward_path`` on what it reads of the shapes and types: the
    backward kernels (``"kernel"``) take x, B and C in bf16 with dt and A
    in f32, P and N multiples of 16 up to 128 and L a multiple of
    ``BACKWARD_STEP``; everything else keeps the recompute of
    ``ssd_scan_reference`` (``"plain"``)."""
    if not bf16 or P % 16 or N % 16 or not 0 < P <= 128 \
            or not 0 < N <= 128 or L % BACKWARD_STEP:
        return "plain"
    return "kernel"


def backward_path(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor,
                  bases: Optional[Sequence[int]] = None) -> str:
    """Where ``models/ssm._SSDScan``'s backward goes for these inputs, from
    devices, types, shapes, strides and base addresses alone, before any
    launch: ``"kernel"`` (``ssd_scan_backward``) or ``"plain"`` (the
    recompute of ``ssd_scan_reference`` under autograd).  CPU tensors and
    ``flags.use_kernels(False)`` are plain; so are the inputs
    ``backward_rule`` refuses, and x, B or C with a row not aligned to 4
    elements.  ``bases``: the byte addresses of x, B, C (default their
    ``data_ptr()``; for meta tensors the storage offset in bytes)."""
    if x.device.type == "cpu" or not flags.kernels_enabled():
        return "plain"
    bf16 = all(t.dtype == torch.bfloat16 for t in (x, B, C)) \
        and dt.dtype == torch.float32 and A.dtype == torch.float32
    if backward_rule(x.shape[3], B.shape[3], x.shape[2], bf16) == "plain":
        return "plain"
    if bases is None:
        bases = [t.data_ptr() for t in (x, B, C)]
    if not all(_rows_of_4(t, base) for t, base in zip((x, B, C), bases)):
        return "plain"
    return "kernel"


def ssd_scan_backward_reference(x: torch.Tensor, dt: torch.Tensor,
                                A: torch.Tensor, B: torch.Tensor,
                                C: torch.Tensor, dy: torch.Tensor, *,
                                step: int = BACKWARD_STEP
                                ) -> Tuple[torch.Tensor, ...]:
    """The backward kernels' arithmetic in plain PyTorch, f32, vectorised
    over (batch, head, step): per step of ``step`` rows the step's own state
    terms, the pass over the steps for h at each step's start and dh at its
    end, then each step's gradients from them (see the note at the top of
    ``csrc/ssd_scan_bwd.cu``).  Equals ``torch.autograd.grad`` through
    ``ssd_scan_reference`` up to rounding.

    -> (dx, ddt, dA, dB, dC), each f32."""
    Bz, H, L, P = x.shape
    G, N = B.shape[1], B.shape[3]
    rep, T = H // G, step
    nc = L // T
    xs = x.float().reshape(Bz, H, nc, T, P)
    dys = dy.float().reshape(Bz, H, nc, T, P)
    Bs = B.float().repeat_interleave(rep, 1).reshape(Bz, H, nc, T, N)
    Cs = C.float().repeat_interleave(rep, 1).reshape(Bz, H, nc, T, N)
    dts = dt.float().reshape(Bz, H, nc, T)
    Af = A.float()[None, :, None, None]
    cum = torch.cumsum(dts * Af, -1)
    cend = cum[..., -1:]
    decay = torch.exp(cend)                                   # (Bz,H,nc,1)
    wx = torch.exp(cend - cum)
    w, ecum = dts * wx, torch.exp(cum)
    s = (xs * w[..., None]).transpose(-1, -2) @ Bs            # (…,P,N)
    u = (dys * ecum[..., None]).transpose(-1, -2) @ Cs
    hs, dhs = [], []
    hv = dv = torch.zeros_like(s[:, :, 0])
    for c in range(nc):
        hs.append(hv)
        hv = decay[:, :, c, :, None] * hv + s[:, :, c]
    for c in reversed(range(nc)):
        dhs.append(dv)
        dv = decay[:, :, c, :, None] * dv + u[:, :, c]
    h, dh = torch.stack(hs, 2), torch.stack(dhs[::-1], 2)
    tri = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    diff = torch.where(tri, cum[..., :, None] - cum[..., None, :],
                       torch.full_like(cum[..., None], NEG_INF))
    dec = torch.exp(diff)
    S = Cs @ Bs.transpose(-1, -2)
    dW = dys @ xs.transpose(-1, -2)
    W = S * dec * dts[..., None, :]
    dS = dW * dec * dts[..., None, :]
    Hm = dW * S * dec
    xdh, dyh = xs @ dh, dys @ h
    dx = W.transpose(-1, -2) @ dys + w[..., None] * (Bs @ dh.transpose(-1, -2))
    dC = dS @ Bs + ecum[..., None] * dyh
    dB = dS.transpose(-1, -2) @ Cs + w[..., None] * xdh
    dw = (xdh * Bs).sum(-1)
    colH = Hm.sum(-2)
    dcum = (Hm * dts[..., None, :]).sum(-1) - dts * colH \
        + ecum * (dyh * Cs).sum(-1) - w * dw
    dcum[..., -1] += (w * dw).sum(-1) + decay[..., 0] * (dh * h).sum((-1, -2))
    da = dcum.flip(-1).cumsum(-1).flip(-1)
    ddt = da * Af + colH + dw * wx
    return (dx.reshape(Bz, H, L, P), ddt.reshape(Bz, H, L),
            (da * dts).sum((0, 2, 3)),
            dB.reshape(Bz, G, rep, L, N).sum(2),
            dC.reshape(Bz, G, rep, L, N).sum(2))


def ssd_scan_backward(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                      B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor
                      ) -> Tuple[torch.Tensor, ...]:
    """The gradients of ``ssd_scan``'s y at ``dy`` on the backward kernels:
    x (Bz,H,L,P), dt (Bz,H,L), A (H,), B/C (Bz,G,L,N), dy like x ->
    (dx in x's type and dimension order, ddt (Bz,H,L) f32, dA (H,) f32,
    dB and dC (Bz,G,L,N) in B's type).  Takes only inputs
    ``backward_path`` sends to the kernels, else raises; a dy of another
    type or layout is copied to x's type, contiguous.  Four launches
    (``BACKWARD_LAUNCHES``) whatever L; f32 workspaces of
    2·Bz·H·(L/64)·P·N + 2·Bz·H·L·N elements live for the call."""
    _check(x, dt, A, B, C)
    if backward_path(x, dt, A, B, C) != "kernel":
        raise ValueError(
            f"the SSD backward kernels do not take these inputs (x "
            f"{tuple(x.shape)} {x.dtype}, B {tuple(B.shape)} {B.dtype}, "
            f"strides {x.stride()}, {B.stride()}); see backward_path")
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} is not x's shape "
                         f"{tuple(x.shape)}")
    if dy.dtype != x.dtype or not _rows_of_4(dy, dy.data_ptr()):
        dy = dy.to(x.dtype).contiguous()
    Bz, H, L, P = x.shape
    G, N = B.shape[1], B.shape[3]
    nc = L // BACKWARD_STEP
    f32, dev = torch.float32, x.device
    dx = torch.empty_like(x)
    ddt = torch.empty((Bz, H, L), dtype=f32, device=dev)
    dA = torch.empty((H,), dtype=f32, device=dev)
    dB = torch.empty((Bz, G, L, N), dtype=B.dtype, device=dev)
    dC = torch.empty_like(dB)
    states = torch.empty((Bz, H, nc, P, N), dtype=f32, device=dev)
    dstates = torch.empty_like(states)
    decay = torch.empty((Bz, H, nc), dtype=f32, device=dev)
    dA_part = torch.empty_like(decay)
    dB_part = torch.empty((Bz, H, L, N), dtype=f32, device=dev)
    dC_part = torch.empty_like(dB_part)
    A = A.contiguous()

    fn = _build.load("ssd_scan_bwd").ssd_scan_backward
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _BWD_ARGTYPES, ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(*(t.data_ptr() for t in (
                     x, dt, A, B, C, dy, dx, ddt, dA, dB, dC, states, dstates,
                     decay, dB_part, dC_part, dA_part)),
                 Bz, H, G, L, P, N, *x.stride()[:3], *dt.stride(),
                 *B.stride()[:3], *C.stride()[:3], *dy.stride()[:3],
                 *dx.stride()[:3],
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"ssd_scan_backward: CUDA error {err} at launch (x "
            f"{tuple(x.shape)}, B {tuple(B.shape)})")
    ssd_scan_backward.launches += BACKWARD_LAUNCHES
    return dx, ddt, dA, dB, dC


#: how many kernels the backward launched (and only that: the plain
#: recompute does not count)
ssd_scan_backward.launches = 0
