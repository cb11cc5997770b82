"""Mamba2 SSD (state-space duality) scan: the wrapper of the hand-written
CUDA kernel, and its plain version.

Replaces the TPU kernel ``repro.kernels.ssd_scan.ssd_scan`` (Pallas,
``_kernel``).  The CUDA source is ``csrc/ssd_scan.cu``; it is compiled at the
first call on a CUDA tensor (``_build.load``) and bound with ``ctypes``.

Per (batch, head, chunk of Q steps)::

    cum   = cumsum(dt·A)
    W     = (C Bᵀ) ⊙ tril(exp(cum_i − cum_j)) ⊙ dt_j
    y     = W x + (C ⊙ exp(cum)) h_prevᵀ
    h_new = exp(cum_Q) h_prev + (B ⊙ dt ⊙ exp(cum_Q − cum))ᵀ x

with the (P, N) f32 state carried across chunks.

What bounds it on an H100: bytes at the shapes of the serving path (x in and
y out dominate; the operations, 2·(Q²N + Q²P + 2QPN) per (b, h, chunk),
would take less time on the tensor cores).  The kernel runs every product in
f32 on the FP32 pipes, which put a floor well above that bound; see the note
at the top of the CUDA source.  One thread block owns a (b, h, P slice) and
walks the chunks with the state in shared memory, so the state never goes
back to device memory between chunks; B and C are read at group
``h // (H/G)``, never repeated.

Accepted shapes: x ``(Bz, H, L, P)``, dt ``(Bz, H, L)`` f32, A ``(H,)`` f32,
B and C ``(Bz, G, L, N)`` with ``H % G == 0``; ``chunk`` (clipped to L, as in
the reference) must divide L.  The kernel takes chunks up to 256, N up to 128,
P and N multiples of 4; x and B/C each f32 or bf16.  The last dimension of x,
B and C must be contiguous and every row 16-byte aligned; the other
dimensions may be strided (``(B, L, H, P)`` views of the conv output, viewed
as ``(B, H, L, P)``, are taken as they are).  y has x's type and x's dimension
order (``torch.empty_like``), h_final is ``(Bz, H, P, N)`` f32.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.runtime import flags

NEG_INF = -1e30

#: the longest chunk the kernel takes
MAX_CHUNK = 256

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 15 + [ctypes.c_int] * 2
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


def tile(P: int, N: int, chunk: int) -> Tuple[int, int]:
    """The tile the kernel launches for (P, N, chunk), as the CUDA source
    chooses it: (P slice one thread block owns, bytes of shared memory of
    that block).  Builds the source if need be; needs ``nvcc``."""
    fn = _build.load("ssd_scan").ssd_scan_tile
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int),
                                            ctypes.POINTER(ctypes.c_longlong)]
        fn.restype = ctypes.c_int
    pb, nbytes = ctypes.c_int(), ctypes.c_longlong()
    if fn(P, N, chunk, ctypes.byref(pb), ctypes.byref(nbytes)) != 0:
        raise ValueError(f"the kernel takes no tile for P={P}, N={N}, "
                         f"chunk={chunk}")
    return pb.value, nbytes.value


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


def _check_layout(name: str, t: torch.Tensor) -> None:
    # the kernel moves 4 elements at a time (16 bytes of f32, 8 of bf16)
    if t.stride(-1) != 1 or any(s % 4 for s in t.stride()[:-1]) \
            or t.data_ptr() % (4 * t.element_size()):
        raise ValueError(
            f"{name}: the last dimension must be contiguous and every row "
            f"aligned to 4 elements; got strides {t.stride()}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (Bz,H,L,P), dt (Bz,H,L), A (H,), B/C (Bz,G,L,N) -> (y, h_final).

    A CUDA tensor goes through the kernel, or the call raises.  The plain
    version is taken only for tensors that lie on the CPU, and under
    ``flags.use_kernels(False)`` (for comparisons)."""
    _check(x, dt, A, B, C)
    Bz, H, L, P = x.shape
    G, N = B.shape[1], B.shape[3]
    chunk = min(int(chunk), L)
    if chunk < 1 or L % chunk:
        raise ValueError(f"L={L} is not a multiple of chunk={chunk}")
    if x.device.type == "cpu" or not flags.kernels_enabled():
        return ssd_scan_reference(x, dt, A, B, C, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B, C)):
        raise NotImplementedError(
            "the SSD-scan kernel has no backward yet (it arrives with the "
            "training slice); call it under torch.no_grad()")
    if chunk > MAX_CHUNK:
        raise ValueError(f"chunk {chunk} > {MAX_CHUNK} is not supported by "
                         "the kernel")
    if N > 128 or N % 4 or P % 4:
        raise ValueError(f"P and N must be multiples of 4, N at most 128; "
                         f"got P={P}, N={N}")
    y = torch.empty_like(x)  # x's dimension order: (B, L, H, P) in memory
    h = torch.empty((Bz, H, P, N), dtype=torch.float32, device=x.device)
    A = A.contiguous()
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
                 int(B.dtype == torch.bfloat16),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"ssd_scan_forward: CUDA error {err} at launch (x "
            f"{tuple(x.shape)}, B {tuple(B.shape)}, chunk {chunk})")
    ssd_scan.launches += 1
    return y, h


#: how many times the kernel was launched (and only that: the plain version
#: does not count)
ssd_scan.launches = 0
