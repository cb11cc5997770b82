"""Flash attention (online softmax) with GQA, causal and sliding-window
masking: the wrapper of the hand-written CUDA kernel, and its plain version.

Replaces the TPU kernel ``repro.kernels.flash_attention.flash_attention``
(Pallas, ``_kernel``).  The CUDA source is ``csrc/flash_attention.cu``; it is
compiled at the first call on a CUDA tensor (``_build.load``) and bound with
``ctypes``.

What bounds it on an H100: operations, not bytes — q, k, v and o cross device
memory once each, while the two products cost ``4·B·H·dh`` operations per
visible (q, k) pair.  The CUDA source holds two kernels, chosen by the input
type alone.  bf16 goes to a Hopper kernel whose products run on the bf16
tensor cores (``wgmma``), fed from shared memory by TMA through a two-stage
K/V ring, with a producer warpgroup and two consumer warpgroups of 64 query
rows; P enters P V as hi + lo bf16 parts, so the kernel keeps P as the
reference does, in f32 to about 2^-16; its tile is chosen in the CUDA source
(``tile``).  f32 goes to a kernel
whose products run on the FP32 pipes, since f32 must hold 1e-4, which bf16
tensor cores cannot give.  Both keep the running max, running sum and f32
accumulator in registers over the whole walk along the keys, read K/V at
``h // G`` (no repeat of K/V), and cut fully masked key tiles from their loop
bounds; see the note at the top of the CUDA source.

Accepted shapes: q ``(B, H, Sq, dh)``, k and v ``(B, KVH, Skv, dh)`` with
``H % KVH == 0``, any ``Sq, Skv >= 1`` (the kernel masks the ragged edge
itself, so lengths need not be multiples of the tile — a superset of what the
reference accepts), ``dh`` a multiple of 4 up to 128, f32 or bf16.  The last
dimension must be contiguous; the other dimensions may be strided (a
``(B, S, H, dh)`` tensor viewed as ``(B, H, S, dh)`` is taken as it is).
f32: every row 16-byte aligned.  bf16 (TMA's rule, ``check_tma_layout``): a
16-byte-aligned base and, for every dimension of extent above 1, a stride of
a multiple of 16 bytes; the layouts the models hand over meet it whenever
``dh`` is a multiple of 8.  The output has q's type and q's strides.

With ``return_lse=True`` both kernels also write the row log-sum-exp, lse
``(B, H, Sq)`` f32, ``max(m, -1e4) + ln(max(l, 1e-20))`` of the scaled
logits: what the reference's chunked forward saves for its backward
(``_flash_xla_fwd``).  The training path's ``models.attention._FlashAttention``
asks for it; the kernels refuse autograd outside that Function.

One difference from the plain version: a query row that sees no key at all
(possible only with a window and ``Sq > Skv``) comes out as zeros from the
kernel, as from the TPU kernel, and as the mean of ``v`` from the plain
version, as from the reference's ``ref.attention``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.runtime import flags

NEG_INF = -1e30
#: the running-max floor of the reference's chunked path (``_M_INIT``)
M_INIT = -1e4

#: tile sizes the f32 kernel is built for (rows of q, rows of k per tile)
TILES = (32, 64, 128)
#: bytes of shared memory one thread block may use on sm_90
SMEM_LIMIT = 232448

_ARGTYPES_F32 = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                 + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 4
                 + [ctypes.c_float, ctypes.c_void_p])
_ARGTYPES_BF16 = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                  + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 2
                  + [ctypes.c_float, ctypes.c_void_p])


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        return_lse: bool = False):
    """The plain version: materialised logits, f32 math, ``-1e30`` mask.

    q (B,H,Sq,dh) × k,v (B,KVH,Skv,dh) → (B,H,Sq,dh) in q's type; with
    ``return_lse``, also the row log-sum-exp (B,H,Sq) f32 as the kernels
    write it (the running max floored at ``M_INIT``)."""
    B, H, Sq, dh = q.shape
    KVH, Skv = k.shape[1], k.shape[2]
    G = H // KVH
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) / math.sqrt(dh)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
    if not return_lse:
        return o
    m = torch.clamp(s.amax(dim=-1), min=M_INIT)
    l = torch.exp(s - m[..., None]).sum(dim=-1)
    return o, m + torch.log(torch.clamp(l, min=1e-20))


def tile(dh: int) -> Tuple[int, int, int, int]:
    """The bf16 kernel's tile at head width ``dh``, as the CUDA source
    chooses it: (query rows, keys, stages of the K/V ring, bytes of shared
    memory of one block).  Builds the source if need be; needs ``nvcc``."""
    fn = _build.load("flash_attention").flash_attention_tile
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3 \
            + [ctypes.POINTER(ctypes.c_longlong)]
        fn.restype = ctypes.c_int
    bq, bk, stages = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    nbytes = ctypes.c_longlong()
    if fn(dh, ctypes.byref(bq), ctypes.byref(bk), ctypes.byref(stages),
          ctypes.byref(nbytes)) != 0:
        raise ValueError(f"the bf16 kernel takes no head_dim {dh}")
    return bq.value, bk.value, stages.value, nbytes.value


def tile_rule(dh: int) -> Tuple[int, int, int, int]:
    """``tile`` as a pure function: the bf16 kernel's tile at head width
    ``dh`` as the CUDA source's ``Tile<DHP>`` sets it (query rows, keys,
    stages of the K/V ring, bytes of shared memory of one block), without
    building anything.  ``chip_smoke.py`` holds it against the C query."""
    if dh <= 0 or dh > 128 or dh % 4:
        raise ValueError(f"the bf16 kernel takes no head_dim {dh}")
    dhp = (dh + 15) // 16 * 16
    chunks = (dhp + 63) // 64            # 128-byte row chunks of a row
    keys, stages = (128, 2) if dhp <= 96 else (64, 4)
    q_bytes, kv_bytes = chunks * 128 * 128, chunks * keys * 128
    smem = 1024 + q_bytes + 2 * stages * kv_bytes + 8 * (1 + 4 * stages)
    return 128, keys, stages, smem


def f32_tile(block_q: int, block_k: int, dh: int) -> int:
    """The bytes of shared memory the f32 kernel's tile ``(block_q,
    block_k)`` takes at head width ``dh``, as the CUDA source reports them
    (``flash_attention_f32_tile``); raises ``ValueError`` for a tile it
    does not build.  Builds the source if need be; needs ``nvcc``."""
    fn = _build.load("flash_attention").flash_attention_f32_tile
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_longlong)]
        fn.restype = ctypes.c_int
    nbytes = ctypes.c_longlong()
    if fn(block_q, block_k, dh, ctypes.byref(nbytes)) != 0:
        raise ValueError(f"the f32 kernel builds no tile {block_q}x{block_k} "
                         f"at head_dim {dh}")
    return nbytes.value


#: what a block of each kernel holds besides shared memory: threads, and
#: registers a thread as ``nvcc -Xptxas -v`` reports them for this source
#: (CUDA 12.9, sm_90a).  The bf16 kernel launches 384 threads at 168 (its
#: warpgroups then trade registers with ``setmaxnreg``); the FP32 kernel's
#: instances by (block_q, block_k, padded head width).  ``chip_smoke.py``
#: holds them against the build's report, ``tests/test_torch_gpu.py`` the
#: blocks an SM holds against the CUDA occupancy calculator.
WGMMA_THREADS, WGMMA_REGISTERS, F32_THREADS = 384, 168, 256
F32_REGISTERS = {
    (128, 128, 64): 254, (128, 128, 32): 232, (128, 128, 16): 250,
    (128, 64, 128): 206, (128, 64, 64): 198, (128, 64, 32): 162,
    (128, 64, 16): 132, (128, 32, 128): 199, (128, 32, 64): 128,
    (128, 32, 32): 122, (128, 32, 16): 86, (64, 128, 128): 168,
    (64, 128, 64): 128, (64, 128, 32): 128, (64, 128, 16): 80,
    (64, 64, 128): 128, (64, 64, 64): 92, (64, 64, 32): 98, (64, 64, 16): 64,
    (64, 32, 128): 111, (64, 32, 64): 80, (64, 32, 32): 76, (64, 32, 16): 72,
    (32, 128, 128): 98, (32, 128, 64): 80, (32, 128, 32): 106,
    (32, 128, 16): 106, (32, 64, 128): 73, (32, 64, 64): 88, (32, 64, 32): 92,
    (32, 64, 16): 92, (32, 32, 128): 64, (32, 32, 64): 74, (32, 32, 32): 64,
    (32, 32, 16): 52,
}
#: block-wide waits of one key tile on the critical path: the FP32 kernel's
#: two ``__syncthreads``, the bf16 consumers' K and V ``mbarrier`` waits
SYNCS_PER_TILE = 2


def block_resources(bits: int, block_q: int, block_k: int,
                    dh: int) -> Tuple[int, int]:
    """(threads, registers a thread) of the block that runs the tile
    ``(block_q, block_k)`` at head width ``dh``: the bf16 kernel
    (``bits=16``) or the FP32 one's instance."""
    if bits == 16:
        return WGMMA_THREADS, WGMMA_REGISTERS
    return F32_THREADS, F32_REGISTERS[(block_q, block_k,
                                       padded_head_dim(dh))]


def schedule_props(B: int, H: int, KVH: int, Sq: int, Skv: int, dh: int,
                   *, causal: bool = True, window: Optional[int] = None,
                   block_q: int = 128, block_k: int = 128,
                   bits: int = 16) -> dict:
    """Schedule-derived property vector (the reference's ``schedule_props``,
    ``src/repro/kernels/flash_attention.py:142``: grid cells, block traffic
    and the executed, non-skipped tile pairs) at the tile the CUDA source
    serves the request with: bf16 (``bits=16``) the tensor-core kernel's
    ``tile_rule(dh)`` with its products on ``wgmma`` (``mxu:16``), f32 the
    FP32 kernel's ``pick_tiles`` (``mxu:32``).  Where the tile is the
    request, this is the reference's vector."""
    from repro_torch.core import properties as props
    if bits == 16:
        block_q, block_k = tile_rule(dh)[:2]
    else:
        block_q, block_k = pick_tiles(block_q, block_k, dh)
    n_q, n_k = -(-Sq // block_q), -(-Skv // block_k)
    cells = B * H * n_q * n_k
    exec_pairs = 0
    for qi in range(n_q):
        for ki in range(n_k):
            ok = True
            if causal and ki * block_k > qi * block_q + block_q - 1:
                ok = False
            if window is not None and \
                    qi * block_q - (ki * block_k + block_k - 1) >= window:
                ok = False
            exec_pairs += ok
    exec_cells = B * H * exec_pairs
    local = exec_cells * (block_q * dh + 2 * block_k * dh)
    return {
        props.local_key(bits): float(local),
        props.BARRIER: float(cells),
        props.GROUPS: float(cells),
        props.mxu_key(bits): 4.0 * exec_cells * block_q * block_k * dh,
    }


def tma_layout_error(name: str, shape, strides, data_ptr: int,
                     dtype: torch.dtype) -> Optional[str]:
    """Why TMA cannot read a 4-D tensor through a map of its own shape and
    strides (in elements), or None if it can: the last dimension contiguous,
    a 16-byte-aligned base, and strides that are positive multiples of 16
    bytes below 2**40.  A dimension of extent 1 is never stepped, so its
    stride does not matter.  A function of shape, strides, base address and
    type alone."""
    if strides[3] != 1:
        return (f"{name}: the last dimension must be contiguous; got strides "
                f"{tuple(strides)}")
    if data_ptr % 16:
        return (f"{name}: TMA needs a 16-byte-aligned base; the tensor "
                f"starts {data_ptr % 16} bytes past it")
    nbytes = torch.finfo(dtype).bits // 8
    for dim, extent, stride in zip("0123", shape[:3], strides[:3]):
        if extent > 1 and (stride * nbytes % 16 or stride <= 0
                           or stride * nbytes >= 2 ** 40):
            return (f"{name}: TMA needs strides that are positive multiples "
                    f"of 16 bytes; dimension {dim} has {stride} elements "
                    f"({stride * nbytes} bytes), strides {tuple(strides)}")
    return None


def check_tma_layout(name: str, shape, strides, data_ptr: int,
                     dtype: torch.dtype) -> None:
    """The bf16 kernel's layout rule (``tma_layout_error``) for a
    ``(B, H, S, dh)`` tensor: raises ``ValueError`` with the reason."""
    err = tma_layout_error(name, shape, strides, data_ptr, dtype)
    if err is not None:
        raise ValueError(err)


def padded_head_dim(dh: int) -> int:
    for w in (16, 32, 64, 128):
        if dh <= w:
            return w
    raise ValueError(f"head_dim {dh} > 128 is not supported by the kernel")


def smem_bytes(block_q: int, block_k: int, dh: int) -> int:
    """Shared memory of one block of the f32 kernel (mirrors the CUDA
    source)."""
    dhp = padded_head_dim(dh)
    return 4 * (block_q * (dhp + 4) + block_k * (dhp + 4) + block_k * dhp
                + block_q * (block_k + 16))


def pick_tiles(block_q: int, block_k: int, dh: int) -> Tuple[int, int]:
    """The f32 kernel's tile for a requested ``(block_q, block_k)``: each rounded
    down to a size the kernel is built for (at least 32), then halved — the
    key tile first — until the tile fits a block's shared memory."""
    def snap(b: int) -> int:
        return max([t for t in TILES if t <= b] or [TILES[0]])
    bq, bk = snap(int(block_q)), snap(int(block_k))
    while smem_bytes(bq, bk, dh) > SMEM_LIMIT:
        if bk > TILES[0]:
            bk //= 2
        elif bq > TILES[0]:
            bq //= 2
        else:
            raise ValueError(f"no tile fits shared memory at head_dim {dh}")
    return bq, bk


def _check(q, k, v, window) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be (B, H, S, dh)")
    B, H, Sq, dh = q.shape
    KVH, Skv = k.shape[1], k.shape[2]
    if k.shape != (B, KVH, Skv, dh) or v.shape != k.shape:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if KVH == 0 or H % KVH != 0:
        raise ValueError(f"H={H} is not a multiple of KVH={KVH}")
    if min(B, H, Sq, Skv, dh) < 1:
        raise ValueError("empty dimension")
    if not (q.dtype == k.dtype == v.dtype) \
            or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q, k, v must share a dtype, float32 or bfloat16; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v lie on different devices")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def _check_layout(name: str, t: torch.Tensor) -> None:
    # the kernel moves 4 elements at a time (16 bytes of f32, 8 of bf16)
    if t.stride(3) != 1 or any(s % 4 for s in t.stride()[:3]) \
            or t.data_ptr() % (4 * t.element_size()):
        raise ValueError(
            f"{name}: the last dimension must be contiguous and every row "
            f"aligned to 4 elements; got strides {t.stride()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    block_q: int = 128, block_k: int = 128,
                    return_lse: bool = False):
    """q (B,H,Sq,dh) × k,v (B,KVH,Skv,dh) → (B,H,Sq,dh), and with
    ``return_lse`` also the row log-sum-exp (B,H,Sq) f32.

    A CUDA tensor goes through a kernel, or the call raises: bf16 through
    the tensor-core kernel, whose tile the CUDA source chooses (``tile``),
    f32 through the FP32 kernel, which serves ``block_q``/``block_k`` with
    the nearest tile it is built for (``pick_tiles``); the block sizes apply
    to the f32 kernel only.  The plain version is taken only for tensors that
    lie on the CPU, and under ``flags.use_kernels(False)`` (for
    comparisons)."""
    _check(q, k, v, window)
    if q.device.type == "cpu" or not flags.kernels_enabled():
        return attention_reference(q, k, v, causal=causal, window=window,
                                   return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "the flash-attention kernel is differentiated only through "
            "repro_torch.models.attention._FlashAttention (its backward is "
            "the reference's chunked recompute); call the kernel directly "
            "under torch.no_grad()")
    B, H, Sq, dh = q.shape
    KVH, Skv = k.shape[1], k.shape[2]
    if dh % 4 or dh > 128:
        raise ValueError(f"head_dim must be a multiple of 4, at most 128; "
                         f"got {dh}")
    o = torch.empty_like(q)  # keeps q's strides
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            check_tma_layout(name, t.shape, t.stride(), t.data_ptr(),
                             t.dtype)
        fn = _build.load("flash_attention").flash_attention_forward_bf16
        argtypes, tiles, what = _ARGTYPES_BF16, (), "bf16 tile"
    else:
        for name, t in (("q", q), ("k", k), ("v", v), ("o", o)):
            _check_layout(name, t)
        fn = _build.load("flash_attention").flash_attention_forward
        argtypes = _ARGTYPES_F32
        tiles = pick_tiles(block_q, block_k, dh)
        what = f"tile {tiles[0]}x{tiles[1]}"
    if fn.argtypes is None:
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr() if return_lse else None,
                 B, H, KVH, Sq, Skv, dh,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *o.stride()[:3],
                 int(causal), int(window) if window is not None else 0,
                 *tiles, 1.0 / math.sqrt(dh),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention: CUDA error {err} at launch (shape q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype}, {what})")
    flash_attention.launches += 1
    return (o, lse) if return_lse else o


#: how many times a kernel was launched (and only that: the plain version
#: does not count)
flash_attention.launches = 0
