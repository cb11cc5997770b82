"""Public wrappers of the kernels.

Model code calls these.  Every wrapper accepts ``block_sizes``:

  * ``None`` (default) — use the explicit ``block_*`` keyword arguments;
  * a mapping — override the block keywords wholesale;
  * ``"auto"`` — ask the cost-model-guided autotuner
    (``repro_torch.kernels.autotune.best_block_sizes``) to pick them for
    this shape, type and layout among the tiles the CUDA source builds,
    scoring candidates through ``model`` (a registry device name, an
    in-memory ``LinearCostModel``, or None: ``default_model``).

``"auto"`` resolution happens in plain Python before the kernel is called,
so it runs once per (shape, model) and is memoized.  The SSD scan's chunk
under autograd (``ssd_scan_shape``'s ``grad``) is priced with the backward
``models/ssm._SSDScan`` runs for those inputs: the backward kernels
(``ssd_scan_backward``, the same price at every chunk), or the
chunk-by-chunk recompute of the plain version.

Block sizes are requests: flash attention's f32 kernel serves them with the
nearest tile it is built for (``flash_attention.pick_tiles``), its bf16
kernel ignores them (its CUDA source picks the tile; ``flash_attention.tile``
reports it); the SSD scan takes its
``chunk`` as given (it changes the result only by rounding), and its CUDA
source picks the P slice (``ssd_scan.tile`` reports it); the CUDA sources of
``matmul`` and ``transpose`` serve a request with the nearest tile they are
built for (``matmul.tile``, ``transpose.tile`` report it).  The candidates
``"auto"`` picks among are such tiles, so the request is the tile that runs.
The reference's ``interpret=`` has no counterpart: a CUDA kernel has no
interpret mode.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import transpose as _tr

BlockSizes = Union[None, str, Mapping[str, int]]

#: the registry name of the card's cost model
CARD_MODEL = "gpu-h100"


def default_model(t: torch.Tensor) -> Optional[str]:
    """The cost model ``block_sizes="auto"`` scores through when the caller
    names none, by where the tensor lies.

    On a CUDA tensor, ``CARD_MODEL``: the registry's fitted ``gpu-h100``
    model where a calibration wrote one, else its analytic datasheet seed.
    On a CPU tensor, None: the reference's default, the analytic v5e seed,
    so that the parity tests compare like with like (the plain version runs
    there whatever the blocks, but for the SSD chunk's rounding).  Under
    ``flags.price_kernels`` (the dry run's stand-ins for the card's
    tensors), ``CARD_MODEL``."""
    from repro_torch.runtime import flags
    return CARD_MODEL if t.device.type == "cuda" or flags.kernels_priced() \
        else None


def _local(*tensors: torch.Tensor) -> None:
    """Refuse a DTensor: a kernel reads raw pointers of one device's
    memory, so a sharded tensor reaches it as this rank's shard
    (``torch.distributed.tensor.experimental.local_map``, as the models
    call it), never as the DTensor."""
    from torch.distributed.tensor import DTensor
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError("a kernel takes this rank's shard, not a DTensor: "
                        "call it under local_map (or on .to_local())")


def _base(t: torch.Tensor) -> int:
    """The byte address of ``t``'s first element; for a fake or meta
    tensor (no memory) its offset into its storage."""
    if is_fake(t) or t.is_meta:
        return t.storage_offset() * t.element_size()
    return t.data_ptr()


def _bits(t: torch.Tensor) -> int:
    return t.element_size() * 8


def _rows16(t: torch.Tensor) -> bool:
    """Rows readable 16 bytes at a time: an aligned base and a leading
    stride of a multiple of 16 bytes."""
    return _base(t) % 16 == 0 and t.stride(0) * t.element_size() % 16 == 0


def flash_attention_shape(q: torch.Tensor, k: torch.Tensor, *,
                          causal: bool = True,
                          window: Optional[int] = None) -> dict:
    """The problem shape ``"auto"`` tunes ``flash_attention`` for."""
    B, H, Sq, dh = q.shape
    return {"B": B, "H": H, "KVH": k.shape[1], "Sq": Sq, "Skv": k.shape[2],
            "dh": dh, "causal": causal, "window": window, "bits": _bits(q)}


def _under_autograd(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def ssd_scan_shape(x: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor) -> dict:
    """The problem shape ``"auto"`` tunes ``ssd_scan`` for, with whether
    the tensor-core kernel can read x, B and C (``tma``) and whether the
    call runs under autograd (``grad``: the backward then recomputes at
    the chunk)."""
    Bz, H, L, P = x.shape
    return {"Bz": Bz, "H": H, "L": L, "P": P, "N": B.shape[3],
            "bits": _bits(x),
            "tma": _ssd.tma_readable(x, B, C, [_base(t) for t in (x, B, C)]),
            "grad": _under_autograd(x, B, C)}


def matmul_shape(a: torch.Tensor, b: torch.Tensor) -> dict:
    """The problem shape ``"auto"`` tunes ``matmul`` for, with whether A
    and B are readable 16 bytes at a time (``va``, ``vb``)."""
    return {"M": a.shape[0], "K": a.shape[1], "N": b.shape[1],
            "bits": _bits(a), "va": _rows16(a), "vb": _rows16(b)}


def transpose_shape(x: torch.Tensor) -> dict:
    """The problem shape ``"auto"`` tunes ``transpose`` for, with whether
    its rows are 16-byte aligned (``aligned``)."""
    return {"M": x.shape[0], "N": x.shape[1], "bits": _bits(x),
            "aligned": _rows16(x)}


#: ``"auto"`` picks by kernel, model name and what the tuner reads of the
#: arguments (shapes, strides, types, base alignment, options); emptied when
#: it reaches ``_AUTO_MAX`` (a hit must stay a plain dict lookup: the
#: models ask on every layer)
_AUTO: Dict[tuple, Dict[str, int]] = {}
_AUTO_MAX = 256


def _resolve_blocks(kernel: str, shape: Callable[[], dict],
                    block_sizes: BlockSizes, explicit: dict, model,
                    tensors: Tuple[torch.Tensor, ...], *options) -> dict:
    """Merge the three block-size sources (explicit kwargs < mapping <
    autotuner) into concrete ints; ``shape()`` gives the autotuner's
    problem shape, and is called only for ``"auto"``.

    With a model named (or None), ``"auto"`` is resolved once per layout of
    the arguments in a process — the reference's model code resolves it
    once per trace — since the models call it on every layer; a model
    fitted later applies to layouts not seen yet
    (``autotune.best_block_sizes`` itself re-reads the registry on every
    call)."""
    if block_sizes is None:
        return explicit
    if isinstance(block_sizes, str) and block_sizes == "auto":
        from repro_torch.kernels import autotune
        if model is None:
            model = default_model(tensors[0])
        if model is not None and not isinstance(model, str):
            return dict(autotune.best_block_sizes(kernel, shape(), model))
        key = (kernel, model, options,
               *((t.shape, t.stride(), t.dtype, _base(t) % 16)
                 for t in tensors))
        blocks = _AUTO.get(key)
        if blocks is None:
            if len(_AUTO) >= _AUTO_MAX:
                _AUTO.clear()
            blocks = _AUTO[key] = autotune.best_block_sizes(kernel, shape(),
                                                            model)
        return dict(blocks)
    if isinstance(block_sizes, Mapping):
        out = dict(explicit)
        out.update(block_sizes)
        return out
    raise TypeError(f"block_sizes must be None, 'auto' or a mapping; "
                    f"got {block_sizes!r}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    block_q: int = 128, block_k: int = 128,
                    block_sizes: BlockSizes = None, model=None,
                    return_lse: bool = False):
    """q (B,H,Sq,dh) × k,v (B,KVH,Skv,dh) → (B,H,Sq,dh); with
    ``return_lse``, ``(o, lse (B,H,Sq) f32)``."""
    _local(q, k, v)
    blocks = _resolve_blocks(
        "flash_attention",
        lambda: flash_attention_shape(q, k, causal=causal, window=window),
        block_sizes, {"block_q": block_q, "block_k": block_k}, model,
        (q, k), causal, window)
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               block_q=blocks["block_q"],
                               block_k=blocks["block_k"],
                               return_lse=return_lse)


def ssd_chunk(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor, *,
              chunk: int = 128, block_sizes: BlockSizes = None,
              model=None) -> int:
    """The chunk ``ssd_scan`` runs with for these arguments (``"auto"``:
    the autotuner's, for x (Bz,H,L,P) and B, C (Bz,G,L,N) as they lie).
    The training path resolves it once, before its autograd Function, so
    that the backward recomputes at the chunk the forward ran."""
    return _resolve_blocks("ssd_scan", lambda: ssd_scan_shape(x, B, C),
                           block_sizes, {"chunk": chunk}, model,
                           (x, B, C), _under_autograd(x, B, C))["chunk"]


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128,
             block_sizes: BlockSizes = None, model=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD: x (Bz,H,L,P), dt (Bz,H,L), A (H,), B/C (Bz,G,L,N) ->
    (y (Bz,H,L,P), h_final (Bz,H,P,N) f32)."""
    _local(x, dt, A, B, C)
    chunk = ssd_chunk(x, B, C, chunk=chunk, block_sizes=block_sizes,
                      model=model)
    return _ssd.ssd_scan(x, dt, A, B, C, chunk=chunk)


def ssd_scan_backward(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                      B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor
                      ) -> Tuple[torch.Tensor, ...]:
    """The SSD scan's gradients at ``dy`` on its backward kernels (the
    inputs ``ssd_scan.backward_path`` sends there) -> (dx, ddt, dA, dB,
    dC).  Nothing to tune: the kernels walk their own step whatever chunk
    the forward ran."""
    _local(x, dt, A, B, C, dy)
    return _ssd.ssd_scan_backward(x, dt, A, B, C, dy)


def matmul(a: torch.Tensor, b: torch.Tensor, *, block_m: int = 128,
           block_n: int = 128, block_k: int = 128,
           block_sizes: BlockSizes = None, model=None) -> torch.Tensor:
    """(M, K) @ (K, N) with f32 sums, in the inputs' type."""
    _local(a, b)
    blocks = _resolve_blocks(
        "matmul", lambda: matmul_shape(a, b), block_sizes,
        {"block_m": block_m, "block_n": block_n, "block_k": block_k},
        model, (a, b))
    return _mm.matmul(a, b, block_m=blocks["block_m"],
                      block_n=blocks["block_n"], block_k=blocks["block_k"])


def transpose(x: torch.Tensor, *, block: int = 256,
              block_sizes: BlockSizes = None, model=None) -> torch.Tensor:
    """(M, N) -> (N, M), contiguous."""
    _local(x)
    blocks = _resolve_blocks("transpose", lambda: transpose_shape(x),
                             block_sizes, {"block": block}, model, (x,))
    return _tr.transpose(x, block=blocks["block"])
