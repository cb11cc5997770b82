"""Public wrappers of the kernels.

Model code calls these.  Every wrapper accepts ``block_sizes``:

  * ``None`` (default) — use the explicit ``block_*`` keyword arguments;
  * a mapping — override the block keywords wholesale;
  * ``"auto"`` — the cost-model-guided autotuner; it is not ported yet
    (``kernels/autotune.py``, ``core/kernelmodel.py``) and raises
    ``NotImplementedError``.

Block sizes are requests: flash attention's f32 kernel serves them with the
nearest tile it is built for (``flash_attention.pick_tiles``), its bf16
kernel ignores them (its CUDA source picks the tile; ``flash_attention.tile``
reports it); the SSD scan takes its
``chunk`` as given (it changes the result only by rounding), and its CUDA
source picks the P slice (``ssd_scan.tile`` reports it); the CUDA sources of
``matmul`` and ``transpose`` serve a request with the nearest tile they are
built for (``matmul.tile``, ``transpose.tile`` report it).  The reference's
``model=`` (the cost model the autotuner scores through) comes with
``"auto"``; its ``interpret=`` has no counterpart: a CUDA kernel has no
interpret mode.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple, Union

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import transpose as _tr

BlockSizes = Union[None, str, Mapping[str, int]]


def _resolve_blocks(kernel: str, block_sizes: BlockSizes,
                    explicit: dict) -> dict:
    """Merge the block-size sources (explicit kwargs < mapping)."""
    if block_sizes is None:
        return explicit
    if isinstance(block_sizes, str) and block_sizes == "auto":
        raise NotImplementedError(
            f"block_sizes='auto' for {kernel} waits for the autotuner slice "
            "(kernels/autotune.py, core/kernelmodel.py are not ported yet); "
            "pass None or a mapping")
    if isinstance(block_sizes, Mapping):
        out = dict(explicit)
        out.update(block_sizes)
        return out
    raise TypeError(f"block_sizes must be None, 'auto' or a mapping; "
                    f"got {block_sizes!r}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    block_q: int = 128, block_k: int = 128,
                    block_sizes: BlockSizes = None, return_lse: bool = False):
    """q (B,H,Sq,dh) × k,v (B,KVH,Skv,dh) → (B,H,Sq,dh); with
    ``return_lse``, ``(o, lse (B,H,Sq) f32)``."""
    blocks = _resolve_blocks("flash_attention", block_sizes,
                             {"block_q": block_q, "block_k": block_k})
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               block_q=blocks["block_q"],
                               block_k=blocks["block_k"],
                               return_lse=return_lse)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128,
             block_sizes: BlockSizes = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD: x (Bz,H,L,P), dt (Bz,H,L), A (H,), B/C (Bz,G,L,N) ->
    (y (Bz,H,L,P), h_final (Bz,H,P,N) f32)."""
    blocks = _resolve_blocks("ssd_scan", block_sizes, {"chunk": chunk})
    return _ssd.ssd_scan(x, dt, A, B, C, chunk=blocks["chunk"])


def matmul(a: torch.Tensor, b: torch.Tensor, *, block_m: int = 128,
           block_n: int = 128, block_k: int = 128,
           block_sizes: BlockSizes = None) -> torch.Tensor:
    """(M, K) @ (K, N) with f32 sums, in the inputs' type."""
    blocks = _resolve_blocks(
        "matmul", block_sizes,
        {"block_m": block_m, "block_n": block_n, "block_k": block_k})
    return _mm.matmul(a, b, block_m=blocks["block_m"],
                      block_n=blocks["block_n"], block_k=blocks["block_k"])


def transpose(x: torch.Tensor, *, block: int = 256,
              block_sizes: BlockSizes = None) -> torch.Tensor:
    """(M, N) -> (N, M), contiguous."""
    blocks = _resolve_blocks("transpose", block_sizes, {"block": block})
    return _tr.transpose(x, block=blocks["block"])
