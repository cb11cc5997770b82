"""Public wrappers of the kernels.

Model code calls these.  Every wrapper accepts ``block_sizes``:

  * ``None`` (default) — use the explicit ``block_*`` keyword arguments;
  * a mapping — override the block keywords wholesale;
  * ``"auto"`` — the cost-model-guided autotuner; it is not ported yet
    (``kernels/autotune.py``, ``core/kernelmodel.py``) and raises
    ``NotImplementedError``.

Block sizes are requests: the kernel serves them with the nearest tile it is
built for (``flash_attention.pick_tiles``).  The reference's ``interpret=``
has no counterpart: a CUDA kernel has no interpret mode.
"""
from __future__ import annotations

from typing import Mapping, Optional, Union

import torch

from repro_torch.kernels import flash_attention as _fa

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
                    block_sizes: BlockSizes = None) -> torch.Tensor:
    """q (B,H,Sq,dh) × k,v (B,KVH,Skv,dh) → (B,H,Sq,dh)."""
    blocks = _resolve_blocks("flash_attention", block_sizes,
                             {"block_q": block_q, "block_k": block_k})
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               block_q=blocks["block_q"],
                               block_k=blocks["block_k"])
