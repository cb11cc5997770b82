"""Int8 error-feedback gradient compression for the DP all-reduce.

The wire format is per-chunk int8 + f32 scale (about 4x fewer collective
bytes than f32, 2x fewer than bf16).  Error feedback (Seide et al. / 1-bit
Adam lineage) accumulates the quantization residual locally and re-adds it
before the next step's compression, so the long-run gradient is unbiased
and convergence matches uncompressed SGD/Adam to first order.

Two layers, as in the reference:

  * the quantizer (``quantize`` / ``dequantize`` / ``ef_compress``), plain
    tensor functions;
  * ``psum_compressed``, the collective: a quantized reduce-scatter
    (``all_to_all`` of int8 codes and f32 scales, then a local sum) followed
    by a quantized all-gather.  Per-rank wire bytes about 2(n-1)/n size/4
    against 2(n-1)/n size uncompressed.

Each rank calls it in its own process on its own value (the reference calls
it inside a ``shard_map`` body); ``group`` is the process group of the mesh
axis the sum runs over.  Quantizing is plain torch: the reference's is
``jnp`` code, not a Pallas kernel.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils import _pytree as pytree

CHUNK = 1024  # quantization granularity (one f32 scale per CHUNK values)

#: the all-gather into one tensor: ``all_gather_single`` where this torch
#: has it, ``all_gather_into_tensor`` (which newer releases deprecate for
#: it) otherwise
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


# ---------------------------------------------------------------------------
# Quantizer
# ---------------------------------------------------------------------------


def _pad_to(x: torch.Tensor, mult: int) -> Tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    n = flat.numel()
    pad = (-n) % mult
    return (F.pad(flat, (0, pad)) if pad else flat), n


def quantize(x: torch.Tensor, chunk: int = CHUNK
             ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """-> (int8 codes (k, chunk), f32 per-chunk scales (k,), original size).
    The scale is ``max|c| / 127`` (at least 1e-30), the rounding half to
    even, the codes clipped to +-127."""
    flat, n = _pad_to(x.float(), chunk)
    c = flat.reshape(-1, chunk)
    scale = torch.clamp(c.abs().amax(dim=1, keepdim=True) / 127.0, min=1e-30)
    # in place on the one f32 temporary: the gradients are the size of the
    # largest parameter
    codes = torch.div(c, scale).round_().clamp_(-127, 127).to(torch.int8)
    return codes, scale[:, 0], n


def dequantize(codes: torch.Tensor, scales: torch.Tensor, n: int, shape,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    vals = codes.float().mul_(scales[:, None])
    return vals.reshape(-1)[:n].reshape(shape).to(dtype)


def ef_compress(x: torch.Tensor, residual: torch.Tensor, chunk: int = CHUNK):
    """Error-feedback compress: -> (codes, scales, new residual)."""
    y = x.float() + residual
    codes, scales, n = quantize(y, chunk)
    deq = dequantize(codes, scales, n, x.shape)
    return codes, scales, y.reshape(x.shape).sub_(deq)


# ---------------------------------------------------------------------------
# Compressed all-reduce
# ---------------------------------------------------------------------------


def reduce_scatter_compressed(x: torch.Tensor, group=None,
                              chunk: int = CHUNK) -> torch.Tensor:
    """Steps 1-2 of ``psum_compressed``: this rank's shard of the sum of
    ``x`` over ``group``, f32 and flat (shard i of the value padded to
    ``n * chunk`` elements and cut in n)."""
    n = dist.get_world_size(group)
    flat, _ = _pad_to(x.float(), n * chunk)
    codes, scales, _ = quantize(flat, chunk)
    codes = codes.reshape(n, -1)          # row i -> destined for rank i
    scales = scales.reshape(n, -1)
    codes_x = torch.empty_like(codes)
    scales_x = torch.empty_like(scales)
    dist.all_to_all_single(codes_x, codes, group=group)
    dist.all_to_all_single(scales_x, scales, group=group)
    del codes, scales, flat
    # local dequant-sum of the n received contributions for this shard
    return torch.sum(codes_x.float().reshape(n, -1, chunk)
                     .mul_(scales_x[..., None]), dim=0).reshape(-1)


def psum_compressed(x: torch.Tensor, group=None,
                    chunk: int = CHUNK) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` with an int8 wire
    format; every rank of the group calls it on a value of the same shape.

    Algorithm (ring-equivalent):
      1. split the local value into n destination shards, quantize, and
         ``all_to_all`` codes and scales (the reduce-scatter wire move);
      2. dequantize + sum the n received contributions (this rank's reduced
         shard);
      3. re-quantize, all-gather codes and scales, dequantize.
    """
    n = dist.get_world_size(group)
    part = reduce_scatter_compressed(x, group, chunk)
    # quantize the reduced shard, all-gather to complete the all-reduce
    c2, s2, _ = quantize(part, chunk)     # (k, chunk) int8, (k,) f32
    del part
    # gathered along the leading dimension: (n k, chunk) and (n k,)
    c_all = c2.new_empty((n * c2.shape[0], chunk))
    s_all = s2.new_empty((n * s2.shape[0],))
    _all_gather(c_all, c2, group=group)
    _all_gather(s_all, s2, group=group)
    full = c_all.float().mul_(s_all[:, None]).reshape(-1)
    return full[:x.numel()].reshape(x.shape).to(x.dtype)


def psum_tree_compressed(tree: Any, group=None, chunk: int = CHUNK) -> Any:
    return pytree.tree_map(lambda x: psum_compressed(x, group, chunk), tree)
