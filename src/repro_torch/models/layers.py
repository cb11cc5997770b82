"""Basic layers: plain functions on tensors, and the ``nn.Module``s that hold
their parameters.

Weights follow PyTorch's habit, ``(out, in)`` for a dense layer; the
reference stores ``(in, out)`` and ``models/convert.py`` transposes.  So the
audio family's LM head of ``n_heads`` codebook heads is ``(n_heads, vocab,
d_model)`` where the reference's is ``(n_heads, d_model, vocab)``; its
multi-codebook embedding is ``(n_codebooks, vocab, d_model)`` in both.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.sharding import (distribute_tensor_as,
                                              grad_in_layout, is_dtensor,
                                              replicate_dims)

INIT_SCALE = 0.02

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def to_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


def normal_(shape, dtype, device, generator: torch.Generator) -> torch.Tensor:
    """``N(0, INIT_SCALE²)`` drawn in f32 on ``device``, then cast."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    w.normal_(0.0, INIT_SCALE, generator=generator)
    return w.to(dtype)


# ---------------------------------------------------------------------------
# Functions
# ---------------------------------------------------------------------------


def rows_whole(x: torch.Tensor) -> torch.Tensor:
    """x (B, ..., d) with its inner dims gathered where a DTensor splits
    them (the sequence of a sequence-parallel residual stream), its batch
    kept split: Megatron's sequence parallelism gathers the sequence before
    a projection.  DTensor would otherwise fold a batch split over one mesh
    axis and a sequence split over another into one strided dim (the
    projection's (B·S, d) view), whose planning costs far more than the
    gather; the product is the same.  A plain tensor is returned as it
    is."""
    return replicate_dims(x, range(1, x.ndim - 1)) if x.ndim > 2 else x


def dense(weight: torch.Tensor, x: torch.Tensor,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., in) · weightᵀ (out, in) [+ bias]."""
    return grad_in_layout(F.linear(rows_whole(x), weight, bias))


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """f32 math, cast back to x's type."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def ffn(gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
        x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: down(silu(gate x) ⊙ up x); x gathered once for both."""
    x = rows_whole(x)
    return dense(down, F.silu(dense(gate, x)) * dense(up, x))


def embed(weight: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (...) int → (..., d_model); weight (vocab, d_model).  With a
    multi-codebook weight (n_codebooks, vocab, d_model) (MusicGen), tokens
    (..., n_codebooks) → the sum of the codebooks' embeddings, added in
    codebook order.  A DTensor weight is gathered along d_model first (its
    FSDP shard): the lookup then runs vocab-parallel over the model
    axis."""
    weight = replicate_dims(weight, (-1,))
    if weight.ndim == 3:
        out = F.embedding(tokens[..., 0], weight[0])
        for c in range(1, weight.shape[0]):
            out = out + F.embedding(tokens[..., c], weight[c])
        return out
    return F.embedding(tokens, weight)


def _rows_split(x: torch.Tensor) -> bool:
    """Does a DTensor split an inner dim of ``x`` (the sequence of a
    sequence-parallel residual stream)?"""
    return is_dtensor(x) and any(
        isinstance(p, Shard) and 0 < p.dim % x.ndim < x.ndim - 1
        for p in x.placements)


def _head_on_rows(weight: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The LM head on each rank's rows of a sequence-split ``x`` against the
    whole weight (gathered once: its FSDP and vocabulary shards), so that
    the logits come out in ``x``'s layout with the vocabulary whole, the
    layout the sequence-parallel logits are annotated with.  GSPMD picks
    this for the reference's annotation; computed vocab-parallel, the
    logits (B, S, V) would cross the model axis both ways instead.  The
    weight's gradient is each rank's sum over its rows: ``Partial`` over
    the axes that split ``x``, reduce-scattered back to the weight's
    layout."""
    mesh = x.device_mesh
    w = weight.redistribute(mesh, [Replicate()] * mesh.ndim)
    partial = [Partial() if isinstance(p, Shard) else Replicate()
               for p in x.placements]
    wl, xl = w.to_local(grad_placements=partial), x.to_local()
    out = (torch.einsum("bsd,hvd->bshv", xl, wl) if wl.ndim == 3
           else F.linear(xl, wl))
    return DTensor.from_local(out, mesh, x.placements, run_check=False)


def lm_head(weight: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """weight (vocab, d_model): x (..., d_model) → (..., vocab).  With
    ``n_heads`` codebook heads, weight (n_heads, vocab, d_model): x (B, S,
    d_model) → (B, S, n_heads, vocab).  A DTensor weight is gathered along
    d_model first (see ``tied_lm_head``)."""
    if _rows_split(x):
        return _head_on_rows(weight, x)
    x, weight = rows_whole(x), replicate_dims(weight, (-1,))
    if weight.ndim == 3:
        return grad_in_layout(torch.einsum("bsd,hvd->bshv", x, weight))
    return grad_in_layout(F.linear(x, weight))


def tied_lm_head(embed_weight: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x · embedᵀ with embed (vocab, d_model).  A DTensor weight is
    gathered along d_model first (its FSDP shard): the head then runs
    vocab-parallel over the model axis, as the lookup does; on a
    sequence-split ``x`` it runs on each rank's rows (``_head_on_rows``)."""
    assert embed_weight.ndim == 2
    if _rows_split(x):
        return _head_on_rows(embed_weight, x)
    return grad_in_layout(F.linear(rows_whole(x),
                                   replicate_dims(embed_weight, (-1,))))


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class Dense(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, dtype, device,
                 generator: torch.Generator, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(
            normal_((out_dim, in_dim), dtype, device, generator))
        self.bias = nn.Parameter(
            torch.zeros(out_dim, dtype=dtype, device=device)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(self.weight, x, self.bias)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, dtype, device, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(self.scale, x, self.eps)


class FFN(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dtype, device,
                 generator: torch.Generator):
        super().__init__()
        self.gate = Dense(d_model, d_ff, dtype, device, generator)
        self.up = Dense(d_model, d_ff, dtype, device, generator)
        self.down = Dense(d_ff, d_model, dtype, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ffn(self.gate.weight, self.up.weight, self.down.weight, x)


class Embedding(nn.Module):
    def __init__(self, vocab: int, d_model: int, dtype, device,
                 generator: torch.Generator, n_codebooks: int = 1):
        super().__init__()
        shape = (n_codebooks, vocab, d_model) if n_codebooks > 1 \
            else (vocab, d_model)
        self.weight = nn.Parameter(normal_(shape, dtype, device, generator))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return embed(self.weight, tokens)


class LMHead(nn.Module):
    def __init__(self, d_model: int, vocab: int, dtype, device,
                 generator: torch.Generator, n_heads: int = 1):
        super().__init__()
        shape = (n_heads, vocab, d_model) if n_heads > 1 else (vocab, d_model)
        self.weight = nn.Parameter(normal_(shape, dtype, device, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return lm_head(self.weight, x)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """-log softmax(logits)[labels], f32 math.  A DTensor whose rows each
    hold the whole vocabulary (a sequence-parallel plan gives the sequence
    the model axis) computes it on each rank's rows (``local_map``); one
    whose vocabulary is split computes it vocab-parallel."""
    if is_dtensor(logits) and not any(
            isinstance(p, Shard) and p.dim % logits.ndim == logits.ndim - 1
            for p in logits.placements):
        from torch.distributed.tensor.experimental import local_map
        rows = list(logits.placements)
        return local_map(_nll, out_placements=rows,
                         in_placements=(rows, rows),
                         device_mesh=logits.device_mesh,
                         redistribute_inputs=True)(logits, labels)
    logits = logits.float()
    return _logsumexp(logits) - _label_logits(logits, labels)


def _logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """logsumexp over the last dim.  On a DTensor, written out (the max,
    the shifted exponentials summed, the log), as ``torch.logsumexp``
    computes it: each reduction over a split vocabulary is then a partial
    result reduced across ranks, where DTensor's ``logsumexp`` gathers the
    whole vocabulary on every rank first."""
    if not is_dtensor(logits):
        return torch.logsumexp(logits, dim=-1)
    m = logits.amax(-1, keepdim=True).detach()
    return (m + torch.log(torch.exp(logits - m).sum(-1, keepdim=True))
            )[..., 0]


def _label_logits(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """logits (..., V) at ``labels`` (...).  On a DTensor whose vocabulary
    is split over ranks, each rank compares the labels with the vocabulary
    ids it holds and sums the one logit that matches (adding zeros: the
    same value): DTensor's ``gather`` would gather the logits, and its
    backward scatter into a whole-batch zero tensor, on every rank."""
    if not is_dtensor(logits):
        return torch.gather(logits, -1, labels[..., None].long())[..., 0]
    V = logits.shape[-1]
    pl = tuple(Shard(0) if isinstance(p, Shard)
               and p.dim % logits.ndim == logits.ndim - 1 else Replicate()
               for p in logits.placements)
    ids = distribute_tensor_as(
        torch.arange(V, device=logits.device), logits.device_mesh, pl)
    hit = labels[..., None] == ids
    return torch.where(hit, logits, torch.zeros((), dtype=logits.dtype,
                                                device=logits.device)
                       ).sum(-1)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy; logits (..., V) in any float type (f32 math),
    labels (...) int; with ``mask`` (...), the mask-weighted mean."""
    nll = _nll(logits, labels)
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
