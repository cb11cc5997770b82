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


def dense(weight: torch.Tensor, x: torch.Tensor,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., in) · weightᵀ (out, in) [+ bias]."""
    return F.linear(x, weight, bias)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """f32 math, cast back to x's type."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def ffn(gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
        x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: down(silu(gate x) ⊙ up x)."""
    return dense(down, F.silu(dense(gate, x)) * dense(up, x))


def embed(weight: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (...) int → (..., d_model); weight (vocab, d_model).  With a
    multi-codebook weight (n_codebooks, vocab, d_model) (MusicGen), tokens
    (..., n_codebooks) → the sum of the codebooks' embeddings, added in
    codebook order."""
    if weight.ndim == 3:
        out = F.embedding(tokens[..., 0], weight[0])
        for c in range(1, weight.shape[0]):
            out = out + F.embedding(tokens[..., c], weight[c])
        return out
    return F.embedding(tokens, weight)


def lm_head(weight: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """weight (vocab, d_model): x (..., d_model) → (..., vocab).  With
    ``n_heads`` codebook heads, weight (n_heads, vocab, d_model): x (B, S,
    d_model) → (B, S, n_heads, vocab)."""
    if weight.ndim == 3:
        return torch.einsum("bsd,hvd->bshv", x, weight)
    return F.linear(x, weight)


def tied_lm_head(embed_weight: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x · embedᵀ with embed (vocab, d_model)."""
    assert embed_weight.ndim == 2
    return F.linear(x, embed_weight)


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


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy; logits (..., V) in any float type (f32 math),
    labels (...) int; with ``mask`` (...), the mask-weighted mean."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
