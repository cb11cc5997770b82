"""Sharding annotations — the single-device part.

The reference maps logical axis names onto a device mesh.  Outside a
sharding context both functions below are no-ops there too, and that is the
only behaviour the single-GPU serving path needs.  The mesh rules, parameter
sharding trees and the context-parallel attention split are multi-device
work and are not ported yet.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def logical(x: torch.Tensor, names: Sequence[Optional[str]]) -> torch.Tensor:
    """Annotate an activation with logical axis names (identity: there is no
    sharding context on one device)."""
    return x


def context_parallel_factor(n_heads: int, seq_len: int,
                            min_slice: int = 1024) -> int:
    """How many ways to split the q-sequence for attention.  Always 1 on one
    device (no tensor-parallel axis to occupy)."""
    return 1
