"""Plain PyTorch versions of the kernels (the allclose references).

Deliberately naive — O(S²) attention with materialised logits — so they are
independent of the kernels.  Each plain version lives beside its kernel's
wrapper and is re-exported here under the reference's names; ``ssd``,
``matmul`` and ``transpose`` arrive with their kernels.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import \
    attention_reference as attention

__all__ = ["attention"]
