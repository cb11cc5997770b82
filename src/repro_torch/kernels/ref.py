"""Plain PyTorch versions of the kernels (the allclose references).

Deliberately naive — O(S²) attention with materialised logits, the O(L)
sequential SSD recurrence — so they are independent of the kernels and of the
chunked paths in ``repro_torch.models``.  The plain version of attention
lives beside its kernel's wrapper and is re-exported here under the
reference's name; ``matmul`` and ``transpose`` arrive with their kernels.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import \
    attention_reference as attention

__all__ = ["attention", "ssd"]


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, h0: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential SSD recurrence, one step at a time, f32.

    x (Bz,H,L,P); dt (Bz,H,L); A (H,) negative; B, C (Bz,G,L,N), G | H.
    ``h_t = h_{t-1}·exp(dt_t A) + dt_t · B_t ⊗ x_t``, ``y_t = C_t · h_t``.
    Returns (y (Bz,H,L,P) in x's type, h_final (Bz,H,P,N) f32)."""
    Bz, H, L, P = x.shape
    G, N = B.shape[1], B.shape[3]
    rep = H // G
    Bf = B.float().repeat_interleave(rep, dim=1)  # (Bz,H,L,N)
    Cf = C.float().repeat_interleave(rep, dim=1)
    xf, dtf, Af = x.float(), dt.float(), A.float()
    h = torch.zeros((Bz, H, P, N), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    ys = []
    for t in range(L):
        dA = torch.exp(dtf[:, :, t] * Af[None, :])  # (Bz,H)
        upd = torch.einsum("bhn,bhp->bhpn", Bf[:, :, t] * dtf[:, :, t, None],
                           xf[:, :, t])
        h = h * dA[..., None, None] + upd
        ys.append(torch.einsum("bhn,bhpn->bhp", Cf[:, :, t], h))
    return torch.stack(ys, dim=2).to(x.dtype), h
