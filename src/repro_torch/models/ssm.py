"""Mamba2 mixer: chunked SSD (state-space duality) for train and prefill,
linear in the sequence length, and an O(1) recurrence for decode.

Train and prefill go through ``_SSDScan``, an autograd Function around
``kops.ssd_scan``.  Its forward is always the wrapper: the hand-written
SSD-scan kernel on a CUDA tensor, and its plain chunked version
(``ssd_scan_reference``, the reference's ``_ssd_chunked`` in the kernel's
layout) on a CPU tensor or under ``flags.use_kernels(False)``; the wrapper
makes that choice, and the forward saves only the inputs.  Its BACKWARD —
never its forward — recomputes the plain chunked math under autograd and
returns ``torch.autograd.grad`` of it: the counterpart of ``jax.grad``
through ``_ssd_chunked``, which is what the reference differentiates (it has
no backward kernel), one layer at a time.  Decode is plain tensor code, as
in the reference (which has no decode kernel either).

Layouts follow the reference: ``conv_w`` is ``(d_conv, conv_dim)`` and used as
``w[j]`` per tap; ``A_log``, ``D`` and ``dt_bias`` stay f32 whatever the
parameter type.  The kernel is handed ``(B, S, H, P)`` views of the conv
output viewed as ``(B, H, S, P)`` and writes y in the ``(B, S, H, P)`` memory
order, so no transpose is materialised.

Dtypes follow JAX's promotion, which differs from PyTorch's in one place:
there a bf16 array times an f32 array of any rank gives f32, here a 0-dim f32
tensor would not promote a bf16 one.  No line below mixes a 0-dim tensor
into a product, and the mixed-type einsum of the decode step casts C to f32
as JAX does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.sharding import logical
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ssd_scan import ssd_scan_reference
from repro_torch.models import layers


class SSMState(NamedTuple):
    conv: torch.Tensor  # (B, d_conv-1, conv_dim) — trailing conv inputs
    h: torch.Tensor     # (B, nH, P, N) f32 — SSM recurrent state


def conv_dim(cfg) -> int:
    return cfg.d_inner + 2 * cfg.ssm.n_groups * cfg.ssm.d_state


class SSM(nn.Module):
    """The parameters of one Mamba2 mixer (``ssm_init`` of the reference)."""

    def __init__(self, cfg, dtype, device, generator: torch.Generator):
        super().__init__()
        s = cfg.ssm
        din, nH = cfg.d_inner, cfg.ssm_heads
        cd = conv_dim(cfg)
        f32 = torch.float32
        # in_proj -> [z, x, B, C, dt]
        self.in_proj = layers.Dense(cfg.d_model, din + cd + nH, dtype, device,
                                    generator)
        self.conv_w = nn.Parameter(
            layers.normal_((s.d_conv, cd), dtype, device, generator))
        self.conv_b = nn.Parameter(torch.zeros(cd, dtype=dtype, device=device))
        self.A_log = nn.Parameter(torch.log(
            torch.linspace(1.0, 16.0, nH, dtype=f32, device=device)))
        self.D = nn.Parameter(torch.ones(nH, dtype=f32, device=device))
        self.dt_bias = nn.Parameter(torch.zeros(nH, dtype=f32, device=device))
        self.norm = nn.Parameter(torch.ones(din, dtype=dtype, device=device))
        self.out_proj = layers.Dense(din, cfg.d_model, dtype, device,
                                     generator)


def _split_proj(cfg, proj: torch.Tensor):
    """-> z (…, din), xbc (…, din+2GN), dt (…, nH); views of ``proj``."""
    din, nH = cfg.d_inner, cfg.ssm_heads
    return proj.split([din, conv_dim(cfg), nH], dim=-1)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d.  xbc (B, L, Cd); w (k, Cd)."""
    k, L = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    # windowed sum: sum_j w[j] * x[t-k+1+j]
    out = sum(pad[:, j:j + L, :] * w[j] for j in range(k))
    return F.silu(out + b)


class _SSDScan(torch.autograd.Function):
    """y of ``kops.ssd_scan`` (the kernel on a CUDA tensor), differentiable
    through a recompute of ``ssd_scan_reference`` in the backward.  Layouts
    as the wrapper's: x (Bz,H,L,P), dt (Bz,H,L), A (H,), B/C (Bz,G,L,N)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        y, _ = kops.ssd_scan(x, dt, A, B, C, chunk=chunk)
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            y, _ = ssd_scan_reference(*inputs, chunk=ctx.chunk)
        want = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(y, want, dy))
        return (*(next(grads) if t.requires_grad else None
                  for t in inputs), None)


def ssm_apply(p: SSM, x: torch.Tensor, cfg, *,
              state: Optional[SSMState] = None
              ) -> Tuple[torch.Tensor, Optional[SSMState]]:
    """Mamba2 block.  x (B, S, d).  With ``state``, runs one decode step
    (S == 1) and updates ``state.conv`` and ``state.h`` IN PLACE; the
    returned state is ``state``."""
    s = cfg.ssm
    Bsz, S, _ = x.shape
    din, nH, N, G = cfg.d_inner, cfg.ssm_heads, s.d_state, s.n_groups
    P = s.head_dim
    A = -torch.exp(p.A_log)  # (nH,) f32

    proj = p.in_proj(x)  # (B, S, out_dim)
    z, xbc, dt_raw = _split_proj(cfg, proj)
    dt = F.softplus(dt_raw.float() + p.dt_bias)  # (B, S, nH) f32

    if state is None:
        xbc = _causal_conv(xbc, p.conv_w, p.conv_b)
        xin, Bm, Cm = xbc.split([din, G * N, G * N], dim=-1)
        xin = logical(xin.reshape(Bsz, S, nH, P),
                      ("act_batch", "act_seq", "act_heads", None))
        Bm = Bm.reshape(Bsz, S, G, N)
        Cm = Cm.reshape(Bsz, S, G, N)
        chunk = min(s.chunk, S)
        if S % chunk:
            raise ValueError(
                f"prefill length {S} is not a multiple of the SSD chunk "
                f"{chunk} (the reference asserts the same)")
        # (B, H, S, ·) views, no copies; the chunk is the autotuner's, as
        # in the reference, resolved here once so that the backward
        # recomputes at the chunk the forward ran (under autograd the
        # tuner prices that recompute too)
        xs, Bs, Cs = xin.transpose(1, 2), Bm.transpose(1, 2), \
            Cm.transpose(1, 2)
        chunk = kops.ssd_chunk(xs, Bs, Cs, chunk=chunk, block_sizes="auto")
        y = _SSDScan.apply(xs, dt.transpose(1, 2), A, Bs, Cs, chunk)
        y = y.transpose(1, 2)
        new_state = None
    else:
        # ---- single-step decode (S == 1) ----
        conv_in = torch.cat([state.conv, xbc], dim=1)  # (B, k, conv_dim)
        ct = torch.promote_types(conv_in.dtype, p.conv_w.dtype)
        feat = F.silu(torch.einsum("bkc,kc->bc", conv_in.to(ct),
                                   p.conv_w.to(ct)) + p.conv_b)[:, None]
        state.conv.copy_(conv_in[:, 1:])
        xin, Bm, Cm = feat.split([din, G * N, G * N], dim=-1)
        xin = xin.reshape(Bsz, 1, nH, P).float()
        Bm = Bm.reshape(Bsz, G, N).repeat_interleave(nH // G, dim=1)  # (B,H,N)
        Cm = Cm.reshape(Bsz, G, N).repeat_interleave(nH // G, dim=1)
        dt1 = dt[:, 0]  # (B, H)
        dA = torch.exp(dt1 * A)  # (B, H)
        upd = torch.einsum("bhn,bhp->bhpn", Bm * dt1[..., None], xin[:, 0])
        h = state.h.mul_(dA[..., None, None]).add_(upd)
        yt = torch.einsum("bhn,bhpn->bhp", Cm.float(), h)  # (B, H, P)
        y = yt[:, None].to(x.dtype)  # (B, 1, H, P)
        xin = xin.to(x.dtype)
        new_state = state

    y = y + xin * p.D[:, None].to(x.dtype)
    y = y.reshape(Bsz, S, din)
    y = layers.rmsnorm(p.norm, y * F.silu(z), cfg.norm_eps)
    return p.out_proj(y), new_state


def init_ssm_state(cfg, B: int, dtype, device="cuda") -> SSMState:
    s = cfg.ssm
    return SSMState(
        conv=torch.zeros((B, s.d_conv - 1, conv_dim(cfg)), dtype=dtype,
                         device=device),
        h=torch.zeros((B, cfg.ssm_heads, s.head_dim, s.d_state),
                      dtype=torch.float32, device=device),
    )
