"""Mamba2 mixer: chunked SSD (state-space duality) for train and prefill,
linear in the sequence length, and an O(1) recurrence for decode.

Train and prefill go through ``_SSDScan``, an autograd Function around
``kops.ssd_scan``.  Its forward is always the wrapper: the hand-written
SSD-scan kernel on a CUDA tensor, and its plain chunked version
(``ssd_scan_reference``, the reference's ``_ssd_chunked`` in the kernel's
layout) on a CPU tensor or under ``flags.use_kernels(False)``; the wrapper
makes that choice, and the forward saves only the inputs.  Its backward
goes where ``ssd_scan.backward_path`` sends the saved inputs, decided from
their types, shapes and strides before any launch: bf16 inputs on the card
to the hand-written backward kernels (``kops.ssd_scan_backward``, four
launches a layer whatever the chunk), everything else (f32, CPU tensors,
``flags.use_kernels(False)``) to a recompute of the plain chunked math under
autograd, returning ``torch.autograd.grad`` of it: the counterpart of
``jax.grad`` through ``_ssd_chunked``, which is what the reference
differentiates (it has no backward kernel).  Decode is plain tensor code, as
in the reference (which has no decode kernel either).  On DTensors (a
sharded step) the causal conv and the scan run under ``local_map`` on each
rank's rows and heads.

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

from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import logical
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ssd_scan import backward_path, ssd_scan_reference
from repro_torch.models import layers
from repro_torch.obs import trace as _obs_trace
from repro_torch.runtime import flags


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


def _conv_on_local_rows(xbc: torch.Tensor, w: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """``_causal_conv`` on plain tensors; on DTensors, under ``local_map``
    on each rank's rows (the sequence whole, the channels as they lie, the
    weight and bias split as the channels are): a depthwise conv needs no
    other rank's channels, and DTensor's padding op is not one to trust
    with a layout (it loses a mesh axis of the placements in some PyTorch
    versions).  Where the rows are split, the weight's and bias's local
    gradients are partial sums over those axes."""
    if not sharding.is_dtensor(xbc):
        return _causal_conv(xbc, w, b)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    x_pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p
                 for p in xbc.placements)
    chan = [isinstance(p, Shard) and p.dim == 2 for p in x_pl]
    w_pl = tuple(Shard(1) if c else Replicate() for c in chan)
    b_pl = tuple(Shard(0) if c else Replicate() for c in chan)
    return local_map(_causal_conv, out_placements=list(x_pl),
                     in_placements=(x_pl, w_pl, b_pl),
                     in_grad_placements=(
                         x_pl, sharding.partial_over_rows(w_pl, x_pl),
                         sharding.partial_over_rows(b_pl, x_pl)),
                     device_mesh=xbc.device_mesh,
                     redistribute_inputs=True)(xbc, w, b)


class _SSDScan(torch.autograd.Function):
    """y of ``kops.ssd_scan`` (the kernel on a CUDA tensor), differentiable
    through the backward kernels or a recompute of ``ssd_scan_reference``,
    as ``backward_path`` says (the span ``ssd.backward``, its arg ``path``
    ``"kernel"`` or ``"plain"``).  Layouts as the wrapper's: x (Bz,H,L,P),
    dt (Bz,H,L), A (H,), B/C (Bz,G,L,N).  The backward runs under the
    forward's ``flags.use_kernels``: for CUDA tensors autograd runs it on a
    thread of its own, where the thread-local flags are at their
    defaults."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        y, _ = kops.ssd_scan(x, dt, A, B, C, chunk=chunk)
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk, ctx.kernels = chunk, flags.kernels_enabled()
        return y

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        Bz, H, L, P = saved[0].shape
        with flags.use_kernels(ctx.kernels):
            path = backward_path(*saved)
            with _obs_trace.get_tracer().span(
                    "ssd.backward", Bz=Bz, H=H, L=L, P=P, chunk=ctx.chunk,
                    path=path):
                if path == "kernel":
                    grads = kops.ssd_scan_backward(*saved, dy)
                    return (*(g if need else None for g, need in
                              zip(grads, ctx.needs_input_grad)), None)
                inputs = [t.detach().requires_grad_(need) for t, need in
                          zip(saved, ctx.needs_input_grad)]
                with torch.enable_grad():
                    y, _ = ssd_scan_reference(*inputs, chunk=ctx.chunk)
                want = [t for t in inputs if t.requires_grad]
                grads = iter(torch.autograd.grad(y, want, dy))
                return (*(next(grads) if t.requires_grad else None
                          for t in inputs), None)


def _scan(x, dt, A, B, C, chunk: int) -> torch.Tensor:
    """``_SSDScan`` at the autotuner's chunk, resolved here once, as in the
    reference, so that a plain backward recomputes at the chunk the forward
    ran (under autograd the tuner prices the backward too)."""
    chunk = kops.ssd_chunk(x, B, C, chunk=chunk, block_sizes="auto")
    return _SSDScan.apply(x, dt, A, B, C, chunk)


def _scan_on_local_heads(x, dt, A, B, C, chunk: int) -> torch.Tensor:
    """``_scan`` on plain tensors; on DTensors, under ``local_map`` on each
    rank's shard: the batch over the data axes, the SSD heads over the
    model axis, the whole sequence.  B / C hold one entry per group of
    heads: sharded with the heads where the model axis divides the
    groups, else whole, each rank taking the groups its heads read (their
    gradients then partial sums over the model axis); A, which has no
    batch dim, gets a partial gradient over the axes that split the
    batch."""
    if not sharding.is_dtensor(x):
        return _scan(x, dt, A, B, C, chunk)
    from torch.distributed.tensor.experimental import local_map
    ctx = sharding.current()
    heads = ("act_batch", "act_ssm_heads", None, None)
    x_pl = ctx.placements(ctx.act_spec(heads, x.shape))
    dt_pl = ctx.placements(ctx.act_spec(heads[:3], dt.shape))
    a_pl = ctx.placements(ctx.act_spec(heads[1:2], A.shape))
    bc_pl = ctx.placements(ctx.act_spec(heads, B.shape))
    tp = ctx.plan.tp_axis
    split = sharding.is_sharded_on(x_pl, tp, 1) and \
        not sharding.is_sharded_on(bc_pl, tp, 1)
    grad_pl = sharding.partial_on(bc_pl, tp) if split else bc_pl
    rank, n = sharding.axis_index(tp)
    H = x.shape[1]

    def local(xl, dtl, Al, Bl, Cl):
        if split:
            Bl = sharding.groups_of_local_heads(Bl, 1, H, rank, n)
            Cl = sharding.groups_of_local_heads(Cl, 1, H, rank, n)
        return _scan(xl, dtl, Al, Bl, Cl, chunk)

    return local_map(
        local, out_placements=list(x_pl),
        in_placements=(x_pl, dt_pl, a_pl, bc_pl, bc_pl),
        in_grad_placements=(x_pl, dt_pl, sharding.partial_over_rows(
            a_pl, x_pl), grad_pl, grad_pl),
        device_mesh=ctx.mesh, redistribute_inputs=True)(x, dt, A, B, C)


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
        xbc = _conv_on_local_rows(xbc, p.conv_w, p.conv_b)
        xin, Bm, Cm = xbc.split([din, G * N, G * N], dim=-1)
        xin = logical(sharding.split_last(xin, nH, P),
                      ("act_batch", "act_seq", "act_heads", None))
        Bm = sharding.split_last(Bm, G, N)
        Cm = sharding.split_last(Cm, G, N)
        chunk = min(s.chunk, S)
        if S % chunk:
            raise ValueError(
                f"prefill length {S} is not a multiple of the SSD chunk "
                f"{chunk} (the reference asserts the same)")
        # (B, H, S, ·) views, no copies
        xs, Bs, Cs = xin.transpose(1, 2), Bm.transpose(1, 2), \
            Cm.transpose(1, 2)
        y = _scan_on_local_heads(xs, dt.transpose(1, 2), A, Bs, Cs, chunk)
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
        xin = sharding.split_last(xin, nH, P).float()
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
    return p.out_proj(gated_norm(p.norm, y, z, G, cfg.norm_eps)), new_state


def gated_norm(scale: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
               groups: int, eps: float) -> torch.Tensor:
    """Mamba2's gated RMSNorm, the gate before the norm: RMSNorm of
    y · silu(z) over each of ``groups`` equal groups of channels (Mamba2's
    ``RMSNormGated(group_size=d_inner // ngroups)``); one group is the norm
    over all of them.  Sharded over more ranks than divide ``groups``, the
    channels are gathered first (``sharding.split_dim``)."""
    g = y * F.silu(z)
    if groups == 1:
        return layers.rmsnorm(scale, g, eps)
    per = g.shape[-1] // groups
    return sharding.merge_last(layers.rmsnorm(
        sharding.split_dim(scale, 0, groups),
        sharding.split_last(g, groups, per), eps))


def init_ssm_state(cfg, B: int, dtype, device="cuda") -> SSMState:
    s = cfg.ssm
    return SSMState(
        conv=torch.zeros((B, s.d_conv - 1, conv_dim(cfg)), dtype=dtype,
                         device=device),
        h=torch.zeros((B, cfg.ssm_heads, s.head_dim, s.d_state),
                      dtype=torch.float32, device=device),
    )
