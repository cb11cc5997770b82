"""The test-kernel set — paper §5 (held out from fitting).

Four kernels, each with four size cases on a 2^{p+t} ladder:

  * Finite Differences — 5-point stencil + quadratic source on an n×n grid,
    tiled prefetch (halo) into local memory.
  * 'Skinny' Matrix Multiplication — tiled (n × m)(m × l) with n = l = m/8,
    through the hand-written CUDA matmul at the paper's 16×16×16 tile.
  * Convolution — three 7×7 filters applied to three n×n RGB images.
  * N-Body — sum of inverse distances between each of n positions and every
    other position (3×n column-major), block-prefetched.

Exactly as with the measurement kernels, property vectors are extracted
automatically from the ATen graph; tile/prefetch schedules contribute their
local-load/barrier/group properties via the helpers in ``mkernels``.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.core import properties as props
from repro_torch.core.mkernels import (
    GSIZE, Device, KernelCase, _generator, _rand, _tiled_mm, nbody_tile_props,
    stencil_tile_props, tiled_mm_props,
)


# ---------------------------------------------------------------------------
# 1. Finite differences (5-point stencil + quadratic source)
# ---------------------------------------------------------------------------


def _fd_kernel(u):
    """y = u_xx + u_yy (5-point) + u² source, interior points only."""
    c = u[1:-1, 1:-1]
    lap = (u[:-2, 1:-1] + u[2:, 1:-1] + u[1:-1, :-2] + u[1:-1, 2:]
           - 4.0 * c)
    return lap + c * c


def _fd_cases(p: int, gen, device) -> List[KernelCase]:
    cases = []
    for t in range(4):
        n = 2 ** (p + t)
        u = _rand(gen, (n + 2, n + 2), device)
        cases.append(KernelCase(
            name=f"fd_{n}", klass="finite_difference",
            fn=_fd_kernel, args=(u,),
            extra_props=stencil_tile_props(n),
            meta={"n": n}, device=device))
    return cases


# ---------------------------------------------------------------------------
# 2. Skinny matrix multiplication (n = l = m/8)
# ---------------------------------------------------------------------------


def _skinny_cases(p: int, gen, device) -> List[KernelCase]:
    cases = []
    for t in range(4):
        n = 2 ** (p + t)
        m = 8 * n
        a = _rand(gen, (n, m), device)
        b = _rand(gen, (m, n), device)
        cases.append(KernelCase(
            name=f"skinny_mm_{n}x{m}x{n}", klass="skinny_mm",
            fn=_tiled_mm, args=(a, b),
            extra_props=tiled_mm_props(n, m, n),
            meta={"n": n, "m": m, "l": n}, device=device))
    return cases


# ---------------------------------------------------------------------------
# 3. Convolution: three 7×7 filters × three n×n RGB images
# ---------------------------------------------------------------------------

_W = 3  # filter half-width (7 = 2w+1)


def _conv_kernel(imgs, filts):
    """imgs (3, n+2w, n+2w, 3[c]); filts (3, 7, 7, 3) -> r (3, 3, n, n).

    r[i,j,x,y] = Σ_{ξ,η,c} m[i, w+x-ξ, w+y-η, c] · f[j, w+ξ, w+η, c]
    (implemented as a sum of shifted slices — the literal stencil the GPU
    kernel runs, with a multiply-add per filter tap)."""
    n = imgs.shape[1] - 2 * _W
    acc = torch.zeros((imgs.shape[0], filts.shape[0], n, n),
                      dtype=torch.float32, device=imgs.device)
    for dx in range(-_W, _W + 1):
        for dy in range(-_W, _W + 1):
            # m[i, w+x-dx, w+y-dy, c] — a shifted n×n window
            win = imgs[:, _W - dx:_W - dx + n, _W - dy:_W - dy + n, :]
            tap = filts[:, _W + dx, _W + dy, :]  # (3 filters, 3 channels)
            acc = acc + torch.einsum("ixyc,jc->ijxy", win, tap)
    return acc


def _conv_tile_props(n: int) -> dict:
    """Each gsize² tile prefetches interior+halo once per image; every tap
    reads image + filter values from local memory."""
    tiles = 3 * (n // GSIZE) ** 2  # per image
    taps = 49 * 3  # 7×7 × channels
    halo_cells = float(tiles * (4 * GSIZE * _W + 4 * _W * _W) * 3)
    return {
        props.mem_key("load", 32, "s1"): halo_cells,
        props.local_key(32): float(3 * 3 * n * n * taps * 2),  # img+filter reads
        props.BARRIER: float(tiles),
        props.GROUPS: float(tiles),
    }


def _conv_cases(p: int, gen, device) -> List[KernelCase]:
    cases = []
    for t in range(4):
        n = 2 ** (p + t)
        imgs = _rand(gen, (3, n + 2 * _W, n + 2 * _W, 3), device)
        filts = _rand(gen, (3, 7, 7, 3), device)
        cases.append(KernelCase(
            name=f"conv_{n}", klass="convolution",
            fn=_conv_kernel, args=(imgs, filts),
            extra_props=_conv_tile_props(n),
            meta={"n": n}, device=device))
    return cases


# ---------------------------------------------------------------------------
# 4. N-Body (sum of inverse pairwise distances)
# ---------------------------------------------------------------------------


def _nbody_kernel(pos):
    """pos (3, n) -> (n,): Σ_j 1/‖x_i − x_j‖ (j ≠ i)."""
    d = pos[:, :, None] - pos[:, None, :]  # (3, n, n)
    r2 = torch.sum(d * d, dim=0)  # (n, n)
    inv = torch.rsqrt(r2 + 1e-12)
    n = pos.shape[1]
    inv = inv * (1.0 - torch.eye(n, dtype=pos.dtype, device=pos.device))
    return torch.sum(inv, dim=1)


def _nbody_cases(p: int, gen, device) -> List[KernelCase]:
    cases = []
    for t in range(4):
        n = 2 ** (p + t)
        pos = _rand(gen, (3, n), device)
        cases.append(KernelCase(
            name=f"nbody_{n}", klass="nbody",
            fn=_nbody_kernel, args=(pos,),
            extra_props=nbody_tile_props(n),
            meta={"n": n}, device=device))
    return cases


# ---------------------------------------------------------------------------
# Assembly (p per device scale, the paper's per-GPU p choice)
# ---------------------------------------------------------------------------

# 'cpu' and 'tiny' are the reference's; 'gpu' is one H100's (see mkernels)
_P = {
    "cpu":  {"fd": 9, "skinny": 7, "conv": 7, "nbody": 10},
    "tiny": {"fd": 6, "skinny": 4, "conv": 4, "nbody": 6},
    "gpu":  {"fd": 11, "skinny": 8, "conv": 8, "nbody": 11},
}


def test_cases(scale: str = "cpu", seed: int = 17,
               device: Device = "cuda") -> List[KernelCase]:
    """The 4 held-out kernels at ``scale``, their tensors made on
    ``device`` from ``seed``."""
    P = _P[scale]
    gens = [_generator(seed * 8 + i, device) for i in range(4)]
    cases: List[KernelCase] = []
    cases += _fd_cases(P["fd"], gens[0], device)
    cases += _skinny_cases(P["skinny"], gens[1], device)
    cases += _conv_cases(P["conv"], gens[2], device)
    cases += _nbody_cases(P["nbody"], gens[3], device)
    return cases
