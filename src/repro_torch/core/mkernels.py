"""The measurement-kernel library — paper §4.1 (9 classes).

Each class yields several ``KernelCase``s (shape × size sweep).  Property
vectors are extracted *automatically* from the ATen graph
(``core.extract``); tiled kernels additionally declare their
schedule-derived properties (local-memory loads, barriers, group counts,
tile re-reads) through the ``tiled_*_props`` helpers — the analog of the
paper needing the Loopy *schedule* to count barriers (§3.2).

Problem sizes follow the paper's 2^{p+t} ladders, with ``p`` chosen per
device scale the way the paper chose p per GPU: large enough to exceed
launch overhead, small enough to fit memory and a sane wall-clock budget.
``"gpu"`` is the ladder of one H100; ``"cpu"`` and ``"tiny"`` are the
reference's.

The reference's kernels express the *algorithm the GPU kernel would run*
(strides, tiling) in jnp, which XLA may compile differently.  Here the two
tiled classes run that algorithm: ``mm_tiled`` calls the hand-written CUDA
matmul at the paper's 16×16×16 tile and the tiled ``transpose`` the CUDA
transpose at a 16×16 tile, so the schedule ``tiled_mm_props`` and
``tiled_transpose_props`` declare is the schedule that runs.  Everything
else is eager PyTorch, one launch per ATen op, and the model is fitted to
this device's sustained rates for each property — the paper's black-box
premise.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.core import extract
from repro_torch.core import properties as props
from repro_torch.kernels import ops as kops

GSIZE = 16           # 2-D tile edge (16×16 = 256-lane groups, paper's 2-D Med)
GROUP_1D = 256       # 1-D group size

Device = Union[str, torch.device]


@dataclass
class KernelCase:
    name: str
    klass: str                     # measurement class id
    fn: Callable                   # fn(*args) -> tensor
    args: Tuple                    # staged inputs, on ``device``
    extra_props: Dict[str, float] = field(default_factory=dict)
    meta: Dict[str, object] = field(default_factory=dict)
    device: Device = "cuda"

    _pv: Optional[Dict[str, float]] = None
    _jitted: Optional[Callable] = None

    def properties(self) -> Dict[str, float]:
        """The property vector, extracted from the ATen graph of ``fn`` on
        CPU stand-ins of ``args`` (kernel wrappers take their plain
        versions; nothing runs on the card).  A function that makes its own
        tensors takes them from a ``device`` keyword and is traced with
        ``device="cpu"``."""
        if self._pv is None:
            fn = self.fn
            if isinstance(fn, functools.partial) and "device" in fn.keywords:
                fn = functools.partial(fn, device="cpu")
            pv = extract.extract_graph(fn, *self.args,
                                       extra_props=self.extra_props)
            if props.GROUPS in self.extra_props:
                # explicit schedule-declared group count replaces the nominal
                pv[props.GROUPS] = self.extra_props[props.GROUPS]
            self._pv = pv
        return self._pv

    def jitted(self) -> Callable:
        """The zero-argument call on the staged tensors (the reference's
        jitted callable; PyTorch runs it eagerly, nothing is compiled)."""
        if self._jitted is None:
            fn, args = self.fn, self.args
            self._jitted = lambda: fn(*args)
        return self._jitted


def _rand(gen: torch.Generator, shape, device: Device,
          dtype=torch.float32) -> torch.Tensor:
    """Uniform in [0.1, 1.0), as the reference's ``_rand``, made on the
    device from the generator."""
    return torch.rand(shape, generator=gen, device=device,
                      dtype=dtype) * 0.9 + 0.1


def _generator(seed: int, device: Device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


# ---------------------------------------------------------------------------
# Schedule-derived property helpers (tiling visible only to the scheduler)
# ---------------------------------------------------------------------------


def tiled_mm_props(n: int, m: int, l: int, gs: int = GSIZE) -> Dict[str, float]:
    """GPU tiled matmul: each (i,j) group re-fetches its A-row / B-col tiles.

    Global loads beyond the single graph-visible read:
      A is read l/gs times, B n/gs times (s1, coalesced tile rows).
    Local loads: every MAC reads its 2 operands from the tile in local
    memory: 2·n·l·m.  Barriers: one per k-step per group = (m/gs)·(n·l/gs²).
    """
    groups = (n // gs) * (l // gs)
    extra_a = n * m * (l // gs - 1)
    extra_b = m * l * (n // gs - 1)
    return {
        props.mem_key("load", 32, "s1"): float(max(extra_a, 0) + max(extra_b, 0)),
        props.local_key(32): 2.0 * n * l * m,
        props.BARRIER: float((m // gs) * groups),
        props.GROUPS: float(groups),
    }


def tiled_transpose_props(n: int, gs: int = GSIZE) -> Dict[str, float]:
    """Prefetched transpose: tile in (s1 read), barrier, tile out (s1 write).
    Each element passes through local memory once."""
    groups = (n // gs) ** 2
    return {
        props.local_key(32): float(n * n),
        props.BARRIER: float(groups),
        props.GROUPS: float(groups),
    }


def stencil_tile_props(n: int, gs: int = GSIZE, halo: int = 1) -> Dict[str, float]:
    """FD tile prefetch: interior + halo cells per tile; 5 local reads/cell."""
    tiles = (n // gs) ** 2
    halo_cells = float(tiles * (4 * gs * halo + 4 * halo * halo))
    return {
        props.mem_key("load", 32, "s1"): halo_cells,  # halo re-reads
        props.local_key(32): 5.0 * n * n,
        props.BARRIER: float(tiles),
        props.GROUPS: float(tiles),
    }


def nbody_tile_props(n: int, gs: int = GROUP_1D) -> Dict[str, float]:
    """N-body: position blocks are prefetched (3×gs) per group per block;
    every pair interaction reads 3 coords from local memory."""
    groups = n // gs
    return {
        props.mem_key("load", 32, "s1"): float(3 * n * (groups - 1)),
        props.local_key(32): float(3 * n * n),
        props.BARRIER: float(groups * (n // gs)),
        props.GROUPS: float(groups),
    }


# ---------------------------------------------------------------------------
# 1+2. Matrix multiplication (tiled + naive)
# ---------------------------------------------------------------------------


def _tiled_mm(a, b):
    """The hand-written CUDA matmul at the paper's 16×16×16 tile."""
    return kops.matmul(a, b, block_m=GSIZE, block_n=GSIZE, block_k=GSIZE)


def _naive_mm(a, b):
    return a @ b


def _mm_cases(tiled: bool, p: int, gen, device) -> List[KernelCase]:
    cases = []
    shapes = []
    for t in range(4):
        n = 2 ** (p + t)
        shapes += [(n, n, n), (n, n, n // 2), (n, n // 2, n), (n // 2, n, n)]
    if not tiled:  # naive: square only (paper)
        shapes = [(2 ** (p + t),) * 3 for t in range(4)]
    for i, (n, m, l) in enumerate(shapes):
        a = _rand(gen, (n, m), device)
        b = _rand(gen, (m, l), device)
        extra = tiled_mm_props(n, m, l) if tiled else {}
        klass = "mm_tiled" if tiled else "mm_naive"
        cases.append(KernelCase(
            name=f"{klass}_{n}x{m}x{l}", klass=klass,
            fn=_tiled_mm if tiled else _naive_mm, args=(a, b),
            extra_props=extra, meta={"n": n, "m": m, "l": l},
            device=device))
    return cases


# ---------------------------------------------------------------------------
# 3. Vector scale and add (strides 1/2/3)
# ---------------------------------------------------------------------------


def _vsa(a, b, *, s: int, lim: int):
    return 2.5 * a[0:lim:s] + 1.5 * b[0:lim:s]


def _vsa_cases(p: int, gen, device) -> List[KernelCase]:
    cases = []
    for stride in (1, 2, 3):
        for t in range(4):
            n = 2 ** (p + 2 * t)
            a = _rand(gen, (n * stride,), device)
            b = _rand(gen, (n * stride,), device)
            cases.append(KernelCase(
                name=f"vsa_s{stride}_n{n}", klass="vector_scale_add",
                fn=functools.partial(_vsa, s=stride, lim=n * stride),
                args=(a, b), meta={"n": n, "stride": stride}, device=device))
    return cases


# ---------------------------------------------------------------------------
# 4. Transpose (3 variants)
# ---------------------------------------------------------------------------


def _tiled_transpose(x):
    """The hand-written CUDA transpose at a 16×16 tile; it materialises the
    result itself, so the reference's ``+ 0.0`` is not needed."""
    return kops.transpose(x, block=GSIZE)


def _plain_transpose(x):
    return x.t() + 0.0


def _scatter_transpose(x, *, n: int):
    i = torch.arange(n * n, device=x.device)
    dest = (i % n) * n + i // n
    return torch.zeros((n * n,), dtype=x.dtype, device=x.device).scatter(
        0, dest, x.reshape(-1))


def _transpose_cases(p: int, gen, device) -> List[KernelCase]:
    cases = []
    for t in range(4):
        n = 2 ** (p + t)
        x = _rand(gen, (n, n), device)

        # v1: prefetch-tiled (s1 reads AND writes; local memory round-trip)
        cases.append(KernelCase(
            name=f"transpose_tiled_{n}", klass="transpose",
            fn=_tiled_transpose, args=(x,),
            extra_props={
                **tiled_transpose_props(n),
                # the tile pass converts the gather-read into s1 read+write
                props.mem_key("load", 32, "s1"): float(n * n),
                props.mem_key("load", 32, "gather"): -float(n * n),
            },
            meta={"n": n, "variant": "tiled"}, device=device))

        # v2: no prefetch — s1 writes, uncoalesced reads
        cases.append(KernelCase(
            name=f"transpose_plain_{n}", klass="transpose",
            fn=_plain_transpose, args=(x,),
            meta={"n": n, "variant": "plain"}, device=device))

        # v3: no prefetch — s1 reads, uncoalesced (scatter) writes
        cases.append(KernelCase(
            name=f"transpose_scatter_{n}", klass="transpose",
            fn=functools.partial(_scatter_transpose, n=n), args=(x,),
            meta={"n": n, "variant": "scatter"}, device=device))
    return cases


# ---------------------------------------------------------------------------
# 5. Stride-1 global access (copy / 4-add / index store)
# ---------------------------------------------------------------------------


def _copy(a):
    return a + 0.0


def _add4(a, b, c, d):
    return a + b + c + d


def _store_iota(*, n: int, device: Device):
    return torch.arange(n, dtype=torch.float32, device=device) + 0.0


def _stride1_cases(p: int, gen, device) -> List[KernelCase]:
    cases = []
    for t in range(0, 9, 2):  # 5 of the paper's 9 ladder points
        n = 2 ** (p + t)
        arrs = [_rand(gen, (n,), device) for _ in range(4)]
        cases.append(KernelCase(
            name=f"s1_copy_{n}", klass="stride1_global",
            fn=_copy, args=(arrs[0],), meta={"n": n}, device=device))
        cases.append(KernelCase(
            name=f"s1_add4_{n}", klass="stride1_global",
            fn=_add4, args=tuple(arrs[:4]), meta={"n": n}, device=device))
        cases.append(KernelCase(
            name=f"s1_store_iota_{n}", klass="stride1_global",
            fn=functools.partial(_store_iota, n=n, device=device),
            args=(), meta={"n": n}, device=device))
    return cases


# ---------------------------------------------------------------------------
# 6+7. Stride-2 / stride-3 *filled* access (all phases touched)
# ---------------------------------------------------------------------------


def _filled(a, *, s: int, n: int, R: int):
    phases = [a[i:i + s * n - s + 1:s] for i in range(s)]
    ps = sum(phases)  # pairwise/trio-wise sums (n,)
    return ps.reshape(n // R, R).sum(dim=1)


def _filled_cases(stride: int, p: int, gen, device) -> List[KernelCase]:
    cases = []
    R = 256  # pair-sums reduced per output element (paper's 256)
    for t in range(3):
        n = 2 ** (p + t)
        a = _rand(gen, (stride * n,), device)
        cases.append(KernelCase(
            name=f"filled_s{stride}_n{n}", klass=f"stride{stride}_filled",
            fn=functools.partial(_filled, s=stride, n=n, R=R), args=(a,),
            meta={"n": n, "stride": stride}, device=device))
    return cases


# ---------------------------------------------------------------------------
# 8. Arithmetic operations (per kind, no global reads)
# ---------------------------------------------------------------------------


_ARITH_EXPRS = {
    # each body applies 6-10 ops of one kind to the lane value (paper §4.1)
    "add": lambda x, q: x + q + 1.0 + (x - 2.0) + (q - x) + (x + 0.5) + q,
    "mul": lambda x, q: x * q * 1.01 * (x * 0.99) * (q * 1.02) * (x * 0.5),
    "div": lambda x, q: ((((x / (q + 1.0)) / 1.01) / (x + 2.0)) / 0.99) / 1.5,
    "exp": lambda x, q: torch.exp(-x) + torch.exp(-q) + torch.exp(-(x + q) * 0.5),
    "rsqrt": lambda x, q: (torch.rsqrt(x + 1.0) + torch.rsqrt(q + 2.0)
                           + torch.rsqrt(x + q + 3.0)),
}


def _arith(*, kind: str, n: int, k_red: int, device: Device):
    """The reference's ``lax.scan`` over ``k_red`` steps, as a Python loop
    (the trace unrolls it, so the counts carry the trip count)."""
    base = torch.arange(n * n, dtype=torch.float32,
                        device=device).reshape(n, n) * 1e-6 + 0.5
    qs = torch.arange(k_red, dtype=torch.float32, device=device) * 1e-3 + 0.25
    acc = torch.zeros((n, n), dtype=torch.float32, device=device)
    for i in range(k_red):
        acc = acc + _ARITH_EXPRS[kind](base, qs[i])
    return acc


def _arith_cases(p: int, device) -> List[KernelCase]:
    cases = []
    for kind in _ARITH_EXPRS:
        for t in range(3):
            n = 2 ** (p + t)
            k_red = 64  # reduction length (paper: 256..728; CPU-scaled)
            cases.append(KernelCase(
                name=f"arith_{kind}_n{n}", klass="arith",
                fn=functools.partial(_arith, kind=kind, n=n, k_red=k_red,
                                     device=device),
                args=(), meta={"n": n, "kind": kind, "k": k_red},
                device=device))
    return cases


# ---------------------------------------------------------------------------
# 9. Empty kernel (launch overhead)
# ---------------------------------------------------------------------------


def _empty(*, device: Device):
    return torch.zeros((), dtype=torch.float32, device=device)


def _empty_cases(p: int, device) -> List[KernelCase]:
    cases = []
    for t in range(0, 6, 2):
        n = 2 ** (p + t)
        groups = (n // GSIZE) ** 2
        cases.append(KernelCase(
            name=f"empty_{n}", klass="empty",
            fn=functools.partial(_empty, device=device), args=(),
            extra_props={props.GROUPS: float(groups)},
            meta={"n": n}, device=device))
    return cases


# ---------------------------------------------------------------------------
# Assembly
# ---------------------------------------------------------------------------

# p-ladders per device scale; 'cpu' and 'tiny' are the reference's (sizes for
# 1–50 ms/kernel on a container CPU, and a smoke scale); 'gpu' is one H100's:
# every case well above the launch overhead and at most ~50 ms (PERF.md lists
# the resulting sizes and times)
_P = {
    "cpu":  {"mm": 7, "naive": 7, "vsa": 16, "transpose": 9, "s1": 14,
             "filled": 15, "arith": 7, "empty": 8},
    "tiny": {"mm": 5, "naive": 5, "vsa": 8, "transpose": 6, "s1": 8,
             "filled": 10, "arith": 4, "empty": 6},
    "gpu":  {"mm": 9, "naive": 10, "vsa": 20, "transpose": 11, "s1": 22,
             "filled": 22, "arith": 10, "empty": 10},
}

SCALES = tuple(_P)


def measurement_cases(scale: str = "cpu", seed: int = 0,
                      device: Device = "cuda") -> List[KernelCase]:
    """The 9 classes at ``scale``, their tensors made on ``device`` from
    ``seed``."""
    P = _P[scale]
    gens = [_generator(seed * 8 + i, device) for i in range(7)]
    cases: List[KernelCase] = []
    cases += _mm_cases(True, P["mm"], gens[0], device)
    cases += _mm_cases(False, P["naive"], gens[1], device)
    cases += _vsa_cases(P["vsa"], gens[2], device)
    cases += _transpose_cases(P["transpose"], gens[3], device)
    cases += _stride1_cases(P["s1"], gens[4], device)
    cases += _filled_cases(2, P["filled"], gens[5], device)
    cases += _filled_cases(3, P["filled"], gens[6], device)
    cases += _arith_cases(P["arith"], device)
    cases += _empty_cases(P["empty"], device)
    return cases
