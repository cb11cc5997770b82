"""Array-batched search-space engine: score a whole (plan × mesh ×
block-size) candidate space in one vectorized pass.

The paper's payoff is that prediction is "a small inner product" — cheap
enough to sweep entire configuration spaces (§6.2).  ``predict_plans``
already batched the final ``A @ w``; this module batches everything
*upstream* of it, so a sweep of thousands of (plan, mesh-factorization)
cells runs as array ops end to end with no per-candidate Python:

  * candidate sets are struct-of-arrays (``PlanSpace``): parallel numpy
    arrays of dp/tp ways, device counts and microbatches next to the plan
    objects themselves;
  * step property vectors evaluate through the COMPILED
    ``predictor.step_vector_fn`` closures (``symcount.Expr.compile`` — the
    ≥10× fast path proven in the block-size autotuner), one call per
    distinct remat schedule with the microbatch column as an array env;
  * collective counts compile once per (kind, topology-class)
    (``archcount.collective_counts_symbolic``) with the mesh gates lowered
    to ``np.where`` over the DP/TP arrays;
  * HBM feasibility (``peak_bytes`` / ``feasible_mask``) is a single numpy
    pass over the candidate arrays, not a per-plan list comprehension.

Consumers: ``launch/autoshard.py`` (plan × mesh sweep + optional kernel
block co-tuning), ``distributed/elastic.replan`` and
``runtime/straggler.StragglerMonitor.from_model`` (both via
``predictor.predict_plans``, which routes here).

A copy of the reference's ``core/planspace.py``; the reference's
``benchmarks/search_bench.py`` times that engine against the per-plan
interpreted loop (``predictor.predict_plans_loop``).  The kernel-block
co-tuning hook (``cotune_kernel_blocks``) tunes over the CUDA sources'
tiles unless given the reference's grids.  ``feasible_mask`` keeps the
reference's default budget (``predictor.HBM_BYTES``, catalog data for
another device); a caller on the card passes the card's memory.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from math import prod
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core import archcount
from repro_torch.core import exprops
from repro_torch.core import predictor
from repro_torch.core import properties as props
from repro_torch.core import workload as wl
from repro_torch.core.lru import LRUCache
from repro_torch.core.workload import WorkloadSpec
from repro_torch.obs import trace as _obs_trace

Mesh = Dict[str, int]
Cell = Tuple[object, Mapping[str, int]]  # (Plan, mesh_shape)

#: (cfg, kind, topology-class) -> CompiledVector over {B, S, M, DP, TP}.
#: Bounded: configs come and go (smoke variants, sweeps over reduced archs)
#: and each entry pins a whole ArchConfig, so evict beyond recent use.
_COLL_CV_CACHE: LRUCache = LRUCache(maxsize=128)

#: (cfg, kind, topology-class) -> exprops.BasisProgram (the fused form).
_COLL_PROG_CACHE: LRUCache = LRUCache(maxsize=128)


def _collective_vector_fn(cfg: ArchConfig, kind: str, topology):
    from repro_torch.core.symcount import compile_vector
    key = (cfg, kind, topology)
    cv = _COLL_CV_CACHE.get(key)
    if cv is None:
        cv = compile_vector(
            archcount.collective_counts_symbolic(cfg, kind, topology))
        _COLL_CV_CACHE[key] = cv
    return cv


def _collective_program(cfg: ArchConfig, kind: str, topology):
    """Fused basis program for one (kind, topology-class): the symbolic
    collectives canonicalized + CSE'd into one GEMV scorer, persisted in
    the on-disk compile cache like the step programs."""
    key = (cfg, kind, topology)
    prog = _COLL_PROG_CACHE.get(key)
    if prog is None:
        dk = exprops.program_key("coll", cfg, kind, topology)
        prog = exprops.load_or_build(
            dk, lambda: archcount.collective_counts_symbolic(cfg, kind,
                                                             topology))
        _COLL_PROG_CACHE[key] = prog
    return prog


# ---------------------------------------------------------------------------
# Mesh-factorization space (promoted from distributed/elastic.py)
# ---------------------------------------------------------------------------


def factor_pairs(n: int) -> List[Tuple[int, int]]:
    """All ordered (a, b) with a·b == n — the 2-axis mesh factorizations."""
    out = []
    d = 1
    while d * d <= n:
        if n % d == 0:
            out.append((d, n // d))
            if d != n // d:
                out.append((n // d, d))
        d += 1
    return sorted(set(out))


def mesh_factorizations(n_devices: int,
                        axes: Tuple[str, str] = ("data", "model"),
                        max_candidates: Optional[int] = None) -> List[Mesh]:
    """Every 2-axis mesh shape with ``n_devices`` chips — the sweep space
    ``autoshard.search(n_devices=...)`` and ``elastic.replan`` score."""
    if len(axes) != 2:
        raise ValueError(f"mesh_factorizations is 2-axis; got {axes!r}")
    pairs = factor_pairs(n_devices)
    if max_candidates is not None:
        pairs = pairs[:max_candidates]
    return [{axes[0]: a, axes[1]: b} for a, b in pairs]


# ---------------------------------------------------------------------------
# The candidate space
# ---------------------------------------------------------------------------


def _axis_product(mesh: Mapping[str, int], axes) -> int:
    out = 1
    for ax in axes:
        out *= mesh.get(ax, 1)
    return out


def _group_indices(keys: Sequence) -> Dict[object, np.ndarray]:
    groups: Dict[object, List[int]] = {}
    for i, k in enumerate(keys):
        groups.setdefault(k, []).append(i)
    return {k: np.asarray(v, dtype=np.intp) for k, v in groups.items()}


def plan_sort_key(plan) -> tuple:
    """Deterministic, enumeration-order-free ordering of plans — the
    tie-break ``rank_plans`` / ``PlanSpace.rank`` apply after seconds."""
    return (plan.fsdp, plan.sequence_parallel, plan.microbatches,
            plan.remat_policy or "", plan.compression or "",
            plan.moe_mode, plan.dp_axes, plan.tp_axis or "",
            plan.cache_seq_axes)


def mesh_sort_key(mesh: Mapping[str, int]) -> tuple:
    return tuple(sorted(mesh.items()))


def _key_column(objs: Sequence, keyfn) -> np.ndarray:
    """Sort-key tuples → an int64 ordinal column whose numeric order is the
    tuples' lexicographic order (equal tuples ⇒ equal ordinals) — what lets
    ``np.lexsort`` replace a Python tuple-key sort.  Key computation is
    memoized per object identity: candidate spaces repeat a small set of
    plan/mesh objects across many cells."""
    memo: Dict[int, tuple] = {}
    keys = []
    for o in objs:
        k = memo.get(id(o))
        if k is None:
            k = keyfn(o)
            memo[id(o)] = k
        keys.append(k)
    rank = {k: i for i, k in enumerate(sorted(set(keys)))}
    return np.asarray([rank[k] for k in keys], dtype=np.int64)


def _rank_order(secs: np.ndarray, plans: Sequence,
                meshes: Sequence[Mapping[str, int]]) -> np.ndarray:
    """The ``rank`` ordering as one vectorized ``np.lexsort`` over
    (seconds, plan-key ordinal, mesh-key ordinal) — identical to sorting
    with ``key=lambda i: (secs[i], plan_sort_key(...), mesh_sort_key(...))``
    and pinned against that reference in tests."""
    return np.lexsort((_key_column(meshes, mesh_sort_key),
                       _key_column(plans, plan_sort_key),
                       secs))


@dataclass
class _ProductInfo:
    """The factored structure of a ``from_product`` space — what lets the
    fused scorer evaluate per (plan-profile × mesh) instead of per cell.

    A product space's environment columns are rank-1: every step-term row
    repeats one of ``n_plans`` microbatch counts, every collective row is
    one of a handful of (microbatches, dp-axes, tp-axis) *profiles* crossed
    with the mesh list.  Scoring therefore needs one program evaluation of
    size ≈ n_profiles·n_meshes per group, expanded to cells by
    repeat/tile-shaped gathers — the basis matrix never reaches n_cells
    rows."""
    n_m: int
    mesh_ndev: np.ndarray                     # (n_m,)
    dp_rows: Dict[tuple, np.ndarray]          # dp_axes -> (n_m,)
    tp_rows: Dict[Optional[str], np.ndarray]  # tp_axis -> (n_m,)
    plan_mb: np.ndarray                       # (n_p,)
    plan_dp_axes: List[tuple]
    plan_tp_axis: List[Optional[str]]
    remat_plan_groups: Dict[object, np.ndarray]  # PLAN (not cell) indices
    topo_plan_groups: Dict[object, np.ndarray]
    #: lazily built evaluation structure (model-independent): see
    #: ``step_envs`` / ``topo_envs``
    _step_envs: Optional[list] = field(default=None, repr=False)
    _topo_envs: Optional[tuple] = field(default=None, repr=False)

    def step_envs(self) -> list:
        """[(remat, plan-idx array, unique microbatches, inverse)] — the
        distinct step environments per remat schedule."""
        if self._step_envs is None:
            out = []
            for remat, pidx in self.remat_plan_groups.items():
                mbs = self.plan_mb[pidx].tolist()
                umb = sorted(set(mbs))
                pos = {v: i for i, v in enumerate(umb)}
                inv = np.asarray([pos[v] for v in mbs], dtype=np.intp)
                out.append((remat, pidx, np.asarray(umb, dtype=np.int64),
                            inv))
            self._step_envs = out
        return self._step_envs

    def topo_envs(self) -> tuple:
        """(per-group [(topo, n_prof, M, DP, TP columns)], global plan →
        profile-row index) — the (profile × mesh) collective environments,
        rows concatenated across topology groups."""
        if self._topo_envs is None:
            n_m = self.n_m
            mb_l = self.plan_mb.tolist()
            prof_row = np.empty(len(mb_l), dtype=np.intp)
            groups = []
            base = 0
            for topo, pidx in self.topo_plan_groups.items():
                profiles: Dict[tuple, int] = {}
                envs: List[tuple] = []
                for p in pidx.tolist():
                    key = (mb_l[p], self.plan_dp_axes[p],
                           self.plan_tp_axis[p])
                    k = profiles.get(key)
                    if k is None:
                        k = profiles[key] = len(envs)
                        envs.append(key)
                    prof_row[p] = base + k
                n_prof = len(envs)
                Mc = np.empty(n_prof * n_m, dtype=np.int64)
                DPc = np.empty(n_prof * n_m, dtype=np.int64)
                TPc = np.empty(n_prof * n_m, dtype=np.int64)
                for k, (mb, dpa, tpa) in enumerate(envs):
                    sl = slice(k * n_m, (k + 1) * n_m)
                    Mc[sl] = mb
                    DPc[sl] = self.dp_rows[dpa]
                    TPc[sl] = self.tp_rows[tpa]
                groups.append((topo, n_prof, Mc, DPc, TPc))
                base += n_prof
            self._topo_envs = (groups, prof_row, base)
        return self._topo_envs


@dataclass
class PlanSpace:
    """A candidate set of (plan, mesh) cells as struct-of-arrays.

    ``plans[i]`` / ``mesh_shapes[i]`` describe cell *i*; the numpy columns
    (``dp``, ``tp``, ``n_dev``, ``microbatches``) are what the vectorized
    evaluators consume.  Build with ``from_cells`` / ``from_product`` —
    both accept any ``workload.WorkloadLike`` (a ``WorkloadSpec``, a
    ``ShapeConfig``, or the deprecated phase string) and normalize it.
    """
    cfg: ArchConfig
    workload: WorkloadSpec
    plans: List[object]
    mesh_shapes: List[Mesh]
    dp: np.ndarray            # data-parallel ways per cell (int64)
    tp: np.ndarray            # tensor-parallel ways per cell (int64)
    n_dev: np.ndarray         # total devices per cell (int64)
    microbatches: np.ndarray  # grad-accumulation chunks per cell (int64)
    #: optional precomputed cell-index groups (set by ``from_product``,
    #: which derives them from the small plan list instead of walking all
    #: n_plans × n_meshes cells): {group_key: (n_group_cells,) intp}
    remat_groups: Optional[Dict[object, np.ndarray]] = field(default=None)
    topo_groups: Optional[Dict[object, np.ndarray]] = field(default=None)
    #: set by ``from_product`` only; ``subset`` drops it (a filtered space
    #: loses the rank-1 structure) and the scorers fall back to the generic
    #: unique-row path
    product: Optional[_ProductInfo] = field(default=None, repr=False)
    #: per-space memo of the group → BasisProgram lookups (saves re-hashing
    #: the frozen ArchConfig key on every repeat ``scores`` call)
    _progs: Dict[object, object] = field(default_factory=dict, repr=False)

    @property
    def shape(self) -> WorkloadSpec:
        """Backward-compat alias: the workload duck-types the old
        ``ShapeConfig`` attribute surface (``kind``/``global_batch``/
        ``seq_len``)."""
        return self.workload

    def _group_program(self, group_key, remat) -> object:
        prog = self._progs.get(group_key)
        if prog is None:
            if group_key[0] == "step":
                prog = predictor.step_program(self.cfg, self.workload,
                                              remat)
            else:
                prog = _collective_program(self.cfg, self.workload.phase,
                                           remat)
            self._progs[group_key] = prog
        return prog

    # -- construction ------------------------------------------------------
    @classmethod
    def from_cells(cls, cfg: ArchConfig, workload: wl.WorkloadLike,
                   cells: Sequence[Cell]) -> "PlanSpace":
        spec = wl.as_spec(workload)
        plans = [p for p, _ in cells]
        meshes = [dict(m) for _, m in cells]
        dp = np.asarray([_axis_product(m, p.dp_axes)
                         for p, m in zip(plans, meshes)], dtype=np.int64)
        tp = np.asarray([m.get(p.tp_axis, 1) if p.tp_axis else 1
                         for p, m in zip(plans, meshes)], dtype=np.int64)
        n_dev = np.asarray([max(prod(m.values()), 1) if m else 1
                            for m in meshes], dtype=np.int64)
        mb = np.asarray([p.microbatches for p in plans], dtype=np.int64)
        return cls(cfg=cfg, workload=spec, plans=plans, mesh_shapes=meshes,
                   dp=dp, tp=tp, n_dev=n_dev, microbatches=mb)

    @classmethod
    def from_product(cls, cfg: ArchConfig, workload: wl.WorkloadLike,
                     plans: Sequence, meshes: Sequence[Mapping[str, int]]
                     ) -> "PlanSpace":
        """Plan-major cross product: cell (i·len(meshes) + j) = plan i on
        mesh j — so a single-mesh product keeps the plans' order.

        The struct-of-arrays columns come from ``np.repeat``/``np.tile``
        of the per-plan and per-mesh vectors — O(n_plans + n_meshes)
        Python, not O(n_cells) — and the evaluation groups (remat
        schedule, collective topology class) are computed on the plan
        list and expanded arithmetically."""
        spec = wl.as_spec(workload)
        plans = list(plans)
        meshes = [dict(m) for m in meshes]
        n_p, n_m = len(plans), len(meshes)
        mesh_ndev = np.asarray([max(prod(m.values()), 1) if m else 1
                                for m in meshes], dtype=np.int64)
        dp_rows: Dict[tuple, np.ndarray] = {}
        tp_rows: Dict[Optional[str], np.ndarray] = {}
        for p in plans:
            if p.dp_axes not in dp_rows:
                dp_rows[p.dp_axes] = np.asarray(
                    [_axis_product(m, p.dp_axes) for m in meshes],
                    dtype=np.int64)
            if p.tp_axis not in tp_rows:
                tp_rows[p.tp_axis] = np.asarray(
                    [m.get(p.tp_axis, 1) if p.tp_axis else 1
                     for m in meshes], dtype=np.int64)
        dp = np.concatenate([dp_rows[p.dp_axes] for p in plans]) \
            if n_p else np.zeros(0, dtype=np.int64)
        tp = np.concatenate([tp_rows[p.tp_axis] for p in plans]) \
            if n_p else np.zeros(0, dtype=np.int64)
        n_dev = np.tile(mesh_ndev, n_p)
        plan_mb = np.asarray([p.microbatches for p in plans],
                             dtype=np.int64)
        mb = np.repeat(plan_mb, n_m)

        def expand(groups: Dict[object, np.ndarray]):
            j = np.arange(n_m, dtype=np.intp)
            return {k: (idx[:, None] * n_m + j).ravel()
                    for k, idx in groups.items()}
        remat_p = _group_indices([p.remat_policy for p in plans])
        topo_p = _group_indices(
            [archcount.collective_topology(p) for p in plans])
        info = _ProductInfo(
            n_m=n_m, mesh_ndev=mesh_ndev, dp_rows=dp_rows, tp_rows=tp_rows,
            plan_mb=plan_mb,
            plan_dp_axes=[p.dp_axes for p in plans],
            plan_tp_axis=[p.tp_axis for p in plans],
            remat_plan_groups=remat_p, topo_plan_groups=topo_p)
        return cls(cfg=cfg, workload=spec,
                   plans=[p for p in plans for _ in range(n_m)],
                   mesh_shapes=meshes * n_p,
                   dp=dp, tp=tp, n_dev=n_dev, microbatches=mb,
                   remat_groups=expand(remat_p), topo_groups=expand(topo_p),
                   product=info)

    def __len__(self) -> int:
        return len(self.plans)

    def subset(self, idx) -> "PlanSpace":
        """Cells at ``idx`` (a boolean mask or an array of UNIQUE cell
        indices, in any order) as a new space."""
        idx = np.asarray(idx)
        if idx.dtype == bool:
            idx = np.nonzero(idx)[0]

        def remap(groups):
            # old cell index -> position in the subset (O(n) numpy), so a
            # feasibility-filtered space keeps its precomputed groups
            # instead of re-walking every surviving cell in Python
            if groups is None:
                return None
            pos = np.full(len(self), -1, dtype=np.intp)
            pos[idx] = np.arange(len(idx), dtype=np.intp)
            out = {}
            for k, g in groups.items():
                kept = pos[g]
                kept = kept[kept >= 0]
                if len(kept):
                    out[k] = kept
            return out

        return PlanSpace(
            cfg=self.cfg, workload=self.workload,
            plans=[self.plans[i] for i in idx],
            mesh_shapes=[self.mesh_shapes[i] for i in idx],
            dp=self.dp[idx], tp=self.tp[idx], n_dev=self.n_dev[idx],
            microbatches=self.microbatches[idx],
            remat_groups=remap(self.remat_groups),
            topo_groups=remap(self.topo_groups))

    # -- vectorized property assembly --------------------------------------
    def property_arrays(self) -> Dict[str, np.ndarray]:
        """The whole candidate set's property vectors as columns:
        ``{key: (n_cells,) float64}``.  Row i of the implied matrix equals
        ``predictor.plan_property_vector`` for cell i (absent keys = 0)."""
        n = len(self)
        base_env = self.workload.env(self.cfg)
        out: Dict[str, np.ndarray] = {}

        def acc(key: str, idx: np.ndarray, vals: np.ndarray) -> None:
            col = out.get(key)
            if col is None:
                col = np.zeros(n, dtype=np.float64)
                out[key] = col
            col[idx] += vals

        # step terms: one compiled evaluation per distinct remat schedule,
        # microbatches as an array env; compute/memory divide over the mesh
        remat_groups = self.remat_groups if self.remat_groups is not None \
            else _group_indices([p.remat_policy for p in self.plans])
        for remat, idx in remat_groups.items():
            cv = predictor.step_vector_fn(self.cfg, self.workload, remat)
            env = {**base_env, "M": self.microbatches[idx]}
            for k, v in cv(env).items():
                v = np.broadcast_to(
                    np.asarray(v, dtype=np.float64), idx.shape)
                acc(k, idx, v / self.n_dev[idx])

        # collective terms: one compiled evaluation per topology class,
        # already per-device (DP/TP gates lowered to np.where)
        topo_groups = self.topo_groups if self.topo_groups is not None \
            else _group_indices(
                [archcount.collective_topology(p) for p in self.plans])
        for topo, idx in topo_groups.items():
            cv = _collective_vector_fn(self.cfg, self.workload.phase, topo)
            env = {**base_env, "M": self.microbatches[idx],
                   "DP": self.dp[idx], "TP": self.tp[idx]}
            for k, v in cv(env).items():
                acc(k, idx, np.broadcast_to(
                    np.asarray(v, dtype=np.float64), idx.shape))

        out[props.CONST1] = np.ones(n, dtype=np.float64)
        return out

    # -- scoring -----------------------------------------------------------
    def scores(self, model=None, cache=None) -> np.ndarray:
        """Predicted step seconds for every cell, through the FUSED basis
        programs (``core.exprops``): per evaluation group the model's
        weights fold through the program's coefficient matrix into one
        per-term vector, the deduped basis terms evaluate once per UNIQUE
        environment row, and the group scores as a single GEMV — `<α, p>`
        with the linearity exploited end to end.  ``cache`` (an
        ``exprops.BasisCache``) switches to incremental per-column
        evaluation for warm rescores.  ``scores_columns`` is the per-key
        column path this is pinned against (rtol ≤ 1e-9)."""
        tr = _obs_trace.get_tracer()
        if tr.enabled:      # one span per sweep; off = one attribute check
            with tr.span("planspace.scores", cells=len(self),
                         phase=self.workload.phase,
                         cached=cache is not None):
                return self._scores(model, cache)
        return self._scores(model, cache)

    def _scores(self, model=None, cache=None) -> np.ndarray:
        m = predictor.resolve_model(model)
        n = len(self)
        base_env = self.workload.env(self.cfg)
        w1 = 0.0
        for k, w in zip(m.keys, m.weights):
            if k == props.CONST1:
                w1 = float(w)
        total = np.full(n, w1, dtype=np.float64)
        if not n:
            return total
        if self.product is not None and cache is None:
            return self._scores_product(m, total)

        remat_groups = self.remat_groups if self.remat_groups is not None \
            else _group_indices([p.remat_policy for p in self.plans])
        for remat, idx in remat_groups.items():
            prog = predictor.step_program(self.cfg, self.workload, remat)
            env = {**base_env, "M": self.microbatches[idx]}
            s = exprops.score_cells(prog, env, len(idx), m, cache)
            total[idx] += s / self.n_dev[idx]   # SPMD work division

        topo_groups = self.topo_groups if self.topo_groups is not None \
            else _group_indices(
                [archcount.collective_topology(p) for p in self.plans])
        for topo, idx in topo_groups.items():
            prog = _collective_program(self.cfg, self.workload.phase, topo)
            env = {**base_env, "M": self.microbatches[idx],
                   "DP": self.dp[idx], "TP": self.tp[idx]}
            total[idx] += exprops.score_cells(prog, env, len(idx), m, cache)
        return total

    def _scores_product(self, m, total: np.ndarray) -> np.ndarray:
        """The ``from_product`` fast path: the env columns are rank-1
        (plan-profile × mesh), so each group's basis matrix is evaluated at
        profile granularity — distinct microbatch counts for the step
        terms, (microbatches, dp-axes, tp-axis) profiles × meshes for the
        collectives — and the cell scores assemble as ONE outer-product
        expression over the (n_plans, n_meshes) grid.  n_cells never
        enters a program evaluation."""
        pi = self.product
        base_env = self.workload.env(self.cfg)
        n_m = pi.n_m
        n_p = len(pi.plan_mb)

        # step terms: one evaluation per DISTINCT microbatch per schedule
        s_plan = np.zeros(n_p, dtype=np.float64)
        for remat, pidx, umb, inv in pi.step_envs():
            prog = self._group_program(("step", remat), remat)
            s = np.asarray(prog.score({**base_env, "M": umb}, m),
                           dtype=np.float64)
            if s.shape != umb.shape:
                s = np.broadcast_to(s, umb.shape)
            s_plan[pidx] = s[inv]

        # collective terms: rows of a (profiles, n_m) matrix; each plan
        # points at its profile's row
        groups, prof_row, n_rows = pi.topo_envs()
        S_rows = np.empty((n_rows, n_m), dtype=np.float64)
        base = 0
        for topo, n_prof, Mc, DPc, TPc in groups:
            prog = self._group_program(("coll", topo), topo)
            s = np.asarray(prog.score(
                {**base_env, "M": Mc, "DP": DPc, "TP": TPc}, m),
                dtype=np.float64)
            if s.shape != (n_prof * n_m,):
                s = np.broadcast_to(s, (n_prof * n_m,))
            S_rows[base:base + n_prof] = s.reshape(n_prof, n_m)
            base += n_prof

        # one outer-product assembly for the whole grid (total carries the
        # const1 launch weight already; cells are plan-major)
        grid = s_plan[:, None] / pi.mesh_ndev
        if n_rows:
            grid += S_rows[prof_row]
        total += grid.ravel()
        return total

    def scores_columns(self, model=None) -> np.ndarray:
        """Reference scorer: per-key weighted sum over ``property_arrays``
        (the per-key column engine).  Semantically identical to ``scores``;
        kept as the oracle the fused-GEMV path is tested against and the
        named baseline ``benchmarks/fused_bench.py`` times it over."""
        m = predictor.resolve_model(model)
        arrs = self.property_arrays()
        total = np.zeros(len(self), dtype=np.float64)
        for key, w in zip(m.keys, m.weights):
            col = arrs.get(key)
            if col is not None and w:
                total += float(w) * col
        return total

    def rank(self, model=None, top_k: Optional[int] = None
             ) -> List[Tuple[float, object, Mesh]]:
        """Cells as (seconds, plan, mesh), ascending; ties broken on plan
        fields then mesh shape — never on enumeration order.  The ordering
        is one ``np.lexsort`` over (seconds, plan-key ordinal, mesh-key
        ordinal) columns; ``top_k`` takes the ``np.argpartition`` fast
        path (tie-closed at the k-th score, so the result is exactly the
        full ranking's prefix)."""
        secs = self.scores(model)
        n = len(self)
        idx = np.arange(n, dtype=np.intp)
        if top_k is not None:
            if top_k <= 0:
                return []
            if top_k < n:
                part = np.argpartition(secs, top_k - 1)[:top_k]
                # close over ties at the boundary so the full sort's
                # plan/mesh tie-breaks stay authoritative
                idx = np.nonzero(secs <= secs[part].max())[0]
        order = idx[_rank_order(secs[idx],
                                [self.plans[i] for i in idx],
                                [self.mesh_shapes[i] for i in idx])]
        if top_k is not None:
            order = order[:top_k]
        return [(float(secs[i]), self.plans[i], self.mesh_shapes[i])
                for i in order]

    # -- feasibility -------------------------------------------------------
    def peak_bytes(self) -> np.ndarray:
        """Closed-form peak HBM bytes/device per cell, one numpy pass."""
        return _peak_bytes_soa(self.cfg, self.workload, self.plans,
                               self.dp, self.tp)

    def feasible_mask(self, budget: Optional[float] = None) -> np.ndarray:
        if budget is None:
            budget = predictor.HBM_BYTES
        return self.peak_bytes() <= budget


# ---------------------------------------------------------------------------
# Vectorized HBM feasibility (the predictor's napkin math, column-wise)
# ---------------------------------------------------------------------------


def _peak_bytes_soa(cfg: ArchConfig, shape, plans: Sequence,
                    dp: np.ndarray, tp: np.ndarray) -> np.ndarray:
    """``predictor.estimate_peak_bytes`` over candidate arrays.  The plan
    booleans become masks, the mesh ways are the dp/tp columns, and every
    branch of the scalar formula lowers to ``np.where`` — the scalar
    version delegates here with single-element arrays, so there is exactly
    one copy of the napkin math.  ``shape`` is anything exposing
    ``kind``/``global_batch``/``seq_len`` (a ``WorkloadSpec`` or a
    ``ShapeConfig``)."""
    dp = np.asarray(dp, dtype=np.float64)
    tp = np.asarray(tp, dtype=np.float64)
    # dtype=bool: an empty list would otherwise default to float64 and
    # break the mask arithmetic below
    fsdp = np.asarray([bool(p.fsdp) for p in plans], dtype=bool)
    sp = np.asarray([bool(p.sequence_parallel) for p in plans], dtype=bool)
    mb = np.asarray([max(p.microbatches, 1) for p in plans],
                    dtype=np.float64)

    P = cfg.n_params()
    bytes_p = 2 if "16" in cfg.param_dtype else 4
    pshard = tp * np.where(fsdp, dp, 1.0)
    total = P * bytes_p / pshard

    if shape.kind == "train":
        opt_bytes = {"adamw": 8.0, "adafactor": 0.1,
                     "sgd": 4.0}[cfg.optimizer]
        total += P * opt_bytes / pshard           # optimizer state
        total += P * 4.0 / pshard                 # f32 grads (transient)
        # scan-over-layers gathers ONE layer's shard at a time (FSDP)
        total += np.where(fsdp & (dp > 1),
                          P * bytes_p / (tp * max(cfg.n_layers, 1)), 0.0)
        Bm = shape.global_batch / mb
        tok = Bm * shape.seq_len / dp
        act_shard = np.where(sp, tp, 1.0)
        saves_by = {"full": 1.0, "nothing": 1.0, "dots": 4.0,
                    "none": 10.0, None: 1.0}
        saves = np.asarray(
            [saves_by[p.remat_policy or cfg.remat_policy] for p in plans],
            dtype=np.float64)
        total += saves * cfg.n_layers * tok * cfg.d_model * 2 / act_shard
        total += 12.0 * tok * cfg.d_model * 2 / act_shard  # live layer
        # logits in f32 for the loss
        total += tok * cfg.vocab_size * cfg.n_output_heads * 4 / tp
    elif shape.kind == "prefill":
        tok = shape.global_batch * shape.seq_len / dp
        total += 16.0 * tok * cfg.d_model * 2 / np.where(sp, tp, 1.0)
        total += tok * cfg.vocab_size * cfg.n_output_heads * 2 / tp
    else:  # decode: KV/SSM caches dominate
        Bd = shape.global_batch / dp
        if cfg.n_heads:
            has_cs = np.asarray([bool(p.cache_seq_axes) for p in plans],
                                dtype=bool)
            ctx = min(shape.seq_len, cfg.sliding_window or shape.seq_len)
            n_attn = (cfg.n_layers // cfg.hybrid.attn_every
                      if cfg.family == "hybrid" else cfg.n_layers)
            kv_shard = np.where(has_cs, tp,
                                np.minimum(tp, cfg.n_kv_heads))
            total += (2 * Bd * ctx * cfg.n_kv_heads * cfg.head_dim_
                      * 2 * n_attn) / kv_shard
        if cfg.ssm is not None:
            total += (cfg.n_layers * Bd * cfg.ssm_heads * cfg.ssm.head_dim
                      * cfg.ssm.d_state * 4) / np.minimum(tp, cfg.ssm_heads)
    return np.asarray(total, dtype=np.float64)


def peak_bytes(cfg: ArchConfig, workload: wl.WorkloadLike, plans: Sequence,
               mesh_shapes: Sequence[Mapping[str, int]]) -> np.ndarray:
    """Peak HBM bytes/device for parallel (plan, mesh) candidate lists."""
    spec = wl.as_spec(workload)
    dp = np.asarray([_axis_product(m, p.dp_axes)
                     for p, m in zip(plans, mesh_shapes)], dtype=np.int64)
    tp = np.asarray([m.get(p.tp_axis, 1) if p.tp_axis else 1
                     for p, m in zip(plans, mesh_shapes)], dtype=np.int64)
    return _peak_bytes_soa(cfg, spec, plans, dp, tp)


# ---------------------------------------------------------------------------
# Streaming sweeps — million-cell spaces in bounded memory
# ---------------------------------------------------------------------------


def iter_product_chunks(cfg: ArchConfig, workload: wl.WorkloadLike,
                        plans: Sequence, meshes: Sequence[Mapping[str, int]],
                        chunk_cells: int = 65536):
    """Yield ``(cell_offset, PlanSpace)`` tiles of the plan-major product
    space, each at most ~``chunk_cells`` cells.

    Tiles are themselves ``from_product`` spaces (plan-block × mesh-block),
    so every chunk scores through the rank-1 profile fast path and its
    cells land at ``offset + local_index`` in the full product's plan-major
    order — per-cell results are bit-identical to scoring the whole space
    at once, only the peak footprint changes."""
    spec = wl.as_spec(workload)
    plans = list(plans)
    meshes = [dict(m) for m in meshes]
    n_p, n_m = len(plans), len(meshes)
    if not n_p or not n_m:
        return
    chunk_cells = max(int(chunk_cells), 1)
    if n_m > chunk_cells:
        for i in range(n_p):             # one plan row, mesh-tiled
            for j0 in range(0, n_m, chunk_cells):
                sub = PlanSpace.from_product(
                    cfg, spec, plans[i:i + 1],
                    meshes[j0:j0 + chunk_cells])
                yield i * n_m + j0, sub
    else:
        p_step = max(chunk_cells // n_m, 1)
        for i0 in range(0, n_p, p_step):
            sub = PlanSpace.from_product(cfg, spec, plans[i0:i0 + p_step],
                                         meshes)
            yield i0 * n_m, sub


def stream_topk(cfg: ArchConfig, workload: wl.WorkloadLike, plans: Sequence,
                meshes: Sequence[Mapping[str, int]], model=None,
                k: int = 5, chunk_cells: int = 65536,
                hbm_budget: Optional[float] = None,
                stats: Optional[dict] = None
                ) -> List[Tuple[float, object, Mesh]]:
    """Top-``k`` cells of a (plan × mesh) product of ANY size in bounded
    memory: chunks stream through the fused scorer, an ``np.argpartition``
    pool keeps only candidates at or below the running k-th score (closed
    over ties, so the result is exactly the full ``rank``'s prefix), and
    ``hbm_budget`` prunes infeasible cells from the pool — a chunk whose
    cells ALL bust the budget skips scoring entirely.

    Peak working set is one chunk's columns plus the candidate pool — the
    full space's property columns are never materialized.  ``stats`` (any
    dict) receives ``{cells, chunks, max_chunk_cells, pool_high_water,
    pruned_cells}`` telemetry."""
    if k <= 0:
        return []
    m = predictor.resolve_model(model)
    spec = wl.as_spec(workload)
    plans = list(plans)
    meshes = [dict(mm) for mm in meshes]
    n_m = len(meshes)
    best_secs = np.zeros(0, dtype=np.float64)
    best_idx = np.zeros(0, dtype=np.int64)
    n_chunks = max_chunk = pool_hw = pruned = total_cells = 0
    for off, sub in iter_product_chunks(cfg, spec, plans, meshes,
                                        chunk_cells):
        n_chunks += 1
        max_chunk = max(max_chunk, len(sub))
        total_cells += len(sub)
        gidx = off + np.arange(len(sub), dtype=np.int64)
        if hbm_budget is not None:
            fits = sub.feasible_mask(hbm_budget)
            pruned += int(len(sub) - fits.sum())
            if not fits.any():
                continue                 # pruned before any scoring
        secs = sub.scores(m)
        if hbm_budget is not None:
            secs, gidx = secs[fits], gidx[fits]
        secs = np.concatenate([best_secs, secs])
        gidx = np.concatenate([best_idx, gidx])
        if len(secs) > k > 0:
            kth = secs[np.argpartition(secs, k - 1)[k - 1]]
            keep = secs <= kth           # tie closure at the k-th score
            secs, gidx = secs[keep], gidx[keep]
            if len(secs) > k + 512:
                # massive score ties (e.g. a model blind to the mesh) would
                # otherwise grow the pool toward n_cells; the plan/mesh
                # tie-break order is total and stable, so truncating to
                # exactly k through it preserves the rank-prefix contract
                # while keeping the pool bounded
                order = _rank_order(secs, [plans[i // n_m] for i in gidx],
                                    [meshes[i % n_m] for i in gidx])[:k]
                secs, gidx = secs[order], gidx[order]
        best_secs, best_idx = secs, gidx
        pool_hw = max(pool_hw, len(best_secs))
    if stats is not None:
        stats.update(cells=total_cells, chunks=n_chunks,
                     max_chunk_cells=max_chunk, pool_high_water=pool_hw,
                     pruned_cells=pruned)
    if not len(best_secs):
        return []
    pool_plans = [plans[i // n_m] for i in best_idx]
    pool_meshes = [meshes[i % n_m] for i in best_idx]
    order = _rank_order(best_secs, pool_plans, pool_meshes)[:k]
    return [(float(best_secs[i]), pool_plans[i], pool_meshes[i])
            for i in order]


# ---------------------------------------------------------------------------
# Joint plan × kernel-block co-tuning
# ---------------------------------------------------------------------------


def cotune_kernel_blocks(cfg: ArchConfig, workload: wl.WorkloadLike, plan,
                         mesh_shape: Mapping[str, int], model=None, *,
                         kernels=None) -> Dict[str, Dict[str, int]]:
    """Model-chosen block sizes for the step's dominant kernels at this
    (plan, mesh) cell's *per-device* shard shapes — the joint plan × block
    co-tuning hook.  The plan/mesh pin the sharding (dp/tp ways, schedule);
    the per-kernel shape derivation and tuning live in
    ``kernels/autotune.best_blocks_for_workload``, over ``kernels``
    (default the CUDA sources' tiles, ``kernelmodel.KERNELS``)."""
    from repro_torch.kernels import autotune
    spec = wl.as_spec(workload)
    dp = _axis_product(mesh_shape, plan.dp_axes)
    tp = mesh_shape.get(plan.tp_axis, 1) if plan.tp_axis else 1
    return autotune.best_blocks_for_workload(
        cfg, spec, model, dp=dp, tp=tp, microbatches=plan.microbatches,
        kernels=kernels)
