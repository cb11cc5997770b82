"""Step-time prediction for (arch × shape × mesh × plan) — the framework's
first-class use of the paper's fitted linear model.

Two weight sources:

  * a **fitted** ``LinearCostModel`` (the ``gpu-h100`` model that
    ``python -m repro_torch.calibration --device gpu-h100`` fits on the card
    and registers);
  * an **analytic seed**: the registry's datasheet seeds
    (``calibration/seeds.py``: ``gpu-h100`` and the other GPUs) or the
    reference's v5e seed below (``tpu_v5e_weights``, the ``None`` default of
    ``resolve_model``).

The prediction is the paper's inner product <α, p>, with compute/memory
properties scaled down by the device count (data-parallel work division) and
collective properties already expressed per-device by
``archcount.collective_counts``.

This predictor powers ``runtime/straggler.py`` (expected-step-time
thresholds), ``distributed/elastic.py`` (re-planning after node loss) and
the predicted-step print of ``launch/train.py``.

A copy of the reference's ``core/predictor.py`` with two rules for its v5e
constants, which are catalog data for another device, never a figure of the
H100:

  * MFU divides by the peak of the model's own device where that device is a
    datasheet of ``calibration/seeds.GPU_DATASHEETS`` (the fitted and the
    analytic ``gpu-h100`` both are); every other model keeps the reference's
    ``PEAK_FLOPS_BF16``;
  * ``feasible`` keeps the reference's default budget (``HBM_BYTES``); a
    caller on the card passes ``torch.cuda.get_device_properties(dev)
    .total_memory``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core import archcount
from repro_torch.core import properties as props
from repro_torch.core import workload as wl
from repro_torch.core.lru import LRUCache
from repro_torch.core.model import LinearCostModel
from repro_torch.core.workload import WorkloadSpec

# --- v5e hardware constants (per chip): catalog data for another device ---
PEAK_FLOPS_BF16 = 197e12     # FLOP/s
PEAK_FLOPS_F32 = 49e12       # VPU-ish f32 rate
HBM_BW = 819e9               # B/s
ICI_BW = 50e9                # B/s per link (≈3 links usable per axis-dir)
LAUNCH_S = 5e-6              # per-dispatch overhead


def tpu_v5e_weights() -> LinearCostModel:
    """Analytic seconds-per-event weights for the property taxonomy."""
    w: Dict[str, float] = {}
    w[props.mxu_key(16)] = 1.0 / PEAK_FLOPS_BF16
    w[props.mxu_key(32)] = 1.0 / (PEAK_FLOPS_BF16 / 4)  # f32 matmul 1/4 rate
    for kind, mult in (("add", 1.0), ("mul", 1.0), ("div", 4.0),
                       ("exp", 8.0), ("special", 8.0)):
        w[props.flop_key(32, kind)] = mult / PEAK_FLOPS_F32
        w[props.flop_key(16, kind)] = mult / (2 * PEAK_FLOPS_F32)
    for bits in props.SIZES:
        by = bits // 8
        for d in props.DIRECTIONS:
            w[props.mem_key(d, bits, "s0")] = 0.0          # broadcast: cached
            w[props.mem_key(d, bits, "s1")] = by / HBM_BW
            w[props.mem_key(d, bits, "gather")] = 4.0 * by / HBM_BW
            for s in (2, 3, 4):
                for k in range(1, s + 1):
                    # stride-s with k/s utilization: pay the full footprint
                    w[props.mem_key(d, bits, f"s{s}_{k}/{s}")] = \
                        by * (s / k) / HBM_BW
            for k in range(1, 5):
                w[props.mem_key(d, bits, f"s>4_{k}/>4")] = 4.0 * by / HBM_BW
        w[props.minls_key(bits)] = 0.0   # duplex HBM: no extra gain modeled
        w[props.local_key(bits)] = by / (20 * HBM_BW)  # VMEM ≈ 20× HBM BW
    for c in props.COLLECTIVES:
        # ring collectives over ICI; all_to_all crosses bisection
        w[props.coll_key(c)] = 1.0 / (3 * ICI_BW) if c != "all_to_all" \
            else 1.0 / (2 * ICI_BW)
    w[props.BARRIER] = 1e-7
    w[props.GROUPS] = 1e-7
    w[props.CONST1] = LAUNCH_S
    return LinearCostModel.from_dict(w, device="tpu-v5e-analytic",
                                     meta={"source": "datasheet-seed"})


# ---------------------------------------------------------------------------

#: what every prediction entry point accepts: an in-memory model, a registry
#: device name (resolved via ``repro_torch.calibration``), or None (v5e seed).
ModelLike = Union[LinearCostModel, str, None]


def resolve_model(model: ModelLike) -> LinearCostModel:
    """Normalize a model argument.  ``None`` is the deterministic default —
    the built-in analytic v5e seed, never a registry file; a string is a
    registry device name (where a fitted model shadows a same-named seed).

    Delegates to ``repro_torch.calibration.registry.resolve_model`` (the
    single home of these rules; its ``"tpu-v5e"`` default seed IS
    ``tpu_v5e_weights``), imported lazily because calibration sits above
    core."""
    from repro_torch.calibration import registry
    return registry.resolve_model(model)


def peak_flops_bf16(model: LinearCostModel) -> float:
    """The bf16 matmul peak MFU divides by: the datasheet's of the model's
    device where ``calibration/seeds.GPU_DATASHEETS`` has one (``gpu-h100``
    fitted or analytic: 989e12), else the reference's ``PEAK_FLOPS_BF16``."""
    from repro_torch.calibration import seeds  # calibration sits above core
    ds = seeds.GPU_DATASHEETS.get(model.device)
    return ds.matmul_flops[16] if ds is not None else PEAK_FLOPS_BF16


@dataclass
class StepPrediction:
    seconds: float
    breakdown: Dict[str, float]      # per-property seconds
    terms: Dict[str, float]          # compute / memory / collective seconds
    model_flops: float
    mfu: float                       # MODEL_FLOPS / (chips·peak·seconds),
    #                                  peak from ``peak_flops_bf16``


def _env_for(spec: WorkloadSpec, cfg: Optional[ArchConfig] = None,
             microbatches: int = 1) -> Dict[str, float]:
    # one env for every phase: the spec pins B/S (+ decode refinements),
    # the plan's schedule overrides M
    env = spec.env(cfg)
    env["M"] = microbatches
    return env


# ---------------------------------------------------------------------------
# Compiled step vectors — kernel-granularity compute terms
# ---------------------------------------------------------------------------

#: (cfg, spec.structure(), remat_policy) -> symcount.CompiledVector.  Step
#: vectors are pure functions of those three — a spec's SHAPE enters only
#: through the evaluation env, so every spec sharing a structure (phase +
#: which decode refinements are modeled) shares one compiled vector.
#: Bounded LRU: each key pins a whole frozen ``ArchConfig`` (plus its
#: compiled closures), so the cache must not grow with every config a
#: long-lived process ever scores.
_STEP_PV_CACHE: LRUCache = LRUCache(maxsize=64)


def _step_pv_sym(cfg: ArchConfig, spec: WorkloadSpec,
                 remat_policy: Optional[str] = None, _sc=None,
                 kernels=None):
    """The symbolic property-vector map of one step of ``cfg`` — the shared
    source for both the per-property compiled path (``step_vector_fn``) and
    the fused basis program (``step_program``).

    For train/prefill the compute terms come from the PER-KERNEL property
    vectors (``core.kernelmodel.step_kernel_vectors`` over ``kernels``):
    the mxu count is the sum over the step's GEMMs and flash-attention /
    ssd_scan launches (plus unkernelized contractions), and the kernels'
    on-chip (``local:``) traffic joins the vector — the same counts the
    block-size autotuner scores.  ``kernels`` None or
    ``kernelmodel.KERNELS``: what the card launches (library GEMMs, the
    CUDA kernels at the main paths' tiles); ``kernelmodel.PALLAS_KERNELS``:
    the reference's Pallas blocks.  Memory / VPU / optimizer / structural
    terms stay at archcount's step granularity, as does everything for
    decode (its cache-streaming attention launches no kernel).
    """
    from repro_torch.core import kernelmodel
    from repro_torch.core.symcount import as_expr
    sc = _sc or archcount.counts_for(cfg, spec, remat_policy=remat_policy)
    pv_sym = dict(sc.pv)
    if spec.phase in ("train", "prefill"):
        mult = archcount.train_fwd_multiplier(cfg, remat_policy) \
            if spec.phase == "train" else 1.0
        kpv = kernelmodel.step_compute_vector(cfg, spec, kernels)
        for k, v in kpv.items():
            scaled = as_expr(v) * mult
            if k.startswith("mxu:"):
                pv_sym[k] = scaled          # replaces the step count
            else:
                pv_sym[k] = scaled + as_expr(pv_sym[k]) \
                    if k in pv_sym else scaled
    return pv_sym


def _structure_key(spec: WorkloadSpec):
    """Cache-key part for a spec: the bare phase string when no refinement
    is modeled (bit-compatible with the pre-spec ``kind=`` disk keys, so
    existing compile caches stay warm), the full structure tuple otherwise."""
    st = spec.structure()
    return st[0] if len(st) == 1 else st


def _kernels_key(cfg: ArchConfig, spec: WorkloadSpec, kernels):
    """Cache-key part for the step composition's registry: None for the
    reference's (its keys stay as they were), else the tiles the card's
    main paths launch for this step (they follow the spec's shape and the
    card's model)."""
    from repro_torch.core import kernelmodel
    blocks = kernelmodel.step_kernel_blocks(cfg, spec, kernels)
    if blocks is None:
        return None
    return ("cuda",) + tuple((k, tuple(sorted(v.items())))
                             for k, v in sorted(blocks.items()))


def step_vector_fn(cfg: ArchConfig, workload: wl.WorkloadLike,
                   remat_policy: Optional[str] = None, _sc=None,
                   kernels=None):
    """Compiled symbolic property vector for one step of ``cfg`` (one
    closure per property — see ``_step_pv_sym`` for what the vector holds).
    The batched engine's hot path uses the FUSED form (``step_program``);
    this per-property form stays as the reference the fused path is pinned
    against, and serves ``plan_property_vector`` / ``predict_step``."""
    from repro_torch.core.symcount import compile_vector
    spec = wl.as_spec(workload)
    key = (cfg, spec.structure(), remat_policy,
           _kernels_key(cfg, spec, kernels))
    cv = _STEP_PV_CACHE.get(key)
    if cv is None:
        cv = compile_vector(_step_pv_sym(cfg, spec, remat_policy, _sc=_sc,
                                         kernels=kernels))
        _STEP_PV_CACHE[key] = cv
    return cv


#: (cfg, structure, remat) -> exprops.BasisProgram — the fused-GEMV step
#: scorer.
_STEP_PROG_CACHE: LRUCache = LRUCache(maxsize=64)


def step_program(cfg: ArchConfig, workload: wl.WorkloadLike,
                 remat_policy: Optional[str] = None, kernels=None):
    """The step property vector as a FUSED basis program
    (``core.exprops``): canonicalized, cross-property CSE'd, scored as one
    GEMV.  In-memory LRU over the persistent on-disk compile cache — the
    disk key derives from (cfg, spec structure, remat) so a warm cache
    skips building the symbolic counts entirely."""
    from repro_torch.core import exprops
    spec = wl.as_spec(workload)
    kkey = _kernels_key(cfg, spec, kernels)
    key = (cfg, spec.structure(), remat_policy, kkey)
    prog = _STEP_PROG_CACHE.get(key)
    if prog is None:
        parts = ("step", cfg, _structure_key(spec), remat_policy)
        dk = exprops.program_key(*parts, *((kkey,) if kkey else ()))
        prog = exprops.load_or_build(
            dk, lambda: _step_pv_sym(cfg, spec, remat_policy,
                                     kernels=kernels))
        _STEP_PROG_CACHE[key] = prog
    return prog


def plan_property_vector(cfg: ArchConfig, workload: wl.WorkloadLike, plan,
                         mesh_shape: Mapping[str, int],
                         _count_cache: Optional[dict] = None,
                         _sc=None, kernels=None) -> Dict[str, float]:
    """The concrete per-device property vector for one (plan, mesh) cell.

    ``_count_cache`` memoizes the expensive symbolic-count evaluation across
    plans that share (remat_policy, microbatches) — the batched scorer passes
    one cache over the whole candidate set, so an autoshard sweep evaluates
    the per-arch counts once per distinct schedule, not once per plan.
    ``_sc`` lets a caller that already built the ``StepCounts`` (e.g.
    ``predict_step``, which also needs ``concrete_model_flops``) avoid
    rebuilding them.
    """
    spec = wl.as_spec(workload)
    n_dev = int(np.prod(list(mesh_shape.values()))) or 1
    env = _env_for(spec, cfg, plan.microbatches)

    ck = (plan.remat_policy, plan.microbatches)
    cached = _count_cache.get(ck) if _count_cache is not None else None
    if cached is None:
        cv = step_vector_fn(cfg, spec, plan.remat_policy, _sc=_sc,
                            kernels=kernels)
        cached = {k: float(v) for k, v in cv(env).items()}
        if _count_cache is not None:
            _count_cache[ck] = cached
    # compute/memory events divide over the mesh (SPMD work division)
    pv = {k: v / n_dev for k, v in cached.items()}
    coll = archcount.collective_counts(cfg, spec, plan, mesh_shape)
    from repro_torch.core.symcount import evaluate_vector
    pv.update(evaluate_vector(coll, env))
    pv[props.CONST1] = 1.0
    return pv


def predict_step(cfg: ArchConfig, workload: wl.WorkloadLike, plan,
                 mesh_shape: Mapping[str, int],
                 weights: ModelLike = None,
                 residual=None, kernels=None) -> StepPrediction:
    """Predict one step's wall time on ``mesh_shape`` under ``plan``.

    ``residual`` (a ``core.fit.ResidualHead``, e.g. from an
    ``OnlineCalibrator`` running with ``residual=True``) applies the
    learned multiplicative correction on top of the analytic inner product
    — the hybrid analytic+learned prediction.  The per-property breakdown
    stays analytic; the head's contribution appears as a ``residual``
    term and scales ``seconds``/``mfu``."""
    weights = resolve_model(weights)
    spec = wl.as_spec(workload)
    n_dev = int(np.prod(list(mesh_shape.values()))) or 1
    env = _env_for(spec, cfg, plan.microbatches)

    sc = archcount.counts_for(cfg, spec,
                              remat_policy=plan.remat_policy)
    pv = plan_property_vector(cfg, spec, plan, mesh_shape, _sc=sc,
                              kernels=kernels)

    bd = weights.breakdown(pv)
    total = sum(bd.values())
    terms = {c: 0.0 for c in props.CATEGORIES}
    for k, v in bd.items():
        terms[props.category(k)] += v
    if residual is not None:
        corrected = total * residual.correction(pv)
        terms["residual"] = corrected - total
        total = corrected
    mf = sc.concrete_model_flops(env)
    peak = peak_flops_bf16(weights)
    mfu = mf / (n_dev * peak * total) if total > 0 else 0.0
    return StepPrediction(seconds=total, breakdown=bd, terms=terms,
                          model_flops=mf, mfu=mfu)


def score_explain(cfg: ArchConfig, workload: wl.WorkloadLike, plan,
                  mesh_shape: Mapping[str, int], weights: ModelLike = None,
                  kernels=None):
    """Decompose one cell's predicted step seconds into basis-term
    contributions — per term, per cost category, per program source (step
    / collective / launch) — summing exactly to the fused
    ``PlanSpace.scores`` cell (``obs.explain.score_explain``)."""
    from repro_torch.obs.explain import score_explain as _explain
    return _explain(cfg, workload, plan, mesh_shape, weights,
                    kernels=kernels)


def predict_plans(cfg: ArchConfig, workload: wl.WorkloadLike,
                  plans: Sequence, mesh_shape: Mapping[str, int],
                  weights: ModelLike = None, cache=None,
                  kernels=None) -> np.ndarray:
    """Batched step-time prediction: seconds for every candidate plan.

    This is the plan-search hot path, routed through the array-batched
    search-space engine (``core.planspace``): the whole candidate set
    scores through FUSED basis programs (``core.exprops``) — deduped basis
    terms evaluated once per unique environment row, folded model weights,
    one GEMV — with no per-plan interpreted tree-walks anywhere.  The
    per-plan interpreted path survives as ``predict_plans_loop``, the
    oracle the engine is tested and benchmarked against.

    ``cache`` (an ``exprops.BasisCache``) switches on incremental
    rescoring: basis columns keyed by their own free-variable values, so a
    repeat call after a small delta (device count, mesh shape) recomputes
    only the touched columns — the ``elastic.replan`` /
    ``StragglerMonitor`` fast path.
    """
    weights = resolve_model(weights)
    spec = wl.as_spec(workload)
    if not len(plans):
        return np.zeros((0,))
    from repro_torch.core import planspace  # planspace sits above predictor
    space = planspace.PlanSpace.from_product(cfg, spec, list(plans),
                                             [dict(mesh_shape)],
                                             kernels=kernels)
    return space.scores(weights, cache=cache)


def predict_plans_loop(cfg: ArchConfig, workload: wl.WorkloadLike,
                       plans: Sequence, mesh_shape: Mapping[str, int],
                       weights: ModelLike = None,
                       kernels=None) -> np.ndarray:
    """Reference scorer: per-plan ``plan_property_vector`` + one
    ``predict_many``.  Semantically identical to ``predict_plans``; kept as
    the oracle the batched engine is pinned against (tests) and the
    baseline ``benchmarks/search_bench.py`` times the engine's speedup
    over."""
    weights = resolve_model(weights)
    spec = wl.as_spec(workload)
    count_cache: dict = {}
    pvs: List[Dict[str, float]] = [
        plan_property_vector(cfg, spec, p, mesh_shape, count_cache,
                             kernels=kernels)
        for p in plans]
    if not pvs:
        return np.zeros((0,))
    return np.asarray(weights.predict_many(pvs), dtype=np.float64)


def rank_plans(cfg: ArchConfig, workload: wl.WorkloadLike, plans,
               mesh_shape: Mapping[str, int],
               weights: ModelLike = None, kernels=None):
    """Sort candidate plans by predicted step time (ascending) — the paper's
    §6.2 'select the optimal set of kernel configurations', realized.

    Scoring goes through the batched ``predict_plans`` path; ties break on
    the plans' own fields (``planspace.plan_sort_key``), never on the
    caller's enumeration order."""
    from repro_torch.core.planspace import plan_sort_key
    secs = predict_plans(cfg, workload, plans, mesh_shape, weights,
                         kernels=kernels)
    order = sorted(range(len(plans)),
                   key=lambda i: (secs[i], plan_sort_key(plans[i])))
    return [(float(secs[i]), plans[i]) for i in order]


# ---------------------------------------------------------------------------
# HBM feasibility (capacity is out of the paper's model scope — §2 — so the
# framework enforces it as a *constraint*, not a cost term)
# ---------------------------------------------------------------------------

HBM_BYTES = 16e9  # v5e: catalog data for another device; callers on the card
#                   pass the card's memory as ``budget``


def estimate_peak_bytes(cfg: ArchConfig, workload: wl.WorkloadLike, plan,
                        mesh_shape: Mapping[str, int]) -> float:
    """Closed-form peak HBM bytes/device for a plan (napkin-math grade:
    params + optimizer + gradients + activation working set or caches).

    The formula itself lives in ``core.planspace`` as a single numpy pass
    over candidate arrays (``planspace.peak_bytes``); this scalar form is
    the one-cell special case, so a batched feasibility sweep and the
    per-plan call can never drift apart."""
    from repro_torch.core import planspace
    spec = wl.as_spec(workload)
    return float(planspace.peak_bytes(cfg, spec, [plan], [mesh_shape])[0])


def feasible(cfg: ArchConfig, workload: wl.WorkloadLike, plan,
             mesh_shape: Mapping[str, int],
             budget: float = HBM_BYTES) -> bool:
    """Whether the plan's closed-form peak bytes fit ``budget``.  The default
    is the reference's v5e HBM; on the card pass
    ``torch.cuda.get_device_properties(dev).total_memory``."""
    return estimate_peak_bytes(cfg, workload, plan, mesh_shape) <= budget
