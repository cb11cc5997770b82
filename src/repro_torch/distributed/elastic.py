"""Elastic re-planning: on node/pod loss, choose the best feasible
(mesh, plan) for the surviving devices and resume from the last checkpoint.

Uses the fitted/analytic linear cost model (core/predictor.py) to rank the
candidate meshes in microseconds — the paper's 'rapid evaluation' property
is what makes in-failure-path re-planning viable at all (a compile-and-
measure search would take minutes per candidate).  The ``weights`` argument
accepts a registry device name (``repro_torch.calibration``) as well as an
in-memory ``LinearCostModel``.

``devices`` generalizes beyond a homogeneous count: any entry
point taking a device count also accepts a **heterogeneous pool
descriptor** — a list of ``(device_name, count)`` pairs — in which case
each pool's factorization space is priced through that pool's own registry
model (hardened load: corrupt file → revision backup → analytic seed) and
the ranked options carry the pool's device name.  A plain ``int`` remains
the 1-pool case with the caller-supplied ``weights``, byte-identical to the
pre-fleet behavior.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core import exprops, planspace, predictor
from repro_torch.core import workload as wl
from repro_torch.distributed.plan import Plan, plan_for

#: incremental-rescore cache for the failure path: basis columns keyed by
#: (term, its own free-variable values), so a replan after a device-count
#: delta recomputes only the DP/TP-dependent columns — every (B, S, M)-
#: keyed column returns from cache and warm replans stay in microseconds.
_BASIS_CACHE = exprops.BasisCache(maxsize=8192)

#: the same incremental contract per named pool: each device type's
#: columns live in their own cache so a churny heterogeneous fleet warms
#: every pool independently (cleared together by ``clear_caches``).
_POOL_CACHES: Dict[str, exprops.BasisCache] = {}

#: a heterogeneous pool: ordered (registry device name, chip count) pairs.
PoolDescriptor = Sequence[Tuple[Optional[str], int]]
DevicesArg = Union[int, PoolDescriptor]


@dataclass(frozen=True)
class MeshOption:
    shape: Dict[str, int]          # axis -> size
    plan: Plan
    predicted_step_s: float
    #: pool device name this option was priced for (None: homogeneous
    #: 1-pool case scored with the caller's ``weights``)
    device: Optional[str] = None


def pool_cache(device: Optional[str] = None) -> exprops.BasisCache:
    """The incremental ``BasisCache`` for one pool (None: the classic
    homogeneous cache).  Exposed so the fleet benchmark can read the
    hits/misses telemetry behind the warm-replan acceptance bar."""
    if device is None:
        return _BASIS_CACHE
    cache = _POOL_CACHES.get(device)
    if cache is None:
        cache = _POOL_CACHES[device] = exprops.BasisCache(maxsize=8192)
    return cache


def as_pools(devices: DevicesArg) -> List[Tuple[Optional[str], int]]:
    """Normalize a devices argument: ``int`` → the anonymous 1-pool case,
    a descriptor passes through with counts coerced to ``int``."""
    if isinstance(devices, (int,)) or hasattr(devices, "__index__"):
        return [(None, int(devices))]
    out: List[Tuple[Optional[str], int]] = []
    for device, n in devices:
        out.append((None if device is None else str(device), int(n)))
    return out


def _pool_model(device: Optional[str], weights,
                registry_dir: Optional[str],
                models: Optional[Mapping[str, object]]):
    """The cost model pricing one pool: a named pool loads its own registry
    model (or takes it from ``models``, the fleet allocator's batch-loaded
    map); the anonymous pool keeps the caller's ``weights``."""
    if device is None:
        return predictor.resolve_model(weights)
    if models is not None and device in models:
        return models[device]
    from repro_torch.calibration import registry
    return registry.load_model(device, registry_dir)


def _factorizations(n: int) -> List[Tuple[int, int]]:
    """All ordered (data, model) splits of ``n`` — now shared with the
    autoshard mesh sweep via ``core.planspace.factor_pairs``."""
    return planspace.factor_pairs(n)


def mesh_cells(cfg: ArchConfig, spec: wl.WorkloadSpec, n_devices: int,
               max_candidates: int = 64
               ) -> List[Tuple[Plan, Dict[str, int]]]:
    """The feasible (plan, mesh) cells for ``n_devices`` chips: every
    (data × model) factorization whose data way still divides the global
    batch (training keeps exact batch semantics across restarts), each
    with its memory-aware default plan.  Shared by ``replan`` and the
    fleet allocator's per-pool scoring."""
    cells: List[Tuple[Plan, Dict[str, int]]] = []
    for dp, tp in _factorizations(n_devices)[:max_candidates]:
        if spec.phase == "train" and spec.global_batch % dp != 0:
            continue
        plan = plan_for(cfg, spec, multi_pod=False, tp_size=tp)
        plan = dataclasses.replace(plan, dp_axes=("data",))
        cells.append((plan, {"data": dp, "model": tp}))
    return cells


def replan(cfg: ArchConfig, shape: wl.WorkloadLike, devices: DevicesArg,
           weights: predictor.ModelLike = None,
           max_candidates: int = 64, *,
           registry_dir: Optional[str] = None,
           models: Optional[Mapping[str, object]] = None,
           cache: Optional[exprops.BasisCache] = None,
           kernels=None) -> List[MeshOption]:
    """Rank feasible (data × model) meshes for the surviving devices.

    ``devices`` is a survivor count (the classic 1-pool case) or a
    heterogeneous pool descriptor ``[(device_name, count), ...]``; with a
    descriptor every pool's candidates are priced through that pool's own
    registry model and all options are merged into one ranking (seconds
    first, then the deterministic plan/mesh/device tie-breaks).

    Feasibility: the global batch must still divide the data axis (training
    keeps exact batch semantics across restarts) and the model dims must
    divide the model axis (checked softly — the sharding layer drops
    non-divisible axes, so these plans still *lower*, they just waste the
    axis; the predictor prices that in).

    Every surviving-mesh candidate is scored with ONE batched call through
    the fused search engine (``core.planspace`` → ``core.exprops``) — this
    runs on the failure path, so the sweep must stay in microseconds per
    candidate.  Scoring passes each pool's ``exprops.BasisCache`` (or the
    caller's ``cache`` override): across successive replans only the basis
    columns a device-count/shape delta actually touches recompute (the
    incremental-rescore contract, docs/MODEL.md §2.7).  ``kernels``: the
    registry the step programs compose (``predictor``'s; None, the card's).
    """
    spec = wl.as_spec(shape)    # any WorkloadLike; one currency from here
    opts: List[MeshOption] = []
    for device, n in as_pools(devices):
        model = _pool_model(device, weights, registry_dir, models)
        cells = mesh_cells(cfg, spec, n, max_candidates)
        if not cells:
            continue
        space = planspace.PlanSpace.from_cells(cfg, spec, cells,
                                               kernels=kernels)
        secs = space.scores(model,
                            cache=cache if cache is not None
                            else pool_cache(device))
        opts.extend(MeshOption(mesh, plan, float(s), device=device)
                    for (plan, mesh), s in zip(cells, secs))
    opts.sort(key=lambda o: (o.predicted_step_s,
                             planspace.mesh_sort_key(o.shape),
                             o.device or ""))
    return opts


def _pow2_floor(n: int) -> int:
    """Largest power of two ≤ n (0 for n ≤ 0) — the 'round' survivor
    count real pods drain to around a failed host."""
    if n <= 0:
        return 0
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def on_failure(cfg: ArchConfig, shape: wl.WorkloadLike,
               prev_devices: DevicesArg, lost: int,
               weights: predictor.ModelLike = None, *,
               pool: Optional[str] = None,
               registry_dir: Optional[str] = None,
               models: Optional[Mapping[str, object]] = None,
               kernels=None) -> MeshOption:
    """Failure handler: fall back to the best mesh over the largest
    'round' (power-of-two) survivor count — spares become hot standbys,
    matching how real pods drain around a failed host.

    With a heterogeneous ``prev_devices`` descriptor the ``lost`` devices
    come out of the ``pool`` named by the fault (default: the first pool);
    that pool rounds down to a power of two, the others keep their counts,
    and the best option across all surviving pools wins — a dead pool
    (zero survivors) simply drops out of the descriptor."""
    pools = as_pools(prev_devices)
    if len(pools) == 1 and pools[0][0] is None and pool is None:
        survivors = pools[0][1] - lost
        options = replan(cfg, shape, _pow2_floor(survivors), weights,
                         registry_dir=registry_dir, models=models,
                         kernels=kernels)
        assert options, f"no feasible mesh for {_pow2_floor(survivors)} " \
                        f"devices"
        return options[0]
    target = pool if pool is not None else pools[0][0]
    desc: List[Tuple[Optional[str], int]] = []
    for device, n in pools:
        if device == target:
            n = _pow2_floor(n - lost)
        if n > 0:
            desc.append((device, n))
    options = replan(cfg, shape, desc, weights,
                     registry_dir=registry_dir, models=models,
                     kernels=kernels)
    assert options, f"no feasible mesh over surviving pools {desc}"
    return options[0]
