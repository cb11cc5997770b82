"""Model-guided multi-job fleet allocator.

    PYTHONPATH=src python -m repro_torch.launch fleet --manifest demo \
        --steps 12 --fault-plan 'pool_shrink@5:pool=a100,k=2' --chaos-seed 7

The paper's one-model-per-device-type premise is exactly what a
heterogeneous fleet needs: a manifest of concurrent train/serve jobs is
placed across device *pools* (tpu-v5e / a100 / h100 / mi300x) by pricing
every (job × pool × device-count × plan × mesh) cell through that pool's
own registry model (``calibration.registry.load_models`` — the hardened
batch loader, so one corrupt model file degrades only its pool's
placements).  Scoring runs through the fused engine: each (job, pool)
scores ONE ``PlanSpace.from_cells`` batch spanning every power-of-two
device count the pool could grant, against a per-(job, pool)
``exprops.BasisCache`` — churn-time rescoring (``FleetSupervisor``'s
degradation ladder, ``runtime/fleet_supervisor.py``) therefore reuses the
allocation-time basis columns and stays warm-replan fast.  The optional
``wide_sweep`` path runs the same pricing through ``planspace.stream_topk``
for plan-space breadth far beyond the default mesh sweep, in bounded
memory.

Placement policy (deterministic — the byte-identical-history contract in
``tests/test_torch_fleet.py`` pins it against the reference's): jobs
place in (priority desc, name) order; each job takes the pool whose best
cell maximizes (SLO met, predicted tokens/s), tie-broken on pool name; a
job no pool can fit is *paused* with a capacity reason, never dropped.

A copy of the reference's ``launch/fleet.py`` (numpy only).  The pools are
names priced by models: a run places jobs on the models' pools and trains
nothing on another chip.  ``kernels`` is the registry the step programs
compose (``core.predictor``'s: None, the card's CUDA kernels;
``core.kernelmodel.PALLAS_KERNELS`` for the reference's numbers, which the
parity tests pass and under which the placement history equals the
reference's byte for byte).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.calibration import registry as _registry
from repro_torch.configs.registry import ARCHS
from repro_torch.core import exprops, planspace
from repro_torch.core import workload as wl
from repro_torch.distributed import elastic
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import report as _obs_report
from repro_torch.obs import trace as _obs_trace

#: demo pool sizing — also the chaos-smoke fixture (``chip_smoke.py``'s
#: ``pool_shrink@5:pool=a100,k=2`` drives one kept-job warm replan and one
#: forced migration against exactly this manifest)
_DEMO = {
    "name": "demo",
    "pools": [
        {"name": "a100", "device": "gpu-a100", "count": 8},
        {"name": "v5e", "device": "tpu-v5e", "count": 8},
    ],
    "jobs": [
        {"name": "train-hi", "arch": "smollm-360m", "phase": "train",
         "global_batch": 8, "seq_len": 128, "priority": 10,
         "min_devices": 2, "max_devices": 4},
        {"name": "serve", "arch": "smollm-360m", "phase": "decode",
         "global_batch": 4, "seq_len": 256, "priority": 8,
         "min_devices": 4, "max_devices": 4},
        {"name": "train-lo", "arch": "smollm-360m", "phase": "train",
         "global_batch": 4, "seq_len": 128, "priority": 5,
         "min_devices": 1, "max_devices": 4},
    ],
}


@dataclass(frozen=True)
class PoolSpec:
    """One homogeneous device pool: ``device`` is the registry model name
    pricing it (``gpu-a100``, ``tpu-v5e``, …), ``count`` its chip count."""
    name: str
    device: str
    count: int

    def __post_init__(self):
        if self.count < 0:
            raise ValueError(f"pool {self.name!r}: count must be >= 0")


@dataclass(frozen=True)
class JobSpec:
    """One manifest job: a ``WorkloadSpec`` plus the placement contract —
    priority (higher preempts), device bounds, and an optional step-time
    SLO the allocator prefers (but does not require) to meet."""
    name: str
    arch: str
    workload: wl.WorkloadSpec
    priority: int = 0
    min_devices: int = 1
    max_devices: int = 64
    slo_step_s: Optional[float] = None

    def __post_init__(self):
        if self.min_devices < 1 or self.max_devices < self.min_devices:
            raise ValueError(
                f"job {self.name!r}: need 1 <= min_devices <= max_devices "
                f"(got {self.min_devices}..{self.max_devices})")

    def move_cost_bytes(self) -> float:
        """Checkpoint bytes a migration must hand off (params + opt state,
        ~3 fp32 copies) — the 'cheapest-to-move' ordering key of the
        degradation ladder's migrate rung."""
        return float(ARCHS[self.arch].n_params()) * 4.0 * 3.0


@dataclass(frozen=True)
class Placement:
    """One job's placement: the pool, the granted device count, and the
    model-ranked best (plan, mesh) on it with its predicted rate."""
    job: str
    pool: str
    device: str               # the pool's registry model name
    devices: int
    mesh: Tuple[Tuple[str, int], ...]     # sorted (axis, size) pairs
    predicted_step_s: float
    tokens_per_s: float
    slo_ok: bool = True
    plan: object = field(default=None, compare=False, repr=False)

    @property
    def mesh_dict(self) -> Dict[str, int]:
        return dict(self.mesh)

    def to_json_dict(self) -> Dict[str, object]:
        return {"job": self.job, "pool": self.pool, "device": self.device,
                "devices": self.devices, "mesh": dict(self.mesh),
                "predicted_step_s": self.predicted_step_s,
                "tokens_per_s": self.tokens_per_s, "slo_ok": self.slo_ok}


@dataclass
class FleetAssignment:
    """The allocator's output: active placements by job name, paused jobs
    (with reasons) and the per-pool free-device ledger."""
    placements: Dict[str, Placement] = field(default_factory=dict)
    paused: Dict[str, str] = field(default_factory=dict)
    free: Dict[str, int] = field(default_factory=dict)

    def to_json_dict(self) -> Dict[str, object]:
        return {
            "placements": {n: p.to_json_dict()
                           for n, p in sorted(self.placements.items())},
            "paused": dict(sorted(self.paused.items())),
            "free": dict(sorted(self.free.items())),
        }


# ---------------------------------------------------------------------------
# Manifest
# ---------------------------------------------------------------------------


@dataclass
class Manifest:
    pools: List[PoolSpec]
    jobs: List[JobSpec]
    name: str = "fleet"

    def __post_init__(self):
        names = [p.name for p in self.pools]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate pool names in manifest: {names}")
        jnames = [j.name for j in self.jobs]
        if len(set(jnames)) != len(jnames):
            raise ValueError(f"duplicate job names in manifest: {jnames}")

    @classmethod
    def from_json_dict(cls, d: Mapping) -> "Manifest":
        pools = [PoolSpec(name=p["name"], device=p["device"],
                          count=int(p["count"])) for p in d["pools"]]
        jobs = []
        for j in d["jobs"]:
            spec = wl.WorkloadSpec(
                phase=j.get("phase", "train"),
                global_batch=int(j.get("global_batch", 1)),
                seq_len=int(j.get("seq_len", 1)),
                microbatches=int(j.get("microbatches", 1)),
                name=j["name"])
            jobs.append(JobSpec(
                name=j["name"], arch=j["arch"], workload=spec,
                priority=int(j.get("priority", 0)),
                min_devices=int(j.get("min_devices", 1)),
                max_devices=int(j.get("max_devices", 64)),
                slo_step_s=j.get("slo_step_s")))
        return cls(pools=pools, jobs=jobs, name=d.get("name", "fleet"))

    def to_json_dict(self) -> Dict[str, object]:
        return {
            "name": self.name,
            "pools": [{"name": p.name, "device": p.device,
                       "count": p.count} for p in self.pools],
            "jobs": [{"name": j.name, "arch": j.arch,
                      "phase": j.workload.phase,
                      "global_batch": j.workload.global_batch,
                      "seq_len": j.workload.seq_len,
                      "microbatches": j.workload.microbatches,
                      "priority": j.priority,
                      "min_devices": j.min_devices,
                      "max_devices": j.max_devices,
                      "slo_step_s": j.slo_step_s} for j in self.jobs],
        }


def demo_manifest() -> Manifest:
    """The built-in 2-pool / 3-job manifest (``--manifest demo``)."""
    return Manifest.from_json_dict(_DEMO)


def load_manifest(path_or_demo: str) -> Manifest:
    if path_or_demo == "demo":
        return demo_manifest()
    with open(path_or_demo) as f:
        return Manifest.from_json_dict(json.load(f))


# ---------------------------------------------------------------------------
# The allocator
# ---------------------------------------------------------------------------


def _throughput(spec: wl.WorkloadSpec, step_s: float) -> float:
    """Predicted tokens/s of one step: processed tokens for train/prefill,
    emitted tokens (slots × speculative length) per decode iteration."""
    if step_s <= 0:
        return 0.0
    if spec.phase == "decode":
        return spec.global_batch * spec.spec_len / step_s
    return spec.tokens / step_s


class FleetAllocator:
    """Scores the (job × pool × device-count × plan × mesh) space through
    per-device-type registry models and emits deterministic placements.

    One instance owns: the batch-loaded model map (one hardened
    ``load_model`` per distinct pool device, one ``[registry]`` rollup
    line), and a ``BasisCache`` per (job, pool) pair — the warm state the
    ``FleetSupervisor`` replans against when the pool ledger churns.
    """

    def __init__(self, manifest: Manifest,
                 registry_dir: Optional[str] = None,
                 max_candidates: int = 64, kernels=None):
        self.manifest = manifest
        self.pools: Dict[str, PoolSpec] = {p.name: p for p in manifest.pools}
        self.jobs: Dict[str, JobSpec] = {j.name: j for j in manifest.jobs}
        self.registry_dir = registry_dir
        self.max_candidates = max_candidates
        self.kernels = kernels
        self.models = _registry.load_models(
            [p.device for p in manifest.pools], registry_dir)
        self._caches: Dict[Tuple[str, str], exprops.BasisCache] = {}

    # -- warm state -------------------------------------------------------
    def cache(self, job: str, pool: str) -> exprops.BasisCache:
        key = (job, pool)
        c = self._caches.get(key)
        if c is None:
            c = self._caches[key] = exprops.BasisCache(maxsize=4096)
        return c

    def cache_stats(self) -> Dict[str, int]:
        hits = sum(c.hits for c in self._caches.values())
        misses = sum(c.misses for c in self._caches.values())
        return {"hits": hits, "misses": misses}

    # -- scoring ----------------------------------------------------------
    def candidate_counts(self, job: JobSpec, free: int) -> List[int]:
        """Power-of-two device counts the pool could grant ``job``,
        largest first — the count axis of the scored space."""
        n = elastic._pow2_floor(min(free, job.max_devices))
        out = []
        while n >= job.min_devices:
            out.append(n)
            n //= 2
        return out

    def score_job(self, job: JobSpec, pool: PoolSpec, free: int
                  ) -> Optional[Placement]:
        """The best cell of (count × plan × mesh) for ``job`` on ``pool``
        with ``free`` devices available — ONE fused ``PlanSpace`` batch
        spanning every candidate count, scored against this (job, pool)'s
        warm ``BasisCache``.  None when the pool can't meet
        ``min_devices`` or no mesh divides the batch."""
        counts = self.candidate_counts(job, free)
        if not counts:
            return None
        cfg = ARCHS[job.arch]
        cells: List[Tuple[object, Dict[str, int]]] = []
        for n in counts:
            cells.extend(elastic.mesh_cells(cfg, job.workload, n,
                                            self.max_candidates))
        if not cells:
            return None
        space = planspace.PlanSpace.from_cells(cfg, job.workload, cells,
                                               kernels=self.kernels)
        secs = space.scores(self.models[pool.device],
                            cache=self.cache(job.name, pool.name))
        best_i = min(
            range(len(cells)),
            key=lambda i: (secs[i],
                           planspace.mesh_sort_key(cells[i][1]),
                           planspace.plan_sort_key(cells[i][0])))
        plan, mesh = cells[best_i]
        step_s = float(secs[best_i])
        devices = 1
        for v in mesh.values():
            devices *= v
        return Placement(
            job=job.name, pool=pool.name, device=pool.device,
            devices=devices, mesh=tuple(sorted(mesh.items())),
            predicted_step_s=step_s,
            tokens_per_s=_throughput(job.workload, step_s),
            slo_ok=(job.slo_step_s is None or step_s <= job.slo_step_s),
            plan=plan)

    def place_job(self, job: JobSpec, free: Mapping[str, int],
                  exclude_pools: Sequence[str] = ()
                  ) -> Optional[Placement]:
        """The best placement for ``job`` across every non-excluded pool:
        maximize (SLO met, predicted tokens/s), tie-break on pool name.
        The supervisor's migrate rung calls this with the churned pool
        excluded."""
        best: Optional[Placement] = None
        best_key = None
        for pname in sorted(self.pools):
            if pname in exclude_pools:
                continue
            p = self.score_job(job, self.pools[pname],
                               int(free.get(pname, 0)))
            if p is None:
                continue
            key = (not p.slo_ok, -p.tokens_per_s, pname)
            if best_key is None or key < best_key:
                best, best_key = p, key
        return best

    def allocate(self, capacity: Optional[Mapping[str, int]] = None
                 ) -> FleetAssignment:
        """Place every manifest job, priority-descending.  ``capacity``
        overrides the manifest pool counts (the supervisor passes the
        churned ledger when it re-allocates)."""
        free = {p.name: int(capacity[p.name]) if capacity is not None
                else p.count for p in self.manifest.pools}
        out = FleetAssignment(free=free)
        order = sorted(self.jobs.values(),
                       key=lambda j: (-j.priority, j.name))
        for job in order:
            p = self.place_job(job, free)
            if p is None:
                out.paused[job.name] = "capacity"
                _obs_report.emit("fleet", {
                    "job": job.name, "action": "paused",
                    "reason": "capacity"},
                    text="no pool can grant min_devices")
                continue
            out.placements[job.name] = p
            free[p.pool] -= p.devices
        return out

    def wide_sweep(self, job_name: str, pool_name: str, n_devices: int,
                   k: int = 5, stats: Optional[dict] = None):
        """Top-``k`` of the FULL (plan-variant × mesh) product for one
        (job, pool) through ``planspace.stream_topk`` — the bounded-memory
        wide path for capacity studies far beyond the placement sweep.
        Returns (seconds, plan, mesh) triples."""
        from repro_torch.launch.autoshard import candidate_meshes, candidate_plans
        job = self.jobs[job_name]
        pool = self.pools[pool_name]
        cfg = ARCHS[job.arch]
        plans = candidate_plans(cfg, job.workload)
        meshes = candidate_meshes(job.workload, n_devices=n_devices)
        return planspace.stream_topk(cfg, job.workload, plans, meshes,
                                     self.models[pool.device], k=k,
                                     stats=stats, kernels=self.kernels)


# ---------------------------------------------------------------------------
# CLI  (python -m repro_torch.launch fleet …)
# ---------------------------------------------------------------------------


def _print_assignment(a: FleetAssignment) -> None:
    for name, p in sorted(a.placements.items()):
        _obs_report.emit("fleet", {
            "job": name, "pool": p.pool, "devices": p.devices,
            "mesh": "x".join(str(v) for _, v in p.mesh),
            "pred_ms": f"{p.predicted_step_s * 1e3:.3f}",
            "tok_s": f"{p.tokens_per_s:.0f}",
            "slo": "ok" if p.slo_ok else "MISS"},
            text="placed")
    for name, why in sorted(a.paused.items()):
        _obs_report.emit("fleet", {"job": name, "action": "paused",
                                   "reason": why}, text="not placed")


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch fleet", description=__doc__)
    ap.add_argument("--manifest", default="demo", metavar="PATH|demo",
                    help="fleet manifest JSON (docs/FLEET.md schema), or "
                         "'demo' for the built-in 2-pool/3-job fixture")
    ap.add_argument("--steps", type=int, default=12,
                    help="supervised fleet steps to run (0: allocate only)")
    ap.add_argument("--fault-plan", default=None, metavar="SPEC|PATH",
                    help="deterministic churn schedule, e.g. "
                         "'pool_shrink@5:pool=a100,k=2'")
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--registry", default=None, metavar="DIR",
                    help="model-registry directory override")
    ap.add_argument("--hysteresis", type=float, default=0.15,
                    help="min fractional step-time improvement before a "
                         "voluntary rebalance moves a job")
    ap.add_argument("--cooldown-steps", type=int, default=3,
                    help="steps between voluntary rebalances of one job")
    ap.add_argument("--retry-after-steps", type=int, default=5,
                    help="steps before a capacity-paused job retries")
    ap.add_argument("--history-json", default=None, metavar="PATH",
                    help="write the placement history JSON on exit")
    ap.add_argument("--trace-json", default=None, metavar="PATH")
    ap.add_argument("--metrics-json", default=None, metavar="PATH")
    args = ap.parse_args(argv)

    if args.trace_json:
        _obs_trace.enable(process_name="fleet")

    manifest = load_manifest(args.manifest)
    allocator = FleetAllocator(manifest, registry_dir=args.registry)
    t0 = time.perf_counter()
    assignment = allocator.allocate()
    _obs_report.emit("fleet", {
        "manifest": manifest.name, "jobs": len(manifest.jobs),
        "pools": len(manifest.pools),
        "allocate_ms": f"{(time.perf_counter() - t0) * 1e3:.2f}"},
        text="initial allocation")
    _print_assignment(assignment)

    if args.steps > 0:
        from repro_torch.runtime.faults import FaultInjector, FaultPlan
        from repro_torch.runtime.fleet_supervisor import (FleetSupervisor,
                                                    SimJobRunner)
        fplan = FaultPlan.parse(args.fault_plan, seed=args.chaos_seed) \
            if args.fault_plan else FaultPlan(seed=args.chaos_seed)
        if fplan:
            _obs_report.emit("fleet",
                             text=f"fault plan armed: {fplan.describe()}")
        injector = FaultInjector(fplan, registry_dir=args.registry)
        sup = FleetSupervisor(
            allocator, injector=injector,
            runner_factory=SimJobRunner.factory(),
            hysteresis=args.hysteresis,
            cooldown_steps=args.cooldown_steps,
            retry_after_steps=args.retry_after_steps,
            assignment=assignment)
        sup.run(args.steps)
        sup.report()
        if args.history_json:
            d = os.path.dirname(args.history_json)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(args.history_json, "w") as f:
                f.write(sup.history_json())
            _obs_report.emit("fleet",
                             text=f"history written to {args.history_json}")

    tracer = _obs_trace.get_tracer()
    if args.trace_json:
        tracer.save(args.trace_json)
        _obs_report.emit("fleet",
                         text=f"trace written to {args.trace_json}")
    if args.metrics_json:
        _obs_metrics.REGISTRY.save_json(args.metrics_json)
        _obs_report.emit("fleet",
                         text=f"metrics written to {args.metrics_json}")


if __name__ == "__main__":
    main()
