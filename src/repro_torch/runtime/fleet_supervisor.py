"""FleetSupervisor: churn-tolerant supervision of a multi-job fleet.

Consumes fleet-scoped pool-churn events from the deterministic fault
injector (``runtime/faults.py``: ``pool_shrink`` / ``pool_grow`` /
pool-attributed ``device_loss``) and drives a **degradation ladder** over
the ``FleetAllocator``'s placements (``launch/fleet.py``):

  1. **warm incremental replan** — a job that still fits the shrunken
     pool rescores its (count × plan × mesh) space through the same
     per-(job, pool) ``BasisCache`` allocation warmed, so only the
     device-count-dependent basis columns recompute;
  2. **migrate** — a job the pool can no longer hold moves to the best
     other pool, cheapest-to-move first (checkpoint handoff bytes); a
     trainer-backed job rebuilds from ``restore_latest_valid`` and
     replays the steps since its last checkpoint with exact batch
     semantics (the loader is addressed by step);
  3. **shrink** — if no pool has room, lower-priority placements on the
     best candidate pool halve down (power-of-two, never below their
     ``min_devices``) to make room;
  4. **pause/shed** — when nothing frees enough devices the job pauses
     with a retry-after stamp and re-attempts placement periodically
     (and immediately on ``pool_grow``).

Voluntary moves (on ``pool_grow``) are **hysteresis-gated**: a job only
rebalances when the predicted step time improves by more than the
``hysteresis`` fraction AND its ``cooldown_steps`` have elapsed — repeated
churn cannot thrash placements (pinned in ``tests/test_torch_fleet.py``).

Every decision is deterministic: same manifest + same ``FaultPlan`` seed
⇒ byte-identical ``history_json()``.  With an EMPTY plan the supervised
run's placements are identical to the bare allocator's (the fleet twin of
the empty-injector identity in ``tests/test_torch_faults.py``).

A copy of the reference's ``runtime/fleet_supervisor.py``; as the port's
``Supervisor``, ``TrainerJobRunner.bind`` releases the old trainer before
it builds the new one.
"""
from __future__ import annotations

import json
import time
from typing import Callable, Dict, List, Optional

from repro_torch.launch.fleet import (FleetAllocator, FleetAssignment, JobSpec,
                                Placement)
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import report as _obs_report
from repro_torch.obs import trace as _obs_trace
from repro_torch.runtime.supervisor import (drain_checkpointer,
                                            free_released_memory)

_CHURN = _obs_metrics.REGISTRY.counter(
    "repro_fleet_churn_events_total",
    "pool-churn events the fleet supervisor consumed, by kind")
_REPLANS = _obs_metrics.REGISTRY.counter(
    "repro_fleet_replans_total",
    "fleet placement changes, by ladder action "
    "(replan|migrate|shrink|pause|resume|rebalance)")
_REPLAN_SECONDS = _obs_metrics.REGISTRY.histogram(
    "repro_fleet_replan_seconds",
    "wall seconds one churn event's ladder repair took (warm replans)")
_JOBS = _obs_metrics.REGISTRY.gauge(
    "repro_fleet_jobs", "fleet jobs by state (active|paused)")


# ---------------------------------------------------------------------------
# Job runners
# ---------------------------------------------------------------------------


class SimJobRunner:
    """Deterministic host-only runner: each tick records the placement it ran
    under — what the CLI chaos smoke and the byte-identical-history tests
    drive (real training is ``TrainerJobRunner``'s job)."""

    def __init__(self, job: JobSpec, target: Optional[int] = None):
        self.job = job
        self.target = target
        self.placement: Optional[Placement] = None
        self.ticks = 0
        self._history: List[Dict[str, object]] = []

    @classmethod
    def factory(cls, target: Optional[int] = None
                ) -> Callable[[JobSpec], "SimJobRunner"]:
        return lambda job: cls(job, target)

    def set_target(self, n: int) -> None:
        if self.target is None:
            self.target = n

    def bind(self, placement: Placement) -> None:
        self.placement = placement

    def tick(self, step: int) -> None:
        p = self.placement
        self._history.append({
            "step": self.ticks, "pool": p.pool, "devices": p.devices,
            "step_s": p.predicted_step_s})
        self.ticks += 1

    @property
    def done(self) -> bool:
        return self.target is not None and self.ticks >= self.target

    @property
    def history(self) -> List[Dict[str, object]]:
        return list(self._history)


class TrainerJobRunner:
    """A real training job under fleet supervision.

    ``trainer_factory(job, placement)`` builds a ``runtime.trainer.Trainer``
    for a placement; construction restores from the newest VALID checkpoint
    (``store.restore_latest_valid``), so a migration = drain the old
    trainer's async checkpointer, rebuild, and replay the steps since the
    last checkpoint — the loader is addressed by the checkpointed step, so
    the replayed batches are exactly the lost ones.  History merges
    last-write-wins by trainer step: after recovery it is step-for-step
    comparable to a fault-free run (the rtol 1e-5 contract)."""

    def __init__(self, job: JobSpec, trainer_factory,
                 target: Optional[int] = None):
        self.job = job
        self.target = target
        self._factory = trainer_factory
        self.trainer = None
        self.placement: Optional[Placement] = None
        self._history: Dict[int, Dict[str, float]] = {}

    @classmethod
    def factory(cls, trainer_factory, target: Optional[int] = None
                ) -> Callable[[JobSpec], "TrainerJobRunner"]:
        return lambda job: cls(job, trainer_factory, target)

    def set_target(self, n: int) -> None:
        if self.target is None:
            self.target = n

    def bind(self, placement: Placement) -> None:
        if self.trainer is not None:
            # as the Supervisor: the old trainer is drained and released
            # before the new one is built on the same card
            drain_checkpointer(self.trainer)
            self.trainer = None
            free_released_memory()
        self.placement = placement
        self.trainer = self._factory(self.job, placement)

    def tick(self, step: int) -> None:
        if self.done:
            return
        self.trainer.train(
            1, on_metrics=lambda s, m: self._history.__setitem__(s, m))

    @property
    def done(self) -> bool:
        return self.target is not None and self.trainer is not None \
            and int(self.trainer.step) >= self.target

    @property
    def history(self) -> List[Dict[str, float]]:
        return [self._history[k] for k in sorted(self._history)]

    def finish(self) -> None:
        drain_checkpointer(self.trainer)


# ---------------------------------------------------------------------------
# The supervisor
# ---------------------------------------------------------------------------


class FleetSupervisor:
    """Supervises a ``FleetAllocator`` assignment through pool churn.

    ``runner_factory(job) -> runner`` builds one runner per placed job
    (``SimJobRunner.factory()`` default).  ``injector`` is a
    ``runtime.faults.FaultInjector`` whose ``fleet_events(step)`` feeds the
    churn; None (or an empty plan) supervises without perturbing —
    placements then never change from the initial allocation."""

    def __init__(self, allocator: FleetAllocator, *,
                 injector=None,
                 runner_factory: Optional[Callable] = None,
                 hysteresis: float = 0.15,
                 cooldown_steps: int = 3,
                 retry_after_steps: int = 5,
                 assignment: Optional[FleetAssignment] = None):
        self.allocator = allocator
        self.injector = injector
        self.hysteresis = float(hysteresis)
        self.cooldown_steps = int(cooldown_steps)
        self.retry_after_steps = int(retry_after_steps)
        self.capacity: Dict[str, int] = {
            p.name: p.count for p in allocator.manifest.pools}
        self.assignment = assignment if assignment is not None \
            else allocator.allocate()
        factory = runner_factory or SimJobRunner.factory()
        self.runners = {name: factory(allocator.jobs[name])
                        for name in sorted(allocator.jobs)}
        for name, p in self.assignment.placements.items():
            self.runners[name].bind(p)
        self._paused_at: Dict[str, int] = {
            name: 0 for name in self.assignment.paused}
        self._last_move: Dict[str, int] = {}
        self.placement_history: List[Dict[str, object]] = []
        self.actions: Dict[str, int] = {}
        self._record(-1, "allocate")

    # -- ledger ------------------------------------------------------------
    def used(self, pool: str) -> int:
        return sum(p.devices for p in self.assignment.placements.values()
                   if p.pool == pool)

    def free_map(self) -> Dict[str, int]:
        return {name: self.capacity[name] - self.used(name)
                for name in sorted(self.capacity)}

    def _record(self, step: int, event: str) -> None:
        self.assignment.free = self.free_map()
        self.placement_history.append({
            "step": step, "event": event,
            "assignment": self.assignment.to_json_dict()})
        _JOBS.set(len(self.assignment.placements), state="active")
        _JOBS.set(len(self.assignment.paused), state="paused")

    def history_json(self) -> str:
        return json.dumps(self.placement_history, sort_keys=True, indent=1)

    def _act(self, action: str) -> None:
        self.actions[action] = self.actions.get(action, 0) + 1
        _REPLANS.inc(1, action=action)

    #: ladder action -> the past-tense report token of the ``[fleet]`` lines
    _DONE = {"replan": "replanned", "migrate": "migrated",
             "shrink": "shrunk", "resume": "resumed",
             "rebalance": "rebalanced"}

    # -- the ladder --------------------------------------------------------
    def _replace(self, name: str, p: Placement, step: int,
                 action: str, detail: str) -> None:
        old = self.assignment.placements.get(name)
        self.assignment.placements[name] = p
        self.assignment.paused.pop(name, None)
        self._paused_at.pop(name, None)
        self.runners[name].bind(p)
        self._act(action)
        frm = f"{old.pool}:{old.devices}" if old else "<paused>"
        _obs_report.emit("fleet", {
            "step": step, "job": name, "action": self._DONE[action],
            "from": frm, "to": f"{p.pool}:{p.devices}",
            "pred_ms": f"{p.predicted_step_s * 1e3:.3f}"}, text=detail)

    def _pause(self, name: str, step: int, reason: str) -> None:
        self.assignment.placements.pop(name, None)
        self.assignment.paused[name] = reason
        self._paused_at[name] = step
        self._act("pause")
        _obs_report.emit("fleet", {
            "step": step, "job": name, "action": "paused",
            "reason": reason,
            "retry_after": step + self.retry_after_steps},
            text="shed until capacity returns")

    def _repair_pool(self, pool_name: str, step: int, kind: str) -> None:
        """Run the degradation ladder until ``pool_name`` fits its
        capacity.  Terminates: every rung strictly decreases the pool's
        used-device count (replan/migrate/pause all shed devices)."""
        t0 = time.perf_counter()
        cap = self.capacity[pool_name]
        on_pool = sorted(
            (n for n, p in self.assignment.placements.items()
             if p.pool == pool_name),
            key=lambda n: (-self.allocator.jobs[n].priority, n))
        summary: List[str] = []
        remaining = cap
        displaced: List[str] = []
        for name in on_pool:
            job = self.allocator.jobs[name]
            cur = self.assignment.placements[name]
            grant = self.allocator.candidate_counts(
                job, min(remaining, cur.devices))
            if not grant:
                displaced.append(name)
                continue
            if grant[0] == cur.devices:
                remaining -= cur.devices
                summary.append(f"{name} kept {cur.devices}")
                continue
            # rung 1: warm incremental replan inside the shrunken pool —
            # same (job, pool) BasisCache the allocation warmed
            p = self.allocator.score_job(
                job, self.allocator.pools[pool_name], grant[0])
            if p is None:
                displaced.append(name)
                continue
            remaining -= p.devices
            self._replace(name, p, step, "replan",
                          f"pool {pool_name} shrank; warm replan "
                          f"{cur.devices} -> {p.devices} devices")
            summary.append(f"{name} replanned {cur.devices}->{p.devices}")
        # rung 2: migrate displaced jobs, cheapest checkpoint handoff first
        for name in sorted(displaced,
                           key=lambda n: (self.allocator.jobs[n]
                                          .move_cost_bytes(), n)):
            job = self.allocator.jobs[name]
            cur = self.assignment.placements.pop(name)
            target = self.allocator.place_job(job, self.free_map(),
                                              exclude_pools=(pool_name,))
            if target is None and self._shrink_for(job, pool_name, step,
                                                   summary):
                target = self.allocator.place_job(
                    job, self.free_map(), exclude_pools=(pool_name,))
            if target is not None:
                self.assignment.placements[name] = cur  # for the from= log
                self._replace(name, target, step, "migrate",
                              f"pool {pool_name} cannot hold "
                              f"{job.min_devices}+ devices; checkpoint "
                              f"handoff and exact-batch replay")
                summary.append(f"{name} migrated -> {target.pool}")
            else:
                self._pause(name, step, f"churn:{pool_name}")
                summary.append(f"{name} paused")
        dt = time.perf_counter() - t0
        _REPLAN_SECONDS.observe(dt)
        _obs_trace.get_tracer().instant("fleet_replan", step=step,
                                        pool=pool_name, kind=kind,
                                        repair_s=dt)
        _obs_report.emit("fleet", {
            "step": step, "pool": pool_name, "cap": cap,
            "repair_ms": f"{dt * 1e3:.3f}"},
            text=f"replanned: {'; '.join(summary) or 'no jobs affected'}")

    def _shrink_for(self, job: JobSpec, exclude: str, step: int,
                    summary: List[str]) -> bool:
        """Rung 3: halve lower-priority placements (power-of-two, floored
        at their ``min_devices``) on the pool closest to fitting ``job``,
        until it has ``min_devices`` free.  Returns True if room opened."""
        candidates = sorted(
            (n for n in self.capacity if n != exclude),
            key=lambda n: (-(self.capacity[n] - self.used(n)), n))
        for pname in candidates:
            victims = sorted(
                (n for n, p in self.assignment.placements.items()
                 if p.pool == pname
                 and self.allocator.jobs[n].priority < job.priority),
                key=lambda n: (self.allocator.jobs[n].priority, n))
            for vname in victims:
                if self.capacity[pname] - self.used(pname) \
                        >= job.min_devices:
                    break
                vjob = self.allocator.jobs[vname]
                vcur = self.assignment.placements[vname]
                new_n = vcur.devices // 2
                if new_n < vjob.min_devices:
                    continue
                p = self.allocator.score_job(
                    vjob, self.allocator.pools[pname], new_n)
                if p is None:
                    continue
                self._replace(vname, p, step, "shrink",
                              f"making room on {pname} for higher-"
                              f"priority {job.name}")
                summary.append(f"{vname} shrunk {vcur.devices}->"
                               f"{p.devices}")
            if self.capacity[pname] - self.used(pname) >= job.min_devices:
                return True
        return False

    def _try_resume(self, step: int, on_grow: bool) -> None:
        """Resume paused jobs (priority-descending) whose retry-after
        elapsed — or immediately when a pool just grew."""
        paused = sorted(self.assignment.paused,
                        key=lambda n: (-self.allocator.jobs[n].priority, n))
        for name in paused:
            if not on_grow and step - self._paused_at.get(name, 0) \
                    < self.retry_after_steps:
                continue
            job = self.allocator.jobs[name]
            p = self.allocator.place_job(job, self.free_map())
            if p is not None:
                self._replace(name, p, step, "resume",
                              "capacity returned; resuming from latest "
                              "valid checkpoint")
            else:
                self._paused_at[name] = step   # re-stamp retry-after
                if on_grow:
                    _obs_report.emit("fleet", {
                        "step": step, "job": name, "action": "paused",
                        "retry_after": step + self.retry_after_steps},
                        text="still no room after pool_grow")

    def _rebalance(self, step: int) -> None:
        """Hysteresis-gated voluntary moves after a ``pool_grow``: a job
        relocates only for a > ``hysteresis`` fractional step-time win,
        at most once per ``cooldown_steps`` — churn cannot thrash."""
        for name in sorted(self.assignment.placements,
                           key=lambda n: (-self.allocator.jobs[n].priority,
                                          n)):
            if step - self._last_move.get(name, -10 ** 9) \
                    < self.cooldown_steps:
                continue
            cur = self.assignment.placements[name]
            free = self.free_map()
            free[cur.pool] += cur.devices   # its own devices come back
            best = self.allocator.place_job(self.allocator.jobs[name], free)
            if best is None or (best.pool == cur.pool
                                and best.devices == cur.devices):
                continue
            gain = (cur.predicted_step_s - best.predicted_step_s) \
                / cur.predicted_step_s
            if gain <= self.hysteresis:
                continue
            self._last_move[name] = step
            self._replace(name, best, step, "rebalance",
                          f"{gain * 100:.1f}% predicted win clears "
                          f"{self.hysteresis * 100:.0f}% hysteresis")

    # -- churn entry -------------------------------------------------------
    def _apply_event(self, fault, step: int) -> None:
        _CHURN.inc(1, kind=fault.kind)
        pool = fault.pool or self.allocator.manifest.pools[0].name
        if pool not in self.capacity:
            _obs_report.emit("fleet", {"step": step, "pool": pool},
                             text=f"ignoring {fault.kind} for unknown pool")
            return
        _obs_trace.get_tracer().instant("pool_churn", step=step,
                                        kind=fault.kind, pool=pool,
                                        count=fault.count)
        if fault.kind == "pool_grow":
            self.capacity[pool] += fault.count
            _obs_report.emit("fleet", {
                "step": step, "pool": pool, "event": "pool_grow",
                "cap": self.capacity[pool]}, text="capacity added")
            self._try_resume(step, on_grow=True)
            self._rebalance(step)
        else:   # pool_shrink, or device_loss attributed to a pool
            self.capacity[pool] = max(0, self.capacity[pool] - fault.count)
            _obs_report.emit("fleet", {
                "step": step, "pool": pool, "event": fault.kind,
                "cap": self.capacity[pool]}, text="capacity lost")
            if self.used(pool) > self.capacity[pool]:
                self._repair_pool(pool, step, fault.kind)
        self._record(step, f"{fault.kind}:{pool}")

    # -- main loop ---------------------------------------------------------
    def run(self, n_steps: int, drain: bool = True) -> FleetAssignment:
        """Tick every active job ``n_steps`` fleet steps, consuming churn
        events between ticks.  With ``drain`` the loop then keeps ticking
        (churn-free) until every runner reports done — a migrated
        trainer's checkpoint replay gets the extra ticks it needs to
        reach the same final step as a fault-free run."""
        for r in self.runners.values():
            if hasattr(r, "set_target"):
                r.set_target(n_steps)
        for step in range(n_steps):
            if self.injector is not None:
                for fault in self.injector.fleet_events(step):
                    self._apply_event(fault, step)
            if self._paused_at and self.retry_after_steps > 0:
                self._try_resume(step, on_grow=False)
            for name in sorted(self.assignment.placements):
                self.runners[name].tick(step)
        if drain:
            extra, budget = 0, max(4 * n_steps, 64)
            while extra < budget and any(
                    not getattr(self.runners[n], "done", True)
                    for n in self.assignment.placements):
                for name in sorted(self.assignment.placements):
                    r = self.runners[name]
                    if not getattr(r, "done", True):
                        r.tick(n_steps + extra)
                extra += 1
        for r in self.runners.values():
            if hasattr(r, "finish"):
                r.finish()
        self._record(n_steps, "final")
        return self.assignment

    def report(self) -> None:
        acts = ",".join(f"{k}={v}" for k, v in sorted(self.actions.items())) \
            or "none"
        churn = ",".join(f"{k}={v}" for k, v in sorted(
            (self.injector.counts() if self.injector else {}).items())) \
            or "none"
        _obs_report.emit("fleet", {
            "jobs": len(self.runners),
            "active": len(self.assignment.placements),
            "paused": len(self.assignment.paused),
            "actions": acts, "churn": churn},
            text="run complete")
