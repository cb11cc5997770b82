"""Supervised recovery: watchdogs, backoff, and the escalation ladder.

The ``Supervisor`` wraps a ``Trainer`` factory with the recovery loop the
paper's "rapid evaluation" property makes viable: when a step raises
``DeviceLossError`` (injected or real) or breaches its watchdog deadline
repeatedly, the supervisor sleeps a bounded exponentially-backed-off
delay, asks ``distributed/elastic.py`` for the best surviving mesh (a
microseconds-scale model query against the warm ``BasisCache``), rebuilds
the trainer — which resumes from the newest *valid* checkpoint — and
replays forward.  Exact global-batch semantics survive the failover
because the data pipeline is addressed by step and the RNG by a
(seed, step) fold: replayed steps recompute bit-identical batches.

Watchdog currency matches ``StragglerMonitor``: the deadline is
``k × max(model-predicted step seconds, median of recent measured
steps)`` — the prediction anchors the first steps, the median keeps the
deadline honest when the prediction is off (reduced-config CPU runs).
Breaches escalate a ladder, one rung per *consecutive* breach:

    1. **report** — emit a ``[supervisor]`` line + trace instant;
    2. **rescale** — widen the deadline (accept the new normal once);
    3. **replan** — kill the segment and fail over through
       ``elastic.replan`` (training) / shed-and-throttle (serving).

``ServingSupervisor`` is the serving twin: no replan target exists, so
degradation is graceful instead — evict the heaviest slot back to the
queue, throttle admissions for a few iterations, and shed queue overflow
with a ``retry_after_s`` stamp so the caller can come back (the
SLO-preserving behaviors from the LLMPerf regime).

Every recovery lands in ``repro_recovery_seconds`` (the MTTR histogram),
``repro_supervisor_recoveries_total{cause,action}``, and the final
``report()`` rollup.

A copy of the reference's ``runtime/supervisor.py`` with one deliberate
deviation: a recovery releases the dead trainer — drains its async
checkpointer, drops it and returns its memory to the card — BEFORE the
factory builds the new one (``release_trainer``).  The reference builds the
new trainer while the old one is still referenced; at full width on one
card that would hold two copies of the parameters and optimizer state.
The supervised history is unchanged by it (``tests/test_torch_faults.py``).
"""
from __future__ import annotations

import gc
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import report as _obs_report
from repro_torch.obs import trace as _obs_trace
from repro_torch.runtime.faults import DeviceLossError, FaultInjector

__all__ = ["BackoffPolicy", "Watchdog", "WatchdogTimeout", "RecoveryEvent",
           "Supervisor", "ServingPolicy", "ServingSupervisor"]

_RECOVERIES = _obs_metrics.REGISTRY.counter(
    "repro_supervisor_recoveries_total",
    "completed supervised recoveries, by cause and action taken")
_ESCALATIONS = _obs_metrics.REGISTRY.counter(
    "repro_supervisor_escalations_total",
    "watchdog escalation-ladder rungs fired, by action")
_RECOVERY_SECONDS = _obs_metrics.REGISTRY.histogram(
    "repro_recovery_seconds",
    "wall seconds from failure detection to a resumed trainer (MTTR)")
_EVICTIONS = _obs_metrics.REGISTRY.counter(
    "repro_slots_evicted_total",
    "decode slots evicted back to the queue by the serving supervisor")
_SHED = _obs_metrics.REGISTRY.counter(
    "repro_requests_shed_total",
    "queued requests shed with retry-after to preserve the serving SLO")
_THROTTLED = _obs_metrics.REGISTRY.counter(
    "repro_admission_throttled_total",
    "serving iterations whose slot refill was throttled by the supervisor")


@dataclass
class BackoffPolicy:
    """Bounded exponential backoff with seeded jitter.

    delay(attempt) = min(base·factor^attempt, max) × (1 + jitter·u),
    u ~ Uniform[-1, 1) from a generator seeded at construction — chaos
    runs sleep the same schedule every time (explicit ``seed=``)."""

    base_s: float = 0.05
    factor: float = 2.0
    max_s: float = 2.0
    jitter: float = 0.5
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def delay(self, attempt: int) -> float:
        raw = min(self.base_s * self.factor ** max(attempt, 0), self.max_s)
        u = 2.0 * self._rng.random() - 1.0
        return max(raw * (1.0 + self.jitter * u), 0.0)

    def sequence(self, n: int) -> List[float]:
        """The first ``n`` delays of a FRESH policy with this seed (pure —
        does not advance this instance's generator)."""
        probe = BackoffPolicy(self.base_s, self.factor, self.max_s,
                              self.jitter, self.seed)
        return [probe.delay(i) for i in range(n)]


class WatchdogTimeout(RuntimeError):
    """The watchdog ladder reached its replan rung: ``breaches``
    consecutive steps exceeded ``deadline_s`` (last measured: ``dt``)."""

    def __init__(self, step: int, dt: float, deadline_s: float,
                 breaches: int):
        self.step = step
        self.dt = dt
        self.deadline_s = deadline_s
        self.breaches = breaches
        super().__init__(
            f"step {step}: {breaches} consecutive breaches, last "
            f"{dt*1e3:.0f}ms > deadline {deadline_s*1e3:.0f}ms")


def drain_checkpointer(trainer) -> None:
    """Let a dead trainer's in-flight async save land (or swallow its
    error) before anything is rebuilt on top of its checkpoints."""
    ckpt = getattr(trainer, "ckpt", None)
    if ckpt is not None:
        try:
            ckpt.wait()
        except Exception:
            pass


def free_released_memory() -> None:
    """Collect what a dropped trainer left (its parameters, optimizer
    state and the frames of the step that raised) and hand the card's
    cached blocks back, so the next trainer fits where the old one was."""
    gc.collect()
    import torch
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


#: the ladder, one rung per consecutive breach (3+ stays on "replan")
_LADDER = ("report", "rescale", "replan")


class Watchdog:
    """Per-step deadline tracker in the ``StragglerMonitor`` currency:
    deadline = k × max(predicted_step_s, median of recent measured).

    The first ``warmup`` observations never breach (jit compile lands
    there) but do seed the median.  ``observe`` returns the ladder action
    for this step (None when within deadline) and the deadline it was
    judged against; the caller performs the action (the watchdog itself
    only widens ``k`` on ``rescale()``)."""

    def __init__(self, k: float = 6.0, warmup: int = 2, window: int = 16,
                 max_k: float = 64.0):
        self.k = float(k)
        self.warmup = int(warmup)
        self.max_k = float(max_k)
        self.recent: deque = deque(maxlen=window)
        self.breaches = 0       # consecutive
        self.n = 0

    def deadline_s(self, predicted_s: Optional[float]) -> float:
        med = float(np.median(self.recent)) if self.recent else 0.0
        base = max(float(predicted_s or 0.0), med)
        return self.k * base if base > 0.0 else float("inf")

    def observe(self, dt: float, predicted_s: Optional[float] = None):
        self.n += 1
        dl = self.deadline_s(predicted_s)
        breach = self.n > self.warmup and dt > dl
        self.recent.append(dt)
        if not breach:
            self.breaches = 0
            return None, dl
        self.breaches += 1
        return _LADDER[min(self.breaches, len(_LADDER)) - 1], dl

    def rescale(self, factor: float = 2.0) -> float:
        """Widen the deadline multiplier (the ladder's middle rung —
        accept the new normal instead of failing over)."""
        self.k = min(self.k * factor, self.max_k)
        self.breaches = 0
        return self.k

    def reset(self) -> None:
        self.breaches = 0
        self.recent.clear()
        self.n = 0


@dataclass(frozen=True)
class RecoveryEvent:
    """Audit record of one completed recovery."""
    step: int
    cause: str          # device_loss | watchdog
    action: str         # replan | keep
    mttr_s: float
    n_devices: int
    detail: str = ""


class Supervisor:
    """Runs a ``Trainer`` to ``total_steps`` through failures.

    ``factory(mesh_option_or_None) -> Trainer`` builds (and on recovery
    REbuilds) the trainer; pointing it at a persistent ``ckpt_dir`` is
    what makes recovery resume instead of restart — the trainer's own
    constructor restores the newest valid checkpoint.  ``cfg``/
    ``workload`` enable the model-guided replan (skipped, mesh kept,
    when absent); ``model``/``registry_dir`` name the cost model whose
    weights price the surviving meshes — resolved lazily at recovery
    time through the hardened registry, so a corrupt model file degrades
    to the previous revision rather than aborting the failover.
    """

    def __init__(self, factory: Callable[[Optional[Any]], Any],
                 total_steps: int, *, cfg=None, workload=None,
                 n_devices: int = 1, model=None,
                 registry_dir: Optional[str] = None,
                 injector: Optional[FaultInjector] = None,
                 watchdog_k: float = 6.0, warmup_steps: int = 2,
                 backoff: Optional[BackoffPolicy] = None,
                 max_recoveries: int = 8,
                 sleep: Callable[[float], None] = time.sleep):
        self.factory = factory
        self.total_steps = int(total_steps)
        self.cfg = cfg
        self.workload = workload
        self.n_devices = int(n_devices)
        self.model = model
        self.registry_dir = registry_dir
        self.injector = injector
        self.backoff = backoff or BackoffPolicy()
        self.max_recoveries = int(max_recoveries)
        self.sleep = sleep
        self.watchdog = Watchdog(k=watchdog_k, warmup=warmup_steps)
        self.mesh = None                       # current MeshOption (or None)
        self.recoveries: List[RecoveryEvent] = []
        self.steps_run = 0                     # executions incl. replays
        self._history: Dict[int, Dict[str, float]] = {}
        self.trainer = None

    # ------------------------------------------------------------------
    @property
    def history(self) -> List[Dict[str, float]]:
        """Per-step metrics, replays collapsed last-write-wins — directly
        comparable against an unsupervised run's ``trainer.history``."""
        return [self._history[s] for s in sorted(self._history)]

    def _weights(self):
        """The replan cost model, through the hardened registry (corrupt
        active file → previous revision).  None on any failure: elastic
        falls back to its default analytic model."""
        if self.model is None or not isinstance(self.model, str):
            return self.model
        from repro_torch.calibration import registry
        try:
            return registry.load_model(self.model, self.registry_dir)
        except Exception:
            return None

    def _on_metrics(self, step: int, m: Dict[str, float]) -> None:
        self.steps_run += 1
        self._history[step] = m
        predicted = None
        if self.trainer is not None:
            predicted = getattr(self.trainer, "monitor", None)
            predicted = predicted.predicted_step_s if predicted else None
        action, dl = self.watchdog.observe(m["time_s"], predicted)
        if action is None:
            return
        _ESCALATIONS.inc(1, action=action)
        _obs_trace.get_tracer().instant("watchdog_" + action, step=step,
                                        dt_s=m["time_s"], deadline_s=dl)
        if action == "replan":
            raise WatchdogTimeout(step, m["time_s"], dl,
                                  self.watchdog.breaches)
        if action == "rescale":
            k = self.watchdog.rescale()
            _obs_report.emit("supervisor", {
                "step": step, "action": "rescale", "k": f"{k:g}",
                "dt_ms": f"{m['time_s']*1e3:.0f}",
                "deadline_ms": f"{dl*1e3:.0f}"})
        else:  # report
            _obs_report.emit("supervisor", {
                "step": step, "action": "report",
                "dt_ms": f"{m['time_s']*1e3:.0f}",
                "deadline_ms": f"{dl*1e3:.0f}"},
                text="step exceeded watchdog deadline")

    # ------------------------------------------------------------------
    def run(self) -> List[Dict[str, float]]:
        """Train to ``total_steps`` through failures; returns the
        collapsed per-step history (see ``history``)."""
        self.trainer = self.factory(self.mesh)
        while True:
            remaining = self.total_steps - self.trainer.step
            if remaining <= 0:
                break
            try:
                self.trainer.train(remaining, on_metrics=self._on_metrics)
                continue
            except DeviceLossError as e:
                step = e.step if e.step is not None else self.trainer.step
                cause, lost, detail = "device_loss", e.count, \
                    f"lost={e.count}"
            except WatchdogTimeout as e:
                step, cause, lost, detail = e.step, "watchdog", 0, \
                    f"breaches={e.breaches}"
            # recover outside the handler: the exception's traceback holds
            # the dead trainer's step frames until the handler ends
            self._recover(cause, step, lost=lost, detail=detail)
        return self.history

    def _recover(self, cause: str, step: int, *, lost: int,
                 detail: str = "") -> None:
        t0 = time.perf_counter()
        attempt = len(self.recoveries)
        if attempt >= self.max_recoveries:
            _obs_report.emit("supervisor", {
                "step": step, "cause": cause, "action": "abort",
                "recoveries": attempt},
                text="recovery budget exhausted")
            raise RuntimeError(
                f"supervisor: recovery budget exhausted "
                f"({attempt} >= {self.max_recoveries}) at step {step}")
        self.sleep(self.backoff.delay(attempt))
        # drain the dead trainer's async checkpointer so its in-flight
        # save lands before we rebuild on top, then release it: the new
        # trainer is built where the old one was
        drain_checkpointer(self.trainer)
        self.trainer = None
        free_released_memory()

        action = "keep"
        survivors = self.n_devices - (lost if cause == "device_loss" else 0)
        if self.cfg is not None and self.workload is not None:
            from repro_torch.distributed import elastic
            try:
                if cause == "device_loss":
                    self.mesh = elastic.on_failure(
                        self.cfg, self.workload, self.n_devices, lost,
                        self._weights())
                    action = "replan"
                else:
                    opts = elastic.replan(self.cfg, self.workload,
                                          survivors, self._weights())
                    if opts:
                        self.mesh = opts[0]
                        action = "replan"
            except Exception as exc:
                _obs_report.emit("supervisor",
                                 {"step": step, "action": "keep"},
                                 text=f"replan failed ({exc}); keeping "
                                      f"current mesh")
        self.n_devices = survivors
        if cause == "watchdog":
            # don't re-trip on the replayed window: accept the new normal
            self.watchdog.rescale()
        self.watchdog.reset()

        self.trainer = self.factory(self.mesh)
        mttr = time.perf_counter() - t0
        _RECOVERY_SECONDS.observe(mttr)
        _RECOVERIES.inc(1, cause=cause, action=action)
        _obs_trace.get_tracer().instant("recovery", step=step, cause=cause,
                                        action=action, mttr_s=mttr)
        ev = RecoveryEvent(step, cause, action, mttr, self.n_devices,
                           detail)
        self.recoveries.append(ev)
        fields = {"step": step, "cause": cause, "action": action,
                  "mttr_ms": f"{mttr*1e3:.1f}",
                  "devices": self.n_devices,
                  "resume_step": self.trainer.step}
        if self.mesh is not None:
            fields["mesh"] = "x".join(
                str(v) for v in self.mesh.shape.values())
            fields["predicted_ms"] = \
                f"{self.mesh.predicted_step_s*1e3:.3f}"
        if detail:
            fields["detail"] = detail
        _obs_report.emit("supervisor", fields, text="recovered")

    # ------------------------------------------------------------------
    def mttr_s(self) -> float:
        return float(np.mean([r.mttr_s for r in self.recoveries])) \
            if self.recoveries else 0.0

    def report(self, printer=print) -> str:
        """The end-of-run rollup ``[supervisor]`` line (MTTR, recovery and
        injected-fault counts) — what ``chip_smoke.py`` reads."""
        fields: Dict[str, object] = {
            "steps": len(self._history),
            "steps_run": self.steps_run,
            "recoveries": len(self.recoveries),
            "mttr_s": f"{self.mttr_s():.3f}",
            "devices": self.n_devices,
        }
        if self.injector is not None:
            counts = self.injector.counts()
            fields["faults"] = ",".join(
                f"{k}:{v}" for k, v in sorted(counts.items())) or "none"
        return _obs_report.emit("supervisor", fields, text="run complete",
                                printer=printer)


# ---------------------------------------------------------------------------
# Serving-side supervision: graceful degradation, not failover
# ---------------------------------------------------------------------------


@dataclass
class ServingPolicy:
    """Knobs for ``ServingSupervisor``'s degradation ladder."""
    watchdog_k: float = 6.0
    warmup_iters: int = 2
    max_queue: Optional[int] = None    # shed arrivals beyond this depth
    throttle_iters: int = 4            # refill freeze after an eviction
    retry_after_s: float = 1.0         # stamped on shed requests


class ServingSupervisor:
    """Wraps a ``DecodeServer`` with SLO-preserving degradation.

    The training ladder's "replan" rung has no serving analogue (there is
    no better mesh to fail over to mid-request), so rungs 2/3 degrade
    instead: **rescale** → evict the heaviest slot back to the queue
    front and throttle refills for ``throttle_iters`` iterations;
    **replan** → additionally shed queue overflow with a
    ``retry_after_s`` stamp and widen the watchdog.  Device loss from the
    injector evicts every occupied slot (their requests resume from their
    generated prefix on re-admission) and throttles.
    """

    def __init__(self, server, policy: Optional[ServingPolicy] = None,
                 injector: Optional[FaultInjector] = None):
        self.server = server
        self.policy = policy or ServingPolicy()
        self.injector = injector
        self.watchdog = Watchdog(k=self.policy.watchdog_k,
                                 warmup=self.policy.warmup_iters)
        self.shed: List[Any] = []
        self.evictions = 0
        self._throttle = 0
        self._iters = 0

    # -- degradation primitives -------------------------------------------
    def _shed_overflow(self) -> None:
        q = self.server.queue
        if self.policy.max_queue is None or \
                len(q) <= self.policy.max_queue:
            return
        overflow = q[self.policy.max_queue:]
        del q[self.policy.max_queue:]
        for r in overflow:
            r.shed = True
            r.retry_after_s = self.policy.retry_after_s
        self.shed.extend(overflow)
        _SHED.inc(len(overflow))
        _obs_trace.get_tracer().instant(
            "requests_shed", n=len(overflow),
            retry_after_s=self.policy.retry_after_s)
        _obs_report.emit("supervisor", {
            "action": "shed", "n": len(overflow),
            "retry_after_s": self.policy.retry_after_s})

    def _evict(self, slots: List[int], why: str) -> None:
        for s in slots:
            if self.server.active[s] is None:
                continue
            rid = self.server.active[s].rid
            self.server.evict_slot(s)
            self.evictions += 1
            _EVICTIONS.inc()
            _obs_trace.get_tracer().instant("slot_evicted", slot=s,
                                            rid=rid, why=why)
            _obs_report.emit("supervisor", {"action": "evict", "slot": s,
                                            "rid": rid, "why": why})
        self._throttle = max(self._throttle, self.policy.throttle_iters)

    def _heaviest_slot(self) -> Optional[int]:
        occ = [s for s, r in enumerate(self.server.active) if r is not None]
        if not occ:
            return None
        ctx = self.server._ctx
        return max(occ, key=lambda s: int(ctx[s]))

    # -- the supervised serve loop ----------------------------------------
    def run(self, max_iters: int = 10_000) -> List[Any]:
        """Serve until queue + slots drain (shed requests excluded);
        returns completed requests, like ``DecodeServer.run``."""
        srv = self.server
        done: List[Any] = []
        pending = lambda: srv.queue or any(srv.active)
        while pending() and self._iters < max_iters:
            it = self._iters
            self._shed_overflow()
            if self.injector is not None:
                try:
                    self.injector.decode_begin(it)
                except DeviceLossError:
                    occupied = [s for s, r in enumerate(srv.active)
                                if r is not None]
                    self._evict(occupied, why="device_loss")
            if self._throttle > 0:
                self._throttle -= 1
                _THROTTLED.inc()
            else:
                srv._refill()
            before = [r for r in srv.active if r]
            if not before:
                self._iters += 1
                if not srv.queue:
                    break
                continue
            dt = srv.step()
            self._iters += 1
            predicted = None
            if srv.scorer is not None:
                predicted = float(srv.scorer.decode_step_seconds(
                    max(len(before), 1), srv._cache_tokens()))
            action, dl = self.watchdog.observe(dt, predicted)
            if action is not None:
                _ESCALATIONS.inc(1, action=action)
                _obs_trace.get_tracer().instant(
                    "watchdog_" + action, iter=it, dt_s=dt, deadline_s=dl)
                if action == "report":
                    _obs_report.emit("supervisor", {
                        "iter": it, "action": "report",
                        "dt_ms": f"{dt*1e3:.0f}",
                        "deadline_ms": f"{dl*1e3:.0f}"},
                        text="decode exceeded watchdog deadline")
                elif action == "rescale":
                    heavy = self._heaviest_slot()
                    if heavy is not None:
                        self._evict([heavy], why="watchdog")
                    self.watchdog.breaches = 0
                else:  # replan rung: shed + accept the new normal
                    if self.policy.max_queue is not None:
                        self._shed_overflow()
                    heavy = self._heaviest_slot()
                    if heavy is not None:
                        self._evict([heavy], why="watchdog")
                    self.watchdog.rescale()
            done.extend(r for r in before if r.done)
        return done

    def report(self, printer=print) -> str:
        fields = {"iters": self._iters, "evictions": self.evictions,
                  "shed": len(self.shed)}
        if self.injector is not None:
            counts = self.injector.counts()
            fields["faults"] = ",".join(
                f"{k}:{v}" for k, v in sorted(counts.items())) or "none"
        return _obs_report.emit("supervisor", fields,
                                text="serve complete", printer=printer)
