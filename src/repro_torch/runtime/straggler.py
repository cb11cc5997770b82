"""Straggler detection + mitigation.

The monitor compares *observed* per-host step times against the cost
model's *predicted* step time (core/predictor.py) — the paper's §6.1 'load
balancing' application.  A host is a straggler when its EWMA exceeds
``k × max(predicted, fleet median)``.  ``StragglerMonitor.from_model``
derives the predicted step time from a cost model directly — an in-memory
``LinearCostModel``, a registry device name (``repro_torch.calibration``,
where a fitted ``gpu-h100`` shadows the analytic seed), or the analytic v5e
seed.

Mitigations (policy chosen by the trainer):
  * ``report``   — log only;
  * ``rescale``  — drop the host's microbatch contribution this step and
                   rescale the gradient (synchronous skip-and-rescale);
  * ``replan``   — hand off to distributed/elastic.py for a smaller mesh.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import exprops
from repro_torch.obs import metrics as _obs_metrics

#: incremental-rescore cache for monitor re-anchoring (see ``from_model``)
_BASIS_CACHE = exprops.BasisCache(maxsize=2048)

_STRAGGLER_EVENTS = _obs_metrics.REGISTRY.counter(
    "repro_straggler_events_total",
    "hosts flagged over the predicted-step threshold, by action")


@dataclass
class StragglerEvent:
    step: int
    host: int
    observed_s: float
    threshold_s: float
    action: str


@dataclass
class StragglerMonitor:
    n_hosts: int
    predicted_step_s: float
    k: float = 2.0              # threshold multiplier
    ewma: float = 0.5           # smoothing for per-host times
    policy: str = "rescale"     # report | rescale | replan
    _state: np.ndarray = field(default=None)  # per-host EWMA
    events: List[StragglerEvent] = field(default_factory=list)

    def __post_init__(self):
        if self._state is None:
            self._state = np.full(self.n_hosts, self.predicted_step_s)

    @classmethod
    def from_model(cls, cfg, workload, plan, mesh_shape, n_hosts: int,
                   model=None, kernels=None, **kw) -> "StragglerMonitor":
        """Build a monitor whose threshold is anchored to the cost model's
        predicted step time for (cfg × workload × plan × mesh).

        ``workload`` is any ``repro_torch.core.workload.WorkloadLike`` — a
        ``WorkloadSpec``, a ``ShapeConfig``, or the deprecated phase
        string (``predict_plans`` normalizes).

        ``model`` is anything ``predictor.resolve_model`` accepts: None (the
        analytic v5e seed), a registry device name, or a ``LinearCostModel``.

        The threshold is a pure step-time scalar, so it goes through the
        same batched engine as plan search (``predictor.predict_plans`` →
        ``core.planspace``) rather than the heavier ``predict_step``
        (which also assembles the per-property breakdown and MFU).
        Scoring passes the module's ``exprops.BasisCache``, so re-anchoring
        a monitor after a mesh/shape delta (e.g. post-``elastic.replan``)
        recomputes only the basis columns the delta touches.  ``kernels``:
        the registry the step program composes (``predictor``'s).
        """
        from repro_torch.core import predictor  # runtime sits above core
        secs = predictor.predict_plans(cfg, workload, [plan], mesh_shape,
                                       model, cache=_BASIS_CACHE,
                                       kernels=kernels)
        return cls(n_hosts=n_hosts, predicted_step_s=float(secs[0]), **kw)

    def threshold(self) -> float:
        return self.k * max(self.predicted_step_s,
                            float(np.median(self._state)))

    def reanchor(self, predicted_step_s: float) -> None:
        """Move the threshold anchor to a new predicted step time.

        Called after an online-calibration refit (``calibration/online.py``)
        so the straggler threshold tracks the refit model instead of the
        diverged one; the per-host EWMA state is kept — observed behavior
        didn't change, the model of it did."""
        self.predicted_step_s = float(predicted_step_s)

    def observe(self, step: int, host_times_s) -> List[StragglerEvent]:
        """Feed one step's per-host times; returns new straggler events."""
        t = np.asarray(host_times_s, dtype=np.float64)
        assert t.shape == (self.n_hosts,)
        self._state = self.ewma * self._state + (1 - self.ewma) * t
        thr = self.threshold()
        new = []
        for h in np.nonzero(self._state > thr)[0]:
            ev = StragglerEvent(step, int(h), float(self._state[h]), thr,
                                self.policy)
            new.append(ev)
            _STRAGGLER_EVENTS.inc(1, action=self.policy)
        self.events.extend(new)
        return new

    def healthy_mask(self) -> np.ndarray:
        return self._state <= self.threshold()

    def rescale_weight(self) -> float:
        """Gradient rescale for skip-and-rescale: N / N_healthy."""
        h = int(self.healthy_mask().sum())
        return self.n_hosts / max(h, 1)
