"""Online calibration: streaming RLS refit + drift watch over live timings.

This is the robustness layer over every model-guided decision the
framework makes: a scheduler serving live traffic must notice when the
hardware it runs on stops matching the model it plans with.  Three pieces,
composed by ``OnlineCalibrator``:

  * a ``TelemetrySink`` (``calibration/telemetry.py``) buffering the
    (property vector, measured seconds) samples the trainer / server feed;
  * an ``RLSState`` (``core/fit.py``) tracking the relative-error fit
    recursively, warm-started from the registered model;
  * a ``DriftMonitor`` — two-sided CUSUM over normalized residuals against
    the *tracked* fit (styled after ``runtime/straggler.py``'s monitor:
    observe per step, accumulate evidence, emit typed events).

On a drift event the calibrator refits from the samples since the CUSUM's
own change-point estimate (the excursion onset), swaps in a NEW
``LinearCostModel`` instance — never mutating weights in place, which
would leave stale folded-weight entries in every ``BasisProgram`` that
ever scored the old instance — bumps the registered revision through
``calibration/registry.register_revision`` (the mtime change rolls the
``registry.fingerprint`` every fingerprint-keyed memo checks), and clears
any ``BasisCache`` handed to it, so no prediction path can keep serving
the diverged model silently.

A copy of the reference's ``calibration/online.py`` (numpy only): on the
same stream the port raises the same events at the same onsets and refits
to the same weights (``tests/test_torch_online_calibration.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.calibration import registry
from repro_torch.calibration.telemetry import TelemetrySink
from repro_torch.core import fit
from repro_torch.core.model import LinearCostModel, geomean
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _obs_trace

_CUSUM = _obs_metrics.REGISTRY.gauge(
    "repro_drift_cusum_evidence",
    "current CUSUM excursion height of the drift monitor (0 = quiet)")
_DRIFT_EVENTS = _obs_metrics.REGISTRY.counter(
    "repro_drift_events_total",
    "drift alarms emitted by the CUSUM monitor, by direction and phase")
_REFITS = _obs_metrics.REGISTRY.counter(
    "repro_calibration_refits_total",
    "model refits performed by online calibrators")


@dataclass(frozen=True)
class DriftEvent:
    seq: int                  # telemetry seq at detection
    step: Optional[int]       # producer step counter at detection
    onset_seq: int            # CUSUM excursion start — change-point estimate
    magnitude: float          # EWMA of the normalized residual at detection
    direction: str            # "slow" (device slower than model) | "fast"
    phase: str = "train"      # workload phase of the tipping sample


@dataclass
class DriftMonitor:
    """Two-sided CUSUM on normalized residuals ``(T_obs − T̂)/T̂``.

    The dead zone ``slack`` absorbs timing noise; evidence beyond it
    accumulates into ``g_pos`` (device slower than predicted) / ``g_neg``
    (faster), and either excursion crossing ``threshold`` emits a
    ``DriftEvent`` carrying the excursion's onset seq — the standard CUSUM
    change-point estimate, which the calibrator uses as its refit-window
    start.  A 1.5× slowdown with slack 0.15 accumulates ~0.35/sample, so
    the default threshold flags within ~25 samples; pure noise at σ ≲
    slack/2 accumulates nothing (the no-false-positive property the tests
    pin).  State resets after each event.
    """

    slack: float = 0.15
    threshold: float = 8.0
    ewma: float = 0.2              # weight of the newest residual
    g_pos: float = 0.0
    g_neg: float = 0.0
    mean: float = 0.0
    n: int = 0
    _onset_pos: Optional[int] = None
    _onset_neg: Optional[int] = None
    events: List[DriftEvent] = field(default_factory=list)

    def observe(self, seq: int, residual: float,
                step: Optional[int] = None,
                phase: str = "train") -> Optional[DriftEvent]:
        """Feed one normalized residual; returns a new event on alarm."""
        self.n += 1
        self.mean = (1 - self.ewma) * self.mean + self.ewma * residual

        g = max(0.0, self.g_pos + residual - self.slack)
        if g > 0 and self.g_pos == 0:
            self._onset_pos = seq
        self.g_pos = g
        if g == 0:
            self._onset_pos = None

        g = max(0.0, self.g_neg - residual - self.slack)
        if g > 0 and self.g_neg == 0:
            self._onset_neg = seq
        self.g_neg = g
        if g == 0:
            self._onset_neg = None

        if self.g_pos > self.threshold or self.g_neg > self.threshold:
            slow = self.g_pos > self.threshold
            onset = (self._onset_pos if slow else self._onset_neg)
            ev = DriftEvent(seq=seq, step=step,
                            onset_seq=seq if onset is None else onset,
                            magnitude=self.mean,
                            direction="slow" if slow else "fast",
                            phase=phase)
            self.events.append(ev)
            self.reset()
            return ev
        return None

    def reset(self) -> None:
        self.g_pos = self.g_neg = self.mean = 0.0
        self._onset_pos = self._onset_neg = None

    @property
    def status(self) -> str:
        return "ok" if max(self.g_pos, self.g_neg) <= self.threshold \
            else "drift"

    @property
    def evidence(self) -> float:
        """Current CUSUM excursion height (0 = fully quiet)."""
        return max(self.g_pos, self.g_neg)


class OnlineCalibrator:
    """Ties sink + RLS + drift watch + registry into one observe() loop.

    ``model`` is anything ``registry.resolve_model`` accepts.  Residuals
    for the drift watch are measured against the RLS-tracked prediction
    (not the static registered model) so a fixed model-vs-device offset is
    absorbed during ``warmup`` and only *changes* in device behavior
    accumulate drift evidence.  ``caches`` are ``exprops.BasisCache``
    instances to clear on refit; ``auto_register`` writes each refit model
    into the registry under ``device`` with a bumped revision.

    ``phase`` scopes the calibrator to one workload phase ("train" |
    "prefill" | "decode"): samples from other phases still land in the
    telemetry sink (phase-tagged), but never reach the RLS tracker or the
    drift CUSUM — one linear model fits one phase's regime, and a prefill
    burst must not read as train-time drift.  ``phase=None`` (default)
    accepts every sample, preserving the single-stream behavior for
    producers that feed one phase only; refit windows are ALWAYS filtered
    to the drift event's own phase.
    """

    def __init__(self, model=None, *, device: Optional[str] = None,
                 registry_dir: Optional[str] = None,
                 sink: Optional[TelemetrySink] = None,
                 drift: Optional[DriftMonitor] = None,
                 forgetting: float = 0.995, delta: float = 1e12,
                 warmup: int = 16, auto_register: bool = False,
                 caches: Sequence = (), residual: bool = False,
                 min_refit_samples: int = 2,
                 phase: Optional[str] = None):
        self.model = registry.resolve_model(model, registry_dir=registry_dir)
        self.device = device or self.model.device
        self.registry_dir = registry_dir
        self.sink = sink or TelemetrySink()
        self.drift = drift or DriftMonitor()
        self.forgetting = forgetting
        self.delta = delta
        self.warmup = warmup
        self.auto_register = auto_register
        self.caches = list(caches)
        self.fit_residual_head = residual
        self.min_refit_samples = min_refit_samples
        self.phase = phase
        self.rls = fit.RLSState.from_model(self.model, lam=forgetting,
                                           delta=delta)
        self.residual_head: Optional[fit.ResidualHead] = None
        self.refits = 0
        self.revision = int(self.model.meta.get("revision", 0))
        self.registry_path: Optional[str] = None
        self.events: List[DriftEvent] = []

    # ------------------------------------------------------------------
    def observe(self, pv: Mapping[str, float], seconds: float, *,
                step: Optional[int] = None, tag: str = "",
                phase: str = "train") -> Optional[DriftEvent]:
        """Ingest one live timing sample; returns a drift event if this
        sample tipped the CUSUM (the refit has already happened by then).
        Samples whose ``phase`` does not match a phase-scoped calibrator
        are buffered (tagged) but excluded from the fit and the drift
        watch."""
        seq = self.sink.record(pv, seconds, step=step, tag=tag, phase=phase)
        if seq is None:          # non-positive timing: no fit information
            return None
        if self.phase is not None and phase != self.phase:
            return None          # out-of-scope phase: telemetry only
        pred = self.rls.predict(pv)
        self.rls.observe(pv, seconds)
        if self.sink.n_recorded <= self.warmup or pred <= 0:
            return None
        ev = self.drift.observe(seq, (seconds - pred) / pred, step=step,
                                phase=phase)
        _CUSUM.set(self.drift.evidence)
        if ev is not None:
            self.events.append(ev)
            _DRIFT_EVENTS.inc(1, direction=ev.direction, phase=ev.phase)
            _obs_trace.get_tracer().instant(
                "drift_event", seq=ev.seq, direction=ev.direction,
                phase=ev.phase, magnitude=ev.magnitude)
            self._refit(ev)
        return ev

    # ------------------------------------------------------------------
    def _refit(self, ev: DriftEvent) -> None:
        """Refit from the post-onset window and swap the model atomically.

        The window starts at the CUSUM's change-point estimate, so the
        pre-drift regime does not dilute the new fit.  Warm-starting from
        the outgoing model keeps directions the window never exercises
        anchored instead of collapsing them to zero (the window from a
        single workload is rank-1).  Windows filter to the event's own
        phase: a decode-drift refit must never absorb train rows."""
        pvs, times = self.sink.window(since_seq=ev.onset_seq,
                                      phase=ev.phase)
        if len(times) < self.min_refit_samples:
            pvs, times = self.sink.window(n=self.min_refit_samples,
                                          phase=ev.phase)
        state = fit.RLSState.from_model(self.model, lam=1.0,
                                        delta=self.delta)
        state.observe_many(pvs, times)
        self.refits += 1
        _REFITS.inc()
        meta = dict(self.model.meta)
        meta.update({"refit_epoch": self.refits,
                     "refit_samples": len(times),
                     "refit_onset_seq": ev.onset_seq})
        self.model = state.model(device=self.device, meta=meta)
        if self.fit_residual_head:
            self.residual_head = fit.fit_residual(pvs, times, self.model)
        # restart the tracker from the refit estimate
        self.rls = fit.RLSState.from_model(self.model, lam=self.forgetting,
                                           delta=self.delta)
        if self.auto_register:
            self.registry_path, self.revision = registry.register_revision(
                self.model, self.registry_dir, name=self.device)
        else:
            self.revision += 1
            self.model.meta["revision"] = self.revision
        for c in self.caches:
            c.clear()

    # ------------------------------------------------------------------
    def window_rel_err(self, n: int = 64) -> float:
        """Geomean relative error of the ACTIVE model over the last ``n``
        buffered samples (inf-safe; inf when nothing is buffered)."""
        pvs, times = self.sink.window(n=n)
        if not times:
            return float("inf")
        preds = [self.model.predict(pv) for pv in pvs]
        errs = fit.safe_relative_errors(preds, times)
        finite = errs[np.isfinite(errs)]
        return geomean(finite) if len(finite) else float("inf")

    def report_line(self) -> str:
        """One observability line: sample counts, current windowed error,
        drift status, refit epochs — the trainer/autoshard surface."""
        s = self.sink.stats()
        err = self.window_rel_err()
        err_s = f"{err:.3f}" if np.isfinite(err) else "inf"
        return (f"samples={s['n_recorded']} (buffered={s['n_buffered']}, "
                f"pvs={s['n_unique_pvs']}) window_rel_err={err_s} "
                f"drift={self.drift.status} cusum={self.drift.evidence:.2f} "
                f"refits={self.refits} revision={self.revision}")

    def residual_attribution(self, n: int = 64):
        """Project the last ``n`` samples' measured-vs-predicted error onto
        the model's property basis (``obs.explain.attribute_residual_pv``),
        so a drift report can NAME the miss — "memory terms account for 78%
        of it" — instead of just flagging it.  None when the window is
        empty."""
        from repro_torch.obs.explain import attribute_residual_pv
        pvs, times = self.sink.window(n=n, phase=self.phase)
        if not times:
            return None
        return attribute_residual_pv(self.model, pvs, times)

    def final_report(self) -> str:
        """Multi-line refit report for end-of-run printing."""
        base_err = self.window_rel_err()
        lines = [self.report_line(),
                 f"rls: n={self.rls.n_samples} "
                 f"forgetting={self.forgetting}",
                 f"active model: device={self.model.device} "
                 f"source={self.model.meta.get('source', '?')} "
                 f"refit_epoch={self.model.meta.get('refit_epoch', 0)}"]
        if np.isfinite(base_err):
            lines[-1] += f" window_rel_err={base_err:.3f}"
        if self.residual_head is not None:
            lines.append(f"residual head: "
                         f"n={self.residual_head.meta.get('n_samples')} "
                         f"ridge={self.residual_head.meta.get('ridge')}")
        for ev in self.events:
            lines.append(f"drift event: seq={ev.seq} step={ev.step} "
                         f"onset={ev.onset_seq} phase={ev.phase} "
                         f"direction={ev.direction} "
                         f"magnitude={ev.magnitude:+.3f}")
        att = self.residual_attribution()
        if att is not None and att.n_samples:
            lines.append(f"residual attribution: {att.line()} "
                         f"(n={att.n_samples})")
        return "\n".join(lines)
