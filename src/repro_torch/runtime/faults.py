"""Deterministic fault injection — the chaos half of the fault-tolerant
runtime.

A ``FaultPlan`` is a seeded, serializable schedule of faults (device loss
at step N, per-host slowdown windows, one-off timing spikes, poisoned
telemetry samples, corrupted registry/checkpoint/compile-cache files);
a ``FaultInjector`` replays that schedule against the live run through
four hook families:

  * **step hooks** — ``step_begin(step)`` raises ``DeviceLossError`` and
    lands file corruption *before* the step runs (trainer loop,
    ``runtime/trainer.py``); ``decode_begin(it)`` is the serving twin
    (``runtime/server.py``, iteration-indexed);
  * **timing hooks** — ``perturb_step_time`` / ``perturb_decode_time``
    multiply the *observed* wall time by slowdown/spike factors, so a
    "3× straggler for 10 steps" is injected deterministically without
    sleeping;
  * **telemetry hooks** — ``perturb_telemetry`` replaces the sample fed
    to the online calibrator with a non-finite/non-positive value at the
    scheduled step (the sink must quarantine it, not crash);
  * **file hooks** — ``corrupt_file`` truncates or garbage-stamps the
    registry model file, the newest checkpoint, or disk compile-cache
    entries (the hardened readers must fall back, quarantining the bad
    artifact).

Determinism contract: every fault is a pure function of (plan, seed,
step index).  Timing/telemetry perturbations are idempotent by step —
a post-recovery replay of step N sees the same perturbation — while
device-loss and file-corruption faults are one-shot (they model events,
not conditions).  With an EMPTY plan every hook is an identity
passthrough: a run under an armed-but-empty injector is bit-identical
to an uninstrumented run (pinned in ``tests/test_torch_faults.py``).

Nothing here imports the trainer or server; the hooks are called by
them, guarded by ``if injector is not None`` so the hot path pays
nothing when chaos is off.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, replace
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import report as _obs_report
from repro_torch.obs import trace as _obs_trace

__all__ = [
    "FAULT_KINDS", "Fault", "FaultPlan", "FaultInjector",
    "DeviceLossError", "corrupt_file", "corrupt_checkpoint",
]

_INJECTED = _obs_metrics.REGISTRY.counter(
    "repro_faults_injected_total",
    "faults the injector landed on the run, by kind (slowdown windows "
    "count once per affected step)")

#: every kind the plan grammar accepts
FAULT_KINDS = (
    "device_loss",            # raise DeviceLossError(count) at step N
    "slowdown",               # observed time ×factor for [step, step+duration)
    "timing_spike",           # observed time ×factor at exactly step N
    "telemetry_nan",          # calibrator sample replaced by `value` at step N
    "corrupt_registry",       # registry model file truncated/garbaged
    "corrupt_checkpoint",     # newest checkpoint manifest/leaf corrupted
    "corrupt_compile_cache",  # every disk compile-cache entry corrupted
    "pool_shrink",            # fleet: pool=NAME loses count devices at step N
    "pool_grow",              # fleet: pool=NAME gains count devices at step N
)

_FILE_KINDS = ("corrupt_registry", "corrupt_checkpoint",
               "corrupt_compile_cache")
_TIMING_KINDS = ("slowdown", "timing_spike")
#: fleet-scoped churn kinds: consumed by ``FleetSupervisor.fleet_events``,
#: never by the per-trainer ``step_begin`` hook.  A ``device_loss`` with
#: ``pool=`` set is fleet-scoped too — it names WHICH pool lost the
#: devices, which only the fleet layer can act on.
_POOL_KINDS = ("pool_shrink", "pool_grow")


class DeviceLossError(RuntimeError):
    """An injected (or real) loss of ``count`` devices at ``step``.

    Raised out of the trainer step loop; the ``Supervisor`` catches it
    and runs the replan → checkpoint-restore → resume failover.
    """

    def __init__(self, count: int = 1, step: Optional[int] = None):
        self.count = int(count)
        self.step = step
        super().__init__(f"lost {self.count} device(s) at step {step}")


@dataclass(frozen=True, eq=False)
class Fault:
    """One scheduled fault.  Unused fields keep their defaults (e.g. a
    ``device_loss`` ignores ``factor``); see ``FAULT_KINDS`` for the
    per-kind meaning of ``step``/``count``/``factor``/``duration``/
    ``value``/``mode``/``target``."""

    kind: str
    step: int
    count: int = 1                    # device_loss / pool_*: devices moved
    factor: float = 4.0               # slowdown / timing_spike multiplier
    duration: int = 1                 # slowdown window length, in steps
    value: float = float("nan")       # telemetry_nan poison value
    mode: str = "truncate"            # file corruption: truncate | garbage
    target: Optional[str] = None      # file corruption: explicit path
    pool: Optional[str] = None        # fleet faults: the device pool hit

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if self.step < 0:
            raise ValueError(f"fault step must be >= 0: {self.step}")
        if self.mode not in ("truncate", "garbage"):
            raise ValueError(f"fault mode must be truncate|garbage: "
                             f"{self.mode!r}")
        if self.pool is not None and self.kind not in _POOL_KINDS \
                and self.kind != "device_loss":
            raise ValueError(f"pool= only applies to {_POOL_KINDS} "
                             f"and device_loss, not {self.kind!r}")

    @property
    def fleet_scoped(self) -> bool:
        """True for pool-churn faults the ``FleetSupervisor`` consumes
        (``pool_shrink``/``pool_grow``, and ``device_loss`` carrying a
        ``pool=`` attribution)."""
        return self.kind in _POOL_KINDS or \
            (self.kind == "device_loss" and self.pool is not None)

    def _key(self):
        # repr() makes nan compare equal to nan — a plan carrying a NaN
        # poison value must still be a value object (tests pin that equal
        # seeds build EQUAL plans)
        return (self.kind, self.step, self.count, repr(self.factor),
                self.duration, repr(self.value), self.mode, self.target,
                self.pool)

    def __eq__(self, other):
        return isinstance(other, Fault) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    # -- serialization -----------------------------------------------------
    def to_json_dict(self) -> Dict[str, object]:
        d: Dict[str, object] = {"kind": self.kind, "step": self.step}
        defaults = Fault(kind=self.kind, step=self.step)
        for f in ("count", "factor", "duration", "value", "mode", "target",
                  "pool"):
            v = getattr(self, f)
            dv = getattr(defaults, f)
            if v != dv and not (isinstance(v, float) and isinstance(dv, float)
                                and np.isnan(v) and np.isnan(dv)):
                d[f] = v
        return d

    @classmethod
    def from_json_dict(cls, d: Mapping[str, object]) -> "Fault":
        kw = {k: d[k] for k in ("count", "factor", "duration", "value",
                                "mode", "target", "pool") if k in d}
        return cls(kind=str(d["kind"]), step=int(d["step"]), **kw)


def _parse_scalar(s: str):
    for conv in (int, float):
        try:
            return conv(s)
        except ValueError:
            pass
    return s


@dataclass(frozen=True)
class FaultPlan:
    """An ordered, seeded fault schedule.

    Plans are value objects: equal plans inject identical fault streams
    (``tests/test_torch_faults.py`` pins bit-for-bit reproducibility of
    ``FaultPlan.random`` and the JSON round trip).  ``seed`` feeds the
    injector's rng (garbage bytes for file corruption) so even the
    corruption payloads are reproducible.
    """

    faults: Tuple[Fault, ...] = ()
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(
            self, "faults",
            tuple(sorted(self.faults,
                         key=lambda f: (f.step, FAULT_KINDS.index(f.kind)))))

    def __bool__(self) -> bool:
        return bool(self.faults)

    def describe(self) -> str:
        if not self.faults:
            return "<empty plan>"
        return "; ".join(f"{f.kind}@{f.step}" for f in self.faults)

    # -- construction ------------------------------------------------------
    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "FaultPlan":
        """Parse the CLI mini-grammar ``kind@step[:k=v,k=v];kind@step…``
        (e.g. ``"corrupt_registry@7;device_loss@12:count=2"``), or load a
        JSON plan when ``spec`` is a path to an existing file."""
        spec = spec.strip()
        if os.path.exists(spec):
            return cls.load(spec)
        faults: List[Fault] = []
        for part in filter(None, (p.strip() for p in spec.split(";"))):
            head, _, kvs = part.partition(":")
            kind, _, step = head.partition("@")
            if not step:
                raise ValueError(f"fault spec {part!r} needs kind@step")
            kw: Dict[str, object] = {}
            for kv in filter(None, (x.strip() for x in kvs.split(","))):
                k, _, v = kv.partition("=")
                k = k.strip()
                if k == "k":          # fleet shorthand: pool_shrink@5:k=2
                    k = "count"
                kw[k] = _parse_scalar(v.strip())
            faults.append(Fault(kind=kind.strip(), step=int(step), **kw))
        return cls(faults=tuple(faults), seed=seed)

    @classmethod
    def random(cls, seed: int, n_steps: int, n_faults: int = 4,
               kinds: Sequence[str] = _TIMING_KINDS + ("telemetry_nan",)
               ) -> "FaultPlan":
        """A deterministic random schedule: same (seed, n_steps, n_faults,
        kinds) → bit-identical plan.  Defaults to the non-destructive
        kinds; pass ``kinds`` explicitly to include device loss or file
        corruption."""
        rng = np.random.default_rng(seed)
        faults = []
        for _ in range(n_faults):
            kind = kinds[int(rng.integers(len(kinds)))]
            step = int(rng.integers(n_steps))
            f = Fault(kind=kind, step=step)
            if kind == "slowdown":
                f = replace(f, factor=float(np.round(
                    rng.uniform(2.0, 8.0), 6)),
                    duration=int(rng.integers(1, 8)))
            elif kind == "timing_spike":
                f = replace(f, factor=float(np.round(
                    rng.uniform(4.0, 32.0), 6)))
            elif kind == "telemetry_nan":
                f = replace(f, value=float(
                    rng.choice([float("nan"), float("inf"), -1.0, 0.0])))
            faults.append(f)
        return cls(faults=tuple(faults), seed=seed)

    # -- serialization -----------------------------------------------------
    def to_json_dict(self) -> Dict[str, object]:
        return {"kind": "fault_plan", "schema": 1, "seed": self.seed,
                "faults": [f.to_json_dict() for f in self.faults]}

    @classmethod
    def from_json_dict(cls, d: Mapping[str, object]) -> "FaultPlan":
        if d.get("kind") != "fault_plan":
            raise ValueError(f"not a fault_plan record: {d.get('kind')!r}")
        return cls(faults=tuple(Fault.from_json_dict(f)
                                for f in d["faults"]),
                   seed=int(d.get("seed", 0)))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json_dict(), f, indent=1)

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            return cls.from_json_dict(json.load(f))


# ---------------------------------------------------------------------------
# File corruption primitives (also used directly by tests)
# ---------------------------------------------------------------------------


def corrupt_file(path: str, rng: Optional[np.random.Generator] = None,
                 mode: str = "truncate") -> bool:
    """Corrupt one file in place: ``truncate`` chops it to half length
    (an interrupted write), ``garbage`` overwrites the head with random
    bytes (bit rot).  Returns False when the file doesn't exist."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return False
    if mode == "truncate":
        with open(path, "r+b") as f:
            f.truncate(size // 2)
    else:
        rng = rng or np.random.default_rng(0)
        junk = rng.integers(0, 256, size=min(max(size, 1), 64),
                            dtype=np.uint8).tobytes()
        with open(path, "r+b") as f:
            f.seek(0)
            f.write(junk)
    return True


def corrupt_checkpoint(ckpt_dir: str,
                       rng: Optional[np.random.Generator] = None,
                       mode: str = "truncate") -> Optional[str]:
    """Corrupt the NEWEST checkpoint under ``ckpt_dir``: ``truncate``
    chops the manifest (unreadable metadata), ``garbage`` stomps the
    first leaf (crc mismatch).  Returns the corrupted file path, or None
    when no checkpoint exists."""
    from repro_torch.checkpoint import store
    step = store.latest_step(ckpt_dir)
    if step is None:
        return None
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    target = os.path.join(d, "manifest.json" if mode == "truncate"
                          else "leaf_00000.npy")
    return target if corrupt_file(target, rng, mode) else None


# ---------------------------------------------------------------------------
# The injector
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InjectedFault:
    """Audit record of one landed fault."""
    step: int
    kind: str
    detail: str = ""


class FaultInjector:
    """Replays a ``FaultPlan`` against a live run.

    Construction wires the file-layer targets (checkpoint dir, registry
    dir + device name, compile-cache dir); the runtime hooks are then
    pure functions of the plan and the step index.  All hooks are
    no-ops under an empty plan.
    """

    def __init__(self, plan: FaultPlan, *,
                 ckpt_dir: Optional[str] = None,
                 registry_dir: Optional[str] = None,
                 registry_device: Optional[str] = None,
                 compile_cache_dir: Optional[str] = None,
                 seed: Optional[int] = None):
        self.plan = plan
        self.ckpt_dir = ckpt_dir
        self.registry_dir = registry_dir
        self.registry_device = registry_device
        self.compile_cache_dir = compile_cache_dir
        self.rng = np.random.default_rng(plan.seed if seed is None else seed)
        self.injected: List[InjectedFault] = []
        self._fired: set = set()          # one-shot fault indices
        self._seen_timing: set = set()    # (fault idx, step) audit dedupe
        # hot-path pre-splits: the trainer consults these every step
        self._timing = [(i, f) for i, f in enumerate(plan.faults)
                        if f.kind in _TIMING_KINDS]
        self._telemetry = [(i, f) for i, f in enumerate(plan.faults)
                           if f.kind == "telemetry_nan"]
        self._oneshot: Dict[int, List[Tuple[int, Fault]]] = {}
        self._fleet: Dict[int, List[Tuple[int, Fault]]] = {}
        for i, f in enumerate(plan.faults):
            if f.fleet_scoped:
                # pool churn is the fleet supervisor's to consume; the
                # per-trainer step hook must never raise it
                self._fleet.setdefault(f.step, []).append((i, f))
            elif f.kind in _FILE_KINDS or f.kind == "device_loss":
                self._oneshot.setdefault(f.step, []).append((i, f))

    def armed(self) -> bool:
        return bool(self.plan.faults)

    def counts(self) -> Dict[str, int]:
        """Injected-fault tally by kind (for the supervisor's rollup)."""
        out: Dict[str, int] = {}
        for rec in self.injected:
            out[rec.kind] = out.get(rec.kind, 0) + 1
        return out

    # -- bookkeeping -------------------------------------------------------
    def _record(self, step: int, fault: Fault, detail: str = "") -> None:
        self.injected.append(InjectedFault(step, fault.kind, detail))
        _INJECTED.inc(1, kind=fault.kind)
        _obs_trace.get_tracer().instant("fault_injected", step=step,
                                        kind=fault.kind, detail=detail)
        _obs_report.emit("faults", {"step": step, "kind": fault.kind,
                                    **({"detail": detail} if detail else {})})

    # -- step hooks --------------------------------------------------------
    def step_begin(self, step: int) -> None:
        """Trainer-side hook, called before the step executes.  Lands any
        file corruption scheduled for this step, then raises device loss
        (corruption first, so a same-step failover reads the corrupted
        state — the harder scenario)."""
        due = self._oneshot.get(step)
        if not due:
            return
        loss: Optional[Fault] = None
        for i, f in due:
            if i in self._fired:
                continue
            if f.kind == "device_loss":
                loss = f
                continue
            self._fired.add(i)
            self._corrupt(step, f)
        if loss is not None:
            i = next(i for i, f in due if f is loss)
            self._fired.add(i)
            self._record(step, loss, detail=f"count={loss.count}")
            raise DeviceLossError(loss.count, step)

    def decode_begin(self, it: int) -> None:
        """Serving-side twin of ``step_begin`` (iteration-indexed)."""
        self.step_begin(it)

    def fleet_events(self, step: int) -> List[Fault]:
        """Fleet-scoped pool-churn faults due at ``step`` (``pool_shrink``,
        ``pool_grow``, pool-attributed ``device_loss``), fired one-shot and
        returned in plan order for the ``FleetSupervisor`` to apply.  An
        empty plan (or a step with no churn) returns ``[]`` without any
        bookkeeping — the supervised fleet loop pays one dict probe."""
        due = self._fleet.get(step)
        if not due:
            return []
        out: List[Fault] = []
        for i, f in due:
            if i in self._fired:
                continue
            self._fired.add(i)
            detail = f"pool={f.pool or '<first>'},k={f.count}"
            self._record(step, f, detail=detail)
            out.append(f)
        return out

    def _corrupt(self, step: int, f: Fault) -> None:
        detail = ""
        if f.target is not None:
            ok = corrupt_file(f.target, self.rng, f.mode)
            detail = f.target if ok else "<missing>"
        elif f.kind == "corrupt_registry":
            from repro_torch.calibration import registry as _registry
            if self.registry_device is None:
                detail = "<no registry device wired>"
            else:
                path = _registry._model_path(
                    self.registry_dir or _registry.default_registry_dir(),
                    self.registry_device)
                ok = corrupt_file(path, self.rng, f.mode)
                detail = path if ok else "<missing>"
        elif f.kind == "corrupt_checkpoint":
            if self.ckpt_dir is None:
                detail = "<no ckpt dir wired>"
            else:
                detail = corrupt_checkpoint(self.ckpt_dir, self.rng,
                                            f.mode) or "<missing>"
        elif f.kind == "corrupt_compile_cache":
            from repro_torch.core import exprops as _exprops
            cdir = self.compile_cache_dir or _exprops.compile_cache_dir()
            n = 0
            if cdir and os.path.isdir(cdir):
                for fn in sorted(os.listdir(cdir)):
                    if fn.endswith(".json"):
                        n += corrupt_file(os.path.join(cdir, fn),
                                          self.rng, f.mode)
            detail = f"entries={n}"
        self._record(step, f, detail=detail)

    # -- timing hooks ------------------------------------------------------
    def perturb_step_time(self, step: int, dt: float) -> float:
        """Observed step seconds after scheduled slowdowns/spikes.  A pure
        function of (plan, step): replayed steps see identical values."""
        if not self._timing:
            return dt
        out = dt
        for i, f in self._timing:
            hit = (step == f.step if f.kind == "timing_spike"
                   else f.step <= step < f.step + max(f.duration, 1))
            if hit:
                out = out * f.factor
                if (i, step) not in self._seen_timing:
                    self._seen_timing.add((i, step))
                    self._record(step, f, detail=f"factor={f.factor}")
        return out

    def perturb_decode_time(self, it: int, dt: float) -> float:
        """Serving twin of ``perturb_step_time`` (iteration-indexed)."""
        return self.perturb_step_time(it, dt)

    # -- telemetry hooks ---------------------------------------------------
    def perturb_telemetry(self, step: int, seconds: float) -> float:
        """The sample handed to the online calibrator at ``step`` — the
        scheduled poison value when a ``telemetry_nan`` fault matches,
        the measurement untouched otherwise."""
        if not self._telemetry:
            return seconds
        out = seconds
        for i, f in self._telemetry:
            if step == f.step:
                out = f.value
                if (i, step) not in self._seen_timing:
                    self._seen_timing.add((i, step))
                    self._record(step, f, detail=f"value={f.value}")
        return out
