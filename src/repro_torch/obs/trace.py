"""Nested-span tracer with a predicted-duration overlay.

The framework both *predicts* durations (fused basis-program GEMV,
``core/exprops.py``) and *measures* them (``time.perf_counter`` loops in
the trainer and decode server).  This tracer is where the two meet: any
span may carry the model's ``predicted_s`` for the work it wraps, and the
Chrome-trace export renders predicted time as a sibling track aligned
under the measured span — load the JSON in Perfetto (or
``chrome://tracing``) and the measured-vs-predicted gap is *visible* per
step, per admission decision, per refit.

Usage::

    tracer = Tracer()
    with tracer.span("decode_step", predicted_s=pred, step=i) as sp:
        ...                       # timed region
        sp.set(tokens=n)          # annotate late
    tracer.save("trace.json")     # Perfetto-loadable

Spans nest via a per-thread stack; completed spans record (name, start,
duration, depth, predicted seconds, free-form args) and an id, their
parent's id and their thread.  A span opened on a thread with no open
span of its own (the autograd engine's device thread, running a
backward) takes as parent the innermost span open on the thread that
opened the outermost open span (the main thread, blocked in
``torch.autograd.grad``).  A **disabled** tracer is a true no-op:
``span()`` returns one shared null context manager, no clock is read,
nothing allocates — the near-zero-overhead path production code keeps on
by default.

**The device trace's clock.**  While a ``torch.profiler`` records the
thread a span opens on, the span also holds a profiler range named
``repro::<span name>``: the profiler then holds the span on its own
clock, beside the operations run and the kernels launched inside it.
The range is an operator-kind range (``_RecordFunctionFast``), not a
``record_function`` user annotation: on the card the profiler gives a
user annotation a device-side event spanning its kernels and the idle
time between them, which a reader of device events would count as
device work.  Without a recording profiler no range is entered.

The module-level tracer (``get_tracer`` / ``set_tracer``) is what library
code consults; it defaults to a disabled instance, and CLI entry points
swap in an enabled one under ``--trace-json``.

Imports nothing from the rest of ``repro_torch``; ``torch`` is imported
on the enabled path only, at the first span.
"""
from __future__ import annotations

import itertools
import json
import os
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional

__all__ = [
    "Span", "Tracer", "NULL_TRACER", "get_tracer", "set_tracer", "enable",
]

#: Chrome-trace thread ids: measured spans nest on MEASURED_TID, each
#: predicted overlay is a sibling "X" event on PREDICTED_TID.
MEASURED_TID = 0
PREDICTED_TID = 1

#: the prefix of a span's profiler range
RANGE_PREFIX = "repro::"

#: torch's "does a profiler record this thread" check, once imported
_recording = None


def _profiler_recording() -> bool:
    global _recording
    if _recording is None:
        import torch
        _recording = torch._C._autograd._profiler_enabled
    return _recording()


def _enter_range(name: str):
    """The entered profiler range ``repro::<name>``."""
    import torch
    rf = torch._C._profiler._RecordFunctionFast(RANGE_PREFIX + name)
    rf.__enter__()
    return rf


class Span:
    """One finished (or in-flight) span."""

    __slots__ = ("name", "t_start_s", "duration_s", "predicted_s", "depth",
                 "args", "id", "parent", "thread")

    def __init__(self, name: str, t_start_s: float, depth: int,
                 predicted_s: Optional[float], args: Dict[str, object],
                 id: int, parent: Optional[int], thread: int):
        self.name = name
        self.t_start_s = t_start_s      # seconds since the tracer's epoch
        self.duration_s: Optional[float] = None
        self.predicted_s = predicted_s
        self.depth = depth
        self.args = args
        self.id = id                    # unique within its tracer, from 1
        self.parent = parent            # the enclosing span's id, or None
        self.thread = thread            # threading.get_ident() of its opener

    @property
    def gap_s(self) -> Optional[float]:
        """measured − predicted seconds (None until both exist)."""
        if self.duration_s is None or self.predicted_s is None:
            return None
        return self.duration_s - self.predicted_s

    def __repr__(self) -> str:
        dur = f"{self.duration_s:.6f}s" if self.duration_s is not None \
            else "open"
        pred = f" pred={self.predicted_s:.6f}s" \
            if self.predicted_s is not None else ""
        return f"Span({self.name!r} @{self.t_start_s:.6f} {dur}{pred})"


class _NullSpan:
    """The shared no-op context manager a disabled tracer hands out."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **kw) -> None:
        pass

    predicted_s = None
    duration_s = None


_NULL_SPAN = _NullSpan()


class _LiveSpan:
    """Context manager recording one span into its tracer (and holding its
    profiler range, if one was entered)."""

    __slots__ = ("_tracer", "span", "_range")

    def __init__(self, tracer: "Tracer", span: Span, rng=None):
        self._tracer = tracer
        self.span = span
        self._range = rng

    def __enter__(self) -> "_LiveSpan":
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer._finish(self.span)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False

    def set(self, predicted_s: Optional[float] = None, **kw) -> None:
        """Annotate the span mid-flight (args merge; ``predicted_s`` may
        arrive late, e.g. once the admission scorer has run)."""
        if predicted_s is not None:
            self.span.predicted_s = float(predicted_s)
        self.span.args.update(kw)

    @property
    def predicted_s(self):
        return self.span.predicted_s

    @property
    def duration_s(self):
        return self.span.duration_s


class Tracer:
    """Monotonic-clock span recorder with Chrome-trace export.

    ``clock`` is injectable (tests pin a fake clock for deterministic
    goldens); it must be monotone non-decreasing.  Span *starts* are
    ordered per thread by construction; the recorded list holds spans in
    COMPLETION order (children before parents), so exports re-sort by
    start time.
    """

    def __init__(self, enabled: bool = True,
                 clock: Callable[[], float] = time.perf_counter,
                 process_name: str = "repro"):
        self.enabled = enabled
        self._clock = clock
        self._epoch = clock()
        self._tls = threading.local()
        self._lock = threading.Lock()
        self.spans: List[Span] = []        # completed spans
        self.instants: List[Span] = []     # zero-duration marker events
        self.process_name = process_name
        self._ids = itertools.count(1)
        # the open-span stack of the thread that opened the outermost open
        # span: where a span opened on a thread with none takes its parent
        self._outer: Optional[list] = None

    # -- recording ---------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _new(self, name: str, st: list, predicted_s: Optional[float],
             args: Dict[str, object]) -> Span:
        """A span opened now on the thread whose stack is ``st``."""
        if st:
            parent = st[-1]
        else:
            outer = self._outer
            # a slice, so that the other thread's pop cannot race the read
            top = outer[-1:] if outer is not None and outer is not st \
                else []
            if not top:
                self._outer = st
            parent = top[0] if top else None
        return Span(name, self._clock() - self._epoch,
                    0 if parent is None else parent.depth + 1, predicted_s,
                    args, next(self._ids),
                    None if parent is None else parent.id,
                    threading.get_ident())

    def span(self, name: str, *, predicted_s: Optional[float] = None,
             **args):
        """Open a nested span; use as a context manager.  On a disabled
        tracer this returns the shared null span — no clock read, no
        allocation, no torch call."""
        if not self.enabled:
            return _NULL_SPAN
        st = self._stack()
        sp = self._new(name, st,
                       None if predicted_s is None else float(predicted_s),
                       dict(args))
        st.append(sp)
        rng = _enter_range(name) if _profiler_recording() else None
        return _LiveSpan(self, sp, rng)

    def _finish(self, sp: Span) -> None:
        st = self._stack()
        # exits are LIFO under the context-manager protocol; tolerate a
        # foreign pop (misuse) by searching from the top
        if st and st[-1] is sp:
            st.pop()
        elif sp in st:
            st.remove(sp)
        sp.duration_s = (self._clock() - self._epoch) - sp.t_start_s
        with self._lock:
            self.spans.append(sp)

    def instant(self, name: str, **args) -> None:
        """Record a zero-duration marker (admission decisions, drift
        events…)."""
        if not self.enabled:
            return
        sp = self._new(name, self._stack(), None, dict(args))
        sp.duration_s = 0.0
        with self._lock:
            self.instants.append(sp)

    # -- summaries ---------------------------------------------------------
    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-name aggregate: count, measured seconds, predicted seconds,
        and the total gap — the text-mode view of the overlay."""
        out: Dict[str, Dict[str, float]] = {}
        with self._lock:
            spans = list(self.spans)
        for sp in spans:
            agg = out.setdefault(sp.name, {
                "count": 0, "measured_s": 0.0, "predicted_s": 0.0,
                "predicted_count": 0, "gap_s": 0.0})
            agg["count"] += 1
            agg["measured_s"] += sp.duration_s or 0.0
            if sp.predicted_s is not None:
                agg["predicted_count"] += 1
                agg["predicted_s"] += sp.predicted_s
                agg["gap_s"] += (sp.duration_s or 0.0) - sp.predicted_s
        return out

    def report_lines(self) -> List[str]:
        """Human-readable measured-vs-predicted rollup, widest gap first."""
        rows = sorted(self.summary().items(),
                      key=lambda kv: -abs(kv[1]["gap_s"]))
        out = []
        for name, a in rows:
            line = (f"{name}: n={int(a['count'])} "
                    f"measured={a['measured_s']*1e3:.2f}ms")
            if a["predicted_count"]:
                ratio = a["measured_s"] / a["predicted_s"] \
                    if a["predicted_s"] > 0 else float("inf")
                line += (f" predicted={a['predicted_s']*1e3:.2f}ms "
                         f"gap={a['gap_s']*1e3:+.2f}ms "
                         f"ratio={ratio:.2f}x")
            out.append(line)
        return out

    # -- Chrome-trace / Perfetto export ------------------------------------
    def to_chrome_trace(self) -> Dict[str, object]:
        """The trace as a Chrome ``traceEvents`` dict (Perfetto-loadable).

        Measured spans are complete events (``ph="X"``) on the
        ``measured`` track, nested by containment; every span carrying
        ``predicted_s`` additionally emits a sibling complete event on the
        ``predicted`` track at the same start timestamp, whose duration is
        the *predicted* seconds — the two tracks line up so the gap is the
        visible overhang.  Instants are ``ph="i"`` marks.  Every event's
        ``args`` carry its span's ``id``, ``parent`` and ``thread``."""
        pid = 0
        ev: List[Dict[str, object]] = [
            {"ph": "M", "pid": pid, "tid": MEASURED_TID,
             "name": "process_name", "args": {"name": self.process_name}},
            {"ph": "M", "pid": pid, "tid": MEASURED_TID,
             "name": "thread_name", "args": {"name": "measured"}},
            {"ph": "M", "pid": pid, "tid": PREDICTED_TID,
             "name": "thread_name", "args": {"name": "predicted"}},
        ]
        with self._lock:
            spans = sorted(self.spans, key=lambda s: (s.t_start_s, -s.depth))
            instants = list(self.instants)
        for sp in spans:
            ts = sp.t_start_s * 1e6
            dur = (sp.duration_s or 0.0) * 1e6
            args = dict(sp.args, id=sp.id, parent=sp.parent,
                        thread=sp.thread)
            if sp.predicted_s is not None:
                args["predicted_s"] = sp.predicted_s
                args["gap_s"] = sp.gap_s
            ev.append({"name": sp.name, "ph": "X", "pid": pid,
                       "tid": MEASURED_TID, "ts": ts, "dur": dur,
                       "args": args})
            if sp.predicted_s is not None:
                ev.append({"name": f"{sp.name} (predicted)", "ph": "X",
                           "pid": pid, "tid": PREDICTED_TID, "ts": ts,
                           "dur": sp.predicted_s * 1e6,
                           "args": {"measured_s": sp.duration_s,
                                    "predicted_s": sp.predicted_s,
                                    "gap_s": sp.gap_s}})
        for sp in instants:
            ev.append({"name": sp.name, "ph": "i", "pid": pid,
                       "tid": MEASURED_TID, "ts": sp.t_start_s * 1e6,
                       "s": "t", "args": dict(sp.args, id=sp.id,
                                              parent=sp.parent,
                                              thread=sp.thread)})
        return {"traceEvents": ev, "displayTimeUnit": "ms",
                "otherData": {"producer": "repro_torch.obs.trace"}}

    def save(self, path: str) -> None:
        """Atomic write of the Chrome-trace JSON."""
        d = os.path.dirname(path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self.to_chrome_trace(), f)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def clear(self) -> None:
        with self._lock:
            self.spans.clear()
            self.instants.clear()


#: the always-disabled tracer library code sees by default
NULL_TRACER = Tracer(enabled=False)

_ACTIVE: Tracer = NULL_TRACER


def get_tracer() -> Tracer:
    """The process-wide tracer (disabled unless an entry point enabled
    one).  Library code writes ``with get_tracer().span(...)`` and pays
    one attribute check when tracing is off."""
    return _ACTIVE


def set_tracer(tracer: Optional[Tracer]) -> Tracer:
    """Install ``tracer`` as the process-wide tracer (None restores the
    disabled default); returns the previous one so callers can restore."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = tracer if tracer is not None else NULL_TRACER
    return prev


def enable(process_name: str = "repro") -> Tracer:
    """Install and return a fresh enabled tracer (the ``--trace-json``
    entry-point hook)."""
    t = Tracer(process_name=process_name)
    set_tracer(t)
    return t
