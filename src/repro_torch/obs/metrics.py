"""Metrics registry — one home for the framework's scattered counters.

Before this module, operational counters lived wherever they were
incremented: ``BasisCache.hits`` on the cache object, the disk
compile-cache tallies in a module dict, telemetry ring occupancy inside
the sink, the CUSUM statistic inside the drift monitor, admission
decisions as ad-hoc print lines.  ``MetricsRegistry`` unifies them behind
the standard ``Counter`` / ``Gauge`` / ``Histogram`` trio with Prometheus
text exposition (``render()``) and a JSON dump (``--metrics-json`` /
``save_json``), so a trainer, server, or autoshard run can export ONE
machine-readable snapshot of everything the process counted.

Zero dependencies (stdlib only) and zero imports from the rest of
``repro_torch`` — any module may import this one at module level without
cycles.  Producers push into the process-wide default ``REGISTRY``;
multi-registry use (tests, isolated benchmarks) constructs private
``MetricsRegistry`` instances.

Design points:

  * metrics are *families*: ``counter("x").inc()`` is the unlabeled fast
    path, ``counter("x").inc(1, phase="decode")`` creates one child per
    label set — Prometheus semantics without a client-library dep;
  * ``get-or-create`` registration: calling ``registry.counter(name)``
    twice returns the same object (so producer modules need no import
    ordering), but re-registering a name as a different *type* raises;
  * rendering is pull-based and cheap; nothing in the registry runs
    timers or threads.  Hot paths pay one float add per event.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
from collections import OrderedDict
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "get_registry",
]

LabelSet = Tuple[Tuple[str, str], ...]
_NO_LABELS: LabelSet = ()


def _labelset(labels: Mapping[str, object]) -> LabelSet:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt(v: float) -> str:
    """Prometheus-style number: integers without a trailing ``.0``."""
    if v != v:                       # NaN
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Metric:
    """Shared family machinery: one value slot per label set."""

    kind = "untyped"
    __slots__ = ("name", "help", "_children", "_lock")

    def __init__(self, name: str, help: str = ""):
        if not name or not all(c.isalnum() or c in "_:" for c in name):
            raise ValueError(f"invalid metric name: {name!r}")
        self.name = name
        self.help = help
        self._children: "OrderedDict[LabelSet, float]" = OrderedDict()
        self._lock = threading.Lock()

    def _bump(self, ls: LabelSet, amount: float, absolute: bool) -> None:
        with self._lock:
            if absolute:
                self._children[ls] = float(amount)
            else:
                self._children[ls] = self._children.get(ls, 0.0) \
                    + float(amount)

    def value(self, **labels) -> float:
        return self._children.get(_labelset(labels), 0.0)

    def items(self) -> List[Tuple[LabelSet, float]]:
        return list(self._children.items())

    def _zero(self) -> None:
        with self._lock:
            self._children.clear()

    # -- exposition --------------------------------------------------------
    def _sample_lines(self) -> List[str]:
        out = []
        for ls, v in self._children.items():
            lbl = "{" + ",".join(f'{k}="{val}"' for k, val in ls) + "}" \
                if ls else ""
            out.append(f"{self.name}{lbl} {_fmt(v)}")
        if not out:                 # registered but never touched: expose 0
            out.append(f"{self.name} 0")
        return out

    def render(self) -> str:
        head = []
        if self.help:
            head.append(f"# HELP {self.name} {self.help}")
        head.append(f"# TYPE {self.name} {self.kind}")
        return "\n".join(head + self._sample_lines())

    def to_json_dict(self) -> Dict[str, object]:
        return {
            "name": self.name, "type": self.kind, "help": self.help,
            "samples": [{"labels": dict(ls), "value": v}
                        for ls, v in self._children.items()],
        }


class Counter(_Metric):
    """Monotone event count.  ``inc`` only; negative increments raise."""

    kind = "counter"
    __slots__ = ()

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"({amount})")
        self._bump(_labelset(labels), amount, absolute=False)


class Gauge(_Metric):
    """A value that goes up and down (occupancy, CUSUM height, RSS…)."""

    kind = "gauge"
    __slots__ = ()

    def set(self, value: float, **labels) -> None:
        self._bump(_labelset(labels), value, absolute=True)

    def inc(self, amount: float = 1.0, **labels) -> None:
        self._bump(_labelset(labels), amount, absolute=False)

    def dec(self, amount: float = 1.0, **labels) -> None:
        self._bump(_labelset(labels), -amount, absolute=False)


#: powers-of-ten ladder spanning µs-scale GEMV scores to multi-second steps
DEFAULT_BUCKETS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0, 60.0)


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus layout: ``_bucket{le=}``,
    ``_sum``, ``_count``).  Buckets are fixed at construction."""

    kind = "histogram"
    __slots__ = ("buckets",)

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help)
        bs = sorted(float(b) for b in buckets)
        if not bs or any(b != b for b in bs):
            raise ValueError(f"bad histogram buckets: {buckets!r}")
        self.buckets = tuple(bs)

    def observe(self, value: float, **labels) -> None:
        ls = _labelset(labels)
        v = float(value)
        with self._lock:
            st = self._children.get(ls)
            if st is None:
                st = self._children[ls] = \
                    [0.0] * (len(self.buckets) + 2)  # buckets + count + sum
            for i, b in enumerate(self.buckets):
                if v <= b:
                    st[i] += 1
            st[-2] += 1
            st[-1] += v

    def value(self, **labels) -> float:
        """The observation COUNT for the label set (family contract)."""
        st = self._children.get(_labelset(labels))
        return st[-2] if st else 0.0

    def sum(self, **labels) -> float:
        st = self._children.get(_labelset(labels))
        return st[-1] if st else 0.0

    def _sample_lines(self) -> List[str]:
        out = []
        children = self._children.items() or [(_NO_LABELS,
                                               [0.0] * (len(self.buckets)
                                                        + 2))]
        for ls, st in children:
            base = ",".join(f'{k}="{v}"' for k, v in ls)
            for i, b in enumerate(self.buckets):
                lbl = f'{{{base}{"," if base else ""}le="{_fmt(b)}"}}'
                out.append(f"{self.name}_bucket{lbl} {_fmt(st[i])}")
            lbl = f'{{{base}{"," if base else ""}le="+Inf"}}'
            out.append(f"{self.name}_bucket{lbl} {_fmt(st[-2])}")
            tail = f"{{{base}}}" if base else ""
            out.append(f"{self.name}_sum{tail} {_fmt(st[-1])}")
            out.append(f"{self.name}_count{tail} {_fmt(st[-2])}")
        return out

    def to_json_dict(self) -> Dict[str, object]:
        return {
            "name": self.name, "type": self.kind, "help": self.help,
            "buckets": list(self.buckets),
            "samples": [{"labels": dict(ls),
                         "bucket_counts": st[:-2],
                         "count": st[-2], "sum": st[-1]}
                        for ls, st in self._children.items()],
        }


class MetricsRegistry:
    """Ordered collection of metric families with get-or-create access."""

    def __init__(self):
        self._metrics: "OrderedDict[str, _Metric]" = OrderedDict()
        self._lock = threading.Lock()

    # -- registration ------------------------------------------------------
    def _get_or_create(self, cls, name: str, help: str, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls:
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}")
                return m
            m = cls(name, help, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __len__(self) -> int:
        return len(self._metrics)

    # -- exposition --------------------------------------------------------
    def render(self) -> str:
        """Prometheus text exposition of every registered family."""
        return "\n".join(m.render() for m in self._metrics.values()) \
            + ("\n" if self._metrics else "")

    def to_json_dict(self) -> Dict[str, object]:
        return {"kind": "metrics", "schema": 1,
                "metrics": [m.to_json_dict()
                            for m in self._metrics.values()]}

    def save_json(self, path: str) -> None:
        """Atomic JSON dump (temp file + ``os.replace``), mirroring the
        telemetry sink's crash-safe save."""
        d = os.path.dirname(path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self.to_json_dict(), f, indent=1)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # -- lifecycle ---------------------------------------------------------
    def reset(self) -> None:
        """Zero every family's samples, keeping registrations (tests)."""
        for m in self._metrics.values():
            m._zero()


#: the process-wide default registry every producer pushes into
REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY
