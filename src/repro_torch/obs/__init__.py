"""Observability layer of the port: tracing, attribution, metrics.

* ``repro_torch.obs.trace`` — nested spans with a *predicted* overlay and
  Chrome-trace/Perfetto export (``--trace-json``);
* ``repro_torch.obs.explain`` — basis-term attribution: ``score_explain``
  opens the fused GEMV into per-term/per-category addends, and
  ``attribute_residual`` projects measured-vs-predicted error back onto
  the basis;
* ``repro_torch.obs.metrics`` — ``Counter``/``Gauge``/``Histogram``
  registry with Prometheus text exposition and a JSON dump
  (``--metrics-json``);
* ``repro_torch.obs.report`` — the one formatter behind every
  ``[tag] key=value`` status line.

``trace``/``metrics``/``report`` are stdlib-only and import nothing from
the rest of the port (core modules import them freely); ``explain`` imports
``repro_torch.core`` and is therefore exposed *lazily* here, so that core
modules importing ``repro_torch.obs.metrics`` never trigger a cycle.
"""
from __future__ import annotations

from repro_torch.obs import metrics, report, trace
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, REGISTRY, get_registry)
from repro_torch.obs.report import emit, format_line
from repro_torch.obs.trace import (NULL_TRACER, Span, Tracer, enable,
                                   get_tracer, set_tracer)

__all__ = [
    "metrics", "report", "trace", "explain",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "get_registry", "emit", "format_line",
    "NULL_TRACER", "Span", "Tracer", "enable", "get_tracer", "set_tracer",
    "score_explain", "attribute_residual", "attribute_residual_pv",
    "Explanation", "TermContribution", "ResidualAttribution",
]

_EXPLAIN_NAMES = {
    "explain", "score_explain", "attribute_residual",
    "attribute_residual_pv", "Explanation", "TermContribution",
    "ResidualAttribution", "explain_program",
}


def __getattr__(name: str):
    if name in _EXPLAIN_NAMES:
        import importlib
        _explain = importlib.import_module("repro_torch.obs.explain")
        if name == "explain":
            return _explain
        return getattr(_explain, name)
    raise AttributeError(f"module 'repro_torch.obs' has no attribute "
                         f"{name!r}")
