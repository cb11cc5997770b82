"""Observability layer of the port: tracing and metrics.

* ``repro_torch.obs.trace`` — nested spans with a *predicted* overlay and
  Chrome-trace/Perfetto export (``--trace-json``);
* ``repro_torch.obs.metrics`` — ``Counter``/``Gauge``/``Histogram``
  registry with Prometheus text exposition and a JSON dump
  (``--metrics-json``);
* ``repro_torch.obs.report`` — the one formatter behind every
  ``[tag] key=value`` status line.

All three are stdlib-only.  The reference's ``obs.explain`` (basis-term
attribution) depends on the cost-model core and arrives with it.
"""
from __future__ import annotations

from repro_torch.obs import metrics, report, trace
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, REGISTRY, get_registry)
from repro_torch.obs.report import emit, format_line
from repro_torch.obs.trace import (NULL_TRACER, Span, Tracer, enable,
                                   get_tracer, set_tracer)

__all__ = [
    "metrics", "report", "trace",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "get_registry", "emit", "format_line",
    "NULL_TRACER", "Span", "Tracer", "enable", "get_tracer", "set_tracer",
]
