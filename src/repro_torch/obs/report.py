"""Structured report lines — ONE formatter for the ``[tag] key=value``
surface.

The trainer's ``[calib]`` lines, the decode server's ``[admit]`` lines,
and the autoshard CLI's compile-cache line each grew their own formatting
(and their own test greps).  This module is the single source for that
surface: every human-readable status line flows through ``emit``, which

  * formats the canonical ``[tag] key=value key=value …`` layout
    (``format_line``), so every line is machine-greppable the same way;
  * counts the emission in the metrics registry
    (``repro_report_lines_total{tag=…}``), so a run's report volume is
    itself observable;
  * prints through an injectable printer (tests pass a capture list, the
    disabled path passes ``printer=None`` to format-and-count only).

Zero dependencies; imports only the sibling ``metrics`` module.
"""
from __future__ import annotations

from typing import Callable, Mapping, Optional

from repro_torch.obs import metrics

__all__ = ["format_fields", "format_line", "emit"]

_LINES = metrics.REGISTRY.counter(
    "repro_report_lines_total",
    "structured [tag] report lines emitted, by tag")


def _fmt_value(v: object) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def format_fields(fields: Mapping[str, object]) -> str:
    """``key=value`` pairs, insertion-ordered, space-separated."""
    return " ".join(f"{k}={_fmt_value(v)}" for k, v in fields.items())


def format_line(tag: str, fields: Optional[Mapping[str, object]] = None,
                text: str = "") -> str:
    """The canonical line: ``[tag] key=value … free text``."""
    parts = [f"[{tag}]"]
    if fields:
        parts.append(format_fields(fields))
    if text:
        parts.append(text)
    return " ".join(parts)


def emit(tag: str, fields: Optional[Mapping[str, object]] = None,
         text: str = "",
         printer: Optional[Callable[[str], None]] = print) -> str:
    """Format, count, and (optionally) print one report line; returns it."""
    line = format_line(tag, fields, text)
    _LINES.inc(1, tag=tag)
    if printer is not None:
        printer(line)
    return line
