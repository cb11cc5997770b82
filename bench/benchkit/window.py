"""The measured window, shared by every kind of cell.

``Window.run(one, seconds, profiled)`` calls ``one()`` (one whole step,
which ends in a synchronize and returns its host-clock seconds) until
``seconds`` have passed since the window opened; the step that crosses
the deadline completes and counts.  Set-up ends where the window opens.
In the traced run ``profiled`` steps run under the profiler (from the
third step of the window on), with the entry points that the cell's
readers declare in ranges (``entries``, ``profile.Calls``) and the
program's tracer on for the window (``tracing``); they are left out of the
host-clock step times the per-layer metrics read.  The trace is reduced
twice before it is freed: to the device's busy time, the ranges' device
seconds and the breakdown (``profile.reduce``, on the card), and to the
program's spans (``spans.ranges``).
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import torch

from benchkit import profile, spans

#: the window step at which the traced run starts its profile
PROFILE_AT = 2


@dataclass
class Result:
    steps: int = 0                  # steps in the window
    span_s: float = 0.0             # window start to the last step's end
    timed_s: List[float] = field(default_factory=list)  # unprofiled steps
    setup_s: float = 0.0
    window_peak_bytes: int = 0      # allocator peak inside the window
    memory_peak_bytes: int = 0      # process peak up to the window's close
    profiled: int = 0               # steps under the profiler
    profile: Optional[dict] = None  # profile.reduce (on the card)
    spans: Optional[dict] = None    # spans.ranges
    calls: Dict[str, List[dict]] = field(default_factory=dict)
    host_ms: List[float] = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    metrics: Dict[str, float] = field(default_factory=dict)
    numbers: Dict[str, float] = field(default_factory=dict)


class Window:
    def __init__(self, device, t0: float, trace: bool,
                 entries: Sequence[tuple] = ()):
        """``entries``: the ``(module, function name, describe)`` of each
        entry point the traced run wraps (``entries.union``)."""
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.t0 = t0
        self.trace = trace
        self.calls: List[profile.Calls] = []
        if trace:
            self.calls = [profile.Calls(importlib.import_module(mod), attr,
                                        attr, describe)
                          for mod, attr, describe in entries]

    @contextlib.contextmanager
    def tracing(self):
        """The program's tracer, enabled while the traced run's window runs
        (None in the timed run, which runs no tracer)."""
        if not self.trace:
            yield None
            return
        from repro_torch.obs import trace as obs_trace
        tracer = obs_trace.Tracer()
        prev = obs_trace.set_tracer(tracer)
        try:
            yield tracer
        finally:
            obs_trace.set_tracer(prev)

    def synchronize(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def close(self) -> None:
        for c in self.calls:
            c.restore()
        self.calls = []

    def free(self) -> None:
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def _due(self, res: Result, profiled: int) -> bool:
        return self.trace and profiled > 0 and res.profile is None

    def _profile(self, one: Callable[[], float], profiled: int,
                 res: Result) -> None:
        """Profiles whole steps and reduces the trace at once: the
        profiler's events are many Python objects (~10⁶ for two training
        steps), and every garbage collection of the window's later steps
        would walk them while they live."""
        for c in self.calls:
            c.clear()
        prof = profile.capture(lambda: [one() for _ in range(profiled)],
                               self.cuda)
        res.steps += profiled
        res.profiled = profiled
        res.calls = {c.name: list(c.shapes) for c in self.calls}
        if self.cuda:
            res.profile = profile.reduce(prof, [c.name for c in self.calls])
        res.spans = spans.ranges(prof)
        del prof
        gc.collect()

    def run(self, one: Callable[[], float], seconds: float,
            profiled: int) -> Result:
        res = Result()
        gc.collect()
        self.synchronize()
        if self.cuda:
            setup_peak = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        start = time.perf_counter()
        res.setup_s = start - self.t0
        deadline = start + seconds
        while True:
            if self._due(res, profiled) and res.steps >= PROFILE_AT:
                self._profile(one, profiled, res)
            else:
                res.timed_s.append(one())
                res.steps += 1
            end = time.perf_counter()
            if end >= deadline:
                if self._due(res, profiled):
                    self._profile(one, profiled, res)
                    end = time.perf_counter()
                break
        res.span_s = end - start
        if self.cuda:
            res.window_peak_bytes = torch.cuda.max_memory_allocated(
                self.device)
            res.memory_peak_bytes = max(setup_peak, res.window_peak_bytes)
        return res
