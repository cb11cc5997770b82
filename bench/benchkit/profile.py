"""The traced run's instruments: ranges around the program's kernel entry
points, and the reduction of a ``torch.profiler`` trace to what the
per-layer metrics read.

``Calls`` wraps a module function (an entry point the models look up at
call time, such as ``kernels.ops.flash_attention``) so that every call
runs inside a ``record_function`` range ``bench::<name>`` and leaves its
problem shape.  ``capture`` profiles whole steps inside one range
``bench::window``; ``reduce`` takes from the trace, in that window:

* the device's busy seconds, the union of the intervals in which a kernel,
  a copy or a memset ran;
* each range's device seconds, the device-side span of the range (the
  profiler's GPU annotation of it);
* the device operations that took the most time, and the idle gaps by the
  host operation that was running at their middle.

No kernel name is matched: what runs inside a range is the program's
business.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

WINDOW = "bench::window"
PREFIX = "bench::"
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_OPS = ("cpu_op", "cuda_runtime", "cuda_driver")


class Calls:
    """``module.attr`` wrapped in a ``bench::<name>`` range while the
    object lives (until ``restore``); ``shapes`` holds ``describe(*args,
    **kwargs)`` of each call since the last ``clear``."""

    def __init__(self, module, attr: str, name: str,
                 describe: Callable[..., dict]):
        self.module, self.attr, self.name = module, attr, name
        self.orig = getattr(module, attr)
        self.shapes: List[dict] = []
        label = PREFIX + name
        orig = self.orig

        def wrapped(*args, **kwargs):
            self.shapes.append(describe(*args, **kwargs))
            with torch.profiler.record_function(label):
                return orig(*args, **kwargs)

        setattr(module, attr, wrapped)

    def clear(self) -> None:
        self.shapes = []

    def restore(self) -> None:
        setattr(self.module, self.attr, self.orig)


def capture(run: Callable[[], None], cuda: bool = True):
    """Profiles ``run`` inside the window range, to a synchronize (on the
    card; ``cuda`` false: the host alone, as the CPU tests run it)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            run()
            if cuda:
                torch.cuda.synchronize()
    return prof


def _activity(e) -> str:
    get = getattr(e, "activity_type", None)
    return get() if get is not None else ""


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def reduce(prof, names: List[str], top: int = 10) -> Dict[str, object]:
    """-> {"busy_s", "window_s", "spans": {name: [device s of each call,
    in call order]}, "device_ops": [[name, s]], "idle_gaps": [[name, s]]}
    over the window range."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    window: Optional[Tuple[int, int]] = None
    dev: List[Tuple[int, int, str, int]] = []
    gpu_ranges: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    host: List[Tuple[int, int, str]] = []
    for e in events:
        name, s = e.name(), e.start_ns()
        end = s + e.duration_ns()
        act = _activity(e)
        if e.device_type() == DeviceType.CUDA:
            if name.startswith(PREFIX) or act == "gpu_user_annotation":
                gpu_ranges[name].append((s, end))
            elif not act or act in DEVICE_OPS:
                dev.append((s, end, name))
        elif name == WINDOW:
            window = (s, end)
        elif not name.startswith(PREFIX) and (act in HOST_OPS or not act):
            host.append((s, end, name))
    if window is None:
        raise RuntimeError("the profile holds no window range")
    if not dev:
        raise RuntimeError("the profile holds no device operation: the "
                           "profiler did not trace the card")
    w0, w1 = window
    inside = [(max(s, w0), min(e, w1), n) for s, e, n in dev
              if e > w0 and s < w1]
    busy = _union([(s, e) for s, e, _ in inside])
    by_name: Dict[str, float] = defaultdict(float)
    for s, e, n in inside:
        by_name[n] += (e - s) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if w1 > prev:
        gaps.append((prev, w1))
    host.sort()
    starts = [h[0] for h in host]
    idle: Dict[str, float] = defaultdict(float)
    for s, e in gaps:
        mid = (s + e) // 2
        i = bisect.bisect_right(starts, mid)
        found = "(no host op)"
        for j in range(i - 1, max(-1, i - 4000), -1):
            if host[j][1] >= mid:
                found = host[j][2]
                break
        idle[found] += (e - s) / 1e9
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:top]

    spans = {n: [(e - s) / 1e9 for s, e in sorted(gpu_ranges[PREFIX + n])
                 if s >= w0 and e <= w1] for n in names}
    return {"busy_s": sum(e - s for s, e in busy) / 1e9,
            "window_s": (w1 - w0) / 1e9, "spans": spans,
            "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps_top]}
