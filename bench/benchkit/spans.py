"""The program's own spans in a traced run.

While the profiler records, every span of the program's tracer
(``repro_torch.obs.trace``) is also a profiler range named
``repro::<span>`` (an operator-kind event on the host, with no device-side
mirror).  ``ranges(prof)`` takes from a captured profile, in the window
range, before the profile is freed:

* the device's busy union, as ``profile.reduce`` takes it;
* every ``repro::`` range on the host: (start ns, end ns, span name,
  thread);
* the device seconds of the kernels, copies and memsets launched inside
  each span's ranges, on the range's own thread (a launch is matched to
  its device operation by the profiler's correlation id).

``idle_by_span``, ``idle_inside`` and ``device_s`` read that reduction;
``per_step`` groups the tracer's own spans (its clock) under the step
span each belongs to, by their parent ids.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from benchkit import profile

PREFIX = "repro::"
#: the idle time no ``repro::`` range covers
OUTSIDE = "(no span)"
#: the host side of a launch: a CUDA API call (``cudaLaunchKernel``,
#: ``cuLaunchKernel``, ``cudaMemcpyAsync``, ...)
LAUNCH = "cu"


def ranges(prof) -> dict:
    """-> {"window": (start, end), "busy": [(start, end)], "host":
    [(start, end, name, thread)], "device": {name: seconds}}, names without
    the prefix, intervals in ns and cut to the window."""
    from torch.autograd import DeviceType
    window: Optional[Tuple[int, int]] = None
    dev: List[Tuple[int, int, int]] = []
    host: List[Tuple[int, int, str, int]] = []
    launches: Dict[int, Tuple[int, int]] = {}
    for e in prof.profiler.kineto_results.events():
        name, s = e.name(), e.start_ns()
        end = s + e.duration_ns()
        act = profile._activity(e)
        if e.device_type() == DeviceType.CUDA:
            if name.startswith(profile.PREFIX) or name.startswith(PREFIX) \
                    or act == "gpu_user_annotation":
                continue
            if not act or act in profile.DEVICE_OPS:
                dev.append((s, end, e.correlation_id()))
        elif name == profile.WINDOW:
            window = (s, end)
        elif name.startswith(PREFIX):
            host.append((s, end, name[len(PREFIX):], e.start_thread_id()))
        elif name.startswith(LAUNCH):
            launches[e.correlation_id()] = (s, e.start_thread_id())
    if window is None:
        raise RuntimeError("the profile holds no window range")
    w0, w1 = window

    def cut(xs):
        return [(max(x[0], w0), min(x[1], w1)) + tuple(x[2:]) for x in xs
                if x[1] > w0 and x[0] < w1]

    dev, host = cut(dev), sorted(cut(host))
    covers = {tid: _covers([h for h in host if h[3] == tid])
              for tid in {h[3] for h in host}}
    device: Dict[str, float] = defaultdict(float)
    for s, e, corr in dev:
        at = launches.get(corr)
        if at is None or at[1] not in covers:
            continue
        starts, names = covers[at[1]]
        i = bisect.bisect_right(starts, at[0]) - 1
        for n in names[i] if i >= 0 else ():
            device[n] += (e - s) / 1e9
    return {"window": window, "busy": profile._union([d[:2] for d in dev]),
            "host": host, "device": dict(device)}


def _covers(host: Sequence[Tuple]) -> Tuple[List[int], List[frozenset]]:
    """(piece starts, names of the ranges open through each piece) of one
    thread's ranges; a piece past every range holds no name."""
    points = sorted({p for h in host for p in h[:2]})
    names = [frozenset(h[2] for h in host if h[0] <= a < h[1])
             for a in points]
    return points, names


def idle_gaps(r: dict) -> List[Tuple[int, int]]:
    """The window's intervals in which the device ran nothing."""
    (w0, w1), gaps, prev = r["window"], [], r["window"][0]
    for s, e in r["busy"]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    return gaps


def _overlap(xs: Sequence[Tuple], ys: Sequence[Tuple]
             ) -> Iterable[Tuple[int, Tuple]]:
    """(ns of overlap, the y) of each overlapping pair of two sorted lists
    of disjoint intervals."""
    i = j = 0
    while i < len(xs) and j < len(ys):
        lo = max(xs[i][0], ys[j][0])
        hi = min(xs[i][1], ys[j][1])
        if hi > lo:
            yield hi - lo, ys[j]
        if xs[i][1] <= ys[j][1]:
            i += 1
        else:
            j += 1


def innermost(host: Sequence[Tuple[int, int, str, int]]
              ) -> List[Tuple[int, int, str]]:
    """The host ranges as disjoint pieces of time, each named by the
    innermost range open through it (the latest to start, on any thread),
    in order."""
    points = sorted({p for h in host for p in h[:2]})
    out: List[Tuple[int, int, str]] = []
    for a, b in zip(points, points[1:]):
        cover = [h for h in host if h[0] <= a and h[1] >= b]
        if cover:
            name = max(cover, key=lambda h: (h[0], -h[1]))[2]
            if out and out[-1][1] == a and out[-1][2] == name:
                out[-1] = (out[-1][0], b, name)
            else:
                out.append((a, b, name))
    return out


def idle_by_span(r: dict) -> Dict[str, float]:
    """The window's idle seconds split by the innermost ``repro::`` range
    around each idle instant (``OUTSIDE`` where there is none): the parts
    sum to the whole idle."""
    gaps = idle_gaps(r)
    out: Dict[str, float] = defaultdict(float)
    for ns, piece in _overlap(gaps, innermost(r["host"])):
        out[piece[2]] += ns / 1e9
    total = sum(e - s for s, e in gaps) / 1e9
    out[OUTSIDE] = total - sum(out.values())
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def idle_inside(r: dict, name: str) -> Tuple[float, float]:
    """(idle seconds, wall seconds) inside the host ranges of span
    ``name`` (their union)."""
    union = profile._union([h[:2] for h in r["host"] if h[2] == name])
    idle = sum(ns for ns, _ in _overlap(idle_gaps(r), union))
    return idle / 1e9, sum(e - s for s, e in union) / 1e9


def device_s(r: dict, names: Iterable[str]) -> float:
    """The device seconds of the operations launched inside the spans
    ``names``, summed over the names."""
    return sum(r["device"].get(n, 0.0) for n in names)


def per_step(spans, root: str) -> List[Dict[str, float]]:
    """The tracer's spans grouped under the root spans named ``root``, in
    the roots' order: each step's summed seconds by span name (the root's
    own included).  Spans under no such root are left out."""
    by_id = {s.id: s for s in spans}
    roots = sorted((s for s in spans if s.name == root),
                   key=lambda s: s.t_start_s)
    index = {s.id: i for i, s in enumerate(roots)}
    steps: List[Dict[str, float]] = [defaultdict(float) for _ in roots]
    for s in spans:
        top = s
        while top.id not in index and top.parent in by_id:
            top = by_id[top.parent]
        if top.id in index:
            steps[index[top.id]][s.name] += s.duration_s or 0.0
    return [dict(st) for st in steps]
