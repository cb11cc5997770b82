"""The reduction of the program's ``repro::`` ranges
(``benchkit.spans``) on a trace made by hand, the tracer's spans grouped
by step, and the span report's refusal without the card."""
import itertools
import subprocess
import sys
import threading

import pytest

import _bench_tiny
from benchkit import profile, spans
from repro_torch.obs import trace
from test_bench_profile import Ev as _Ev, prof_of


class Ev(_Ev):
    """An event of the hand-made trace, with its thread and correlation
    id."""

    def __init__(self, *args, tid=1, corr=0, **kw):
        super().__init__(*args, **kw)
        self._t, self._c = tid, corr

    def start_thread_id(self):
        return self._t

    def correlation_id(self):
        return self._c


def hand_trace():
    """A window 0-1000 ns: train.backward 100-900 on thread 1,
    ssd.backward 200-500 on thread 2 (the autograd engine's) inside it;
    device operations 0-150, 250-300, 400-450, 600-700, launched at -50
    (thread 1), 120 (thread 1), 210 (thread 2) and 550 (thread 2)."""
    ev = [Ev(profile.WINDOW, 0, 1000, act="user_annotation"),
          Ev("repro::train.backward", 100, 800, act="cpu_op"),
          Ev("repro::ssd.backward", 200, 300, act="cpu_op", tid=2),
          Ev("aten::mm", 250, 20, act="cpu_op", tid=2),
          Ev("bench::ssd_scan", 10, 100, act="user_annotation"),
          Ev("cudaLaunchKernel", -50, 5, act="cuda_runtime", corr=10),
          Ev("cudaLaunchKernel", 120, 5, act="cuda_runtime", corr=11),
          Ev("cudaMemcpyAsync", 210, 5, act="cuda_runtime", tid=2, corr=12),
          Ev("cudaLaunchKernel", 550, 5, act="cuda_runtime", tid=2,
             corr=13),
          Ev("k0", 0, 150, dev=True, act="kernel", corr=10),
          Ev("k1", 250, 50, dev=True, act="kernel", corr=11),
          Ev("k2", 400, 50, dev=True, act="gpu_memcpy", corr=12),
          Ev("k3", 600, 100, dev=True, act="kernel", corr=13),
          Ev("bench::ssd_scan", 0, 150, dev=True, act="gpu_user_annotation"),
          Ev("repro::other", 300, 400, dev=True),
          Ev("repro::late", 1200, 10, act="cpu_op")]
    return prof_of(ev)


def test_ranges():
    r = spans.ranges(hand_trace())
    assert r["window"] == (0, 1000)
    # no device-side range counts as device work
    assert r["busy"] == [(0, 150), (250, 300), (400, 450), (600, 700)]
    # the late range lies outside the window
    assert r["host"] == [(100, 900, "train.backward", 1),
                         (200, 500, "ssd.backward", 2)]
    # k1 launched inside train.backward on its thread, k2 inside
    # ssd.backward on the autograd thread; k0 and k3 outside any range of
    # their launching thread
    assert r["device"] == {"train.backward": pytest.approx(50e-9),
                           "ssd.backward": pytest.approx(50e-9)}
    with pytest.raises(RuntimeError, match="no window"):
        spans.ranges(prof_of([Ev("k", 0, 1, dev=True, act="kernel")]))


def test_idle_by_span_sums_to_the_whole_idle():
    r = spans.ranges(hand_trace())
    # idle: 150-250, 300-400, 450-600, 700-1000 = 650 ns
    assert spans.idle_gaps(r) == [(150, 250), (300, 400), (450, 600),
                                  (700, 1000)]
    by = spans.idle_by_span(r)
    # innermost: ssd.backward 200-500 -> 50 + 100 + 50; train.backward
    # 100-200 and 500-900 -> 50 + 100 + 200; outside 900-1000 -> 100
    assert by["ssd.backward"] == pytest.approx(200e-9)
    assert by["train.backward"] == pytest.approx(350e-9)
    assert by[spans.OUTSIDE] == pytest.approx(100e-9)
    assert sum(by.values()) == pytest.approx(650e-9)
    assert list(by) == ["train.backward", "ssd.backward", spans.OUTSIDE]


def test_idle_inside_and_device_seconds():
    r = spans.ranges(hand_trace())
    idle, wall = spans.idle_inside(r, "ssd.backward")
    assert (idle, wall) == (pytest.approx(200e-9), pytest.approx(300e-9))
    idle, wall = spans.idle_inside(r, "train.backward")
    assert (idle, wall) == (pytest.approx(550e-9), pytest.approx(800e-9))
    assert spans.idle_inside(r, "moe.route") == (0.0, 0.0)
    assert spans.device_s(r, ["ssd.backward"]) == pytest.approx(50e-9)
    assert spans.device_s(r, ["ssd.backward", "train.backward",
                              "moe.route"]) == pytest.approx(100e-9)


def test_innermost_takes_the_latest_range_to_start():
    host = [(0, 100, "a", 1), (10, 50, "b", 2), (20, 30, "c", 1),
            (60, 100, "d", 1)]
    assert spans.innermost(host) == [(0, 10, "a"), (10, 20, "b"),
                                     (20, 30, "c"), (30, 50, "b"),
                                     (50, 60, "a"), (60, 100, "d")]
    assert spans.innermost([]) == []


def test_per_step_groups_spans_under_their_step():
    ticks = itertools.count(0.0, 1.0)
    t = trace.Tracer(clock=lambda: next(ticks))
    for i in range(3):
        with t.span("window_step"):
            with t.span("train.backward"):
                ready = threading.Event()

                def work():
                    for _ in range(i + 1):
                        with t.span("ssd.backward"):
                            pass
                    ready.set()

                th = threading.Thread(target=work)
                th.start()
                assert ready.wait(30)
                th.join()
            with t.span("train.optimizer"):
                pass
    with t.span("outside"):
        pass
    steps = spans.per_step(t.spans, "window_step")
    assert len(steps) == 3
    assert [s["ssd.backward"] for s in steps] == [1.0, 2.0, 3.0]
    assert all(s["train.optimizer"] == 1.0 for s in steps)
    assert all("outside" not in s for s in steps)
    assert steps[0]["train.backward"] == 3.0
    assert steps[0]["window_step"] == 7.0


def test_the_span_report_needs_the_card():
    p = subprocess.run([sys.executable, str(_bench_tiny.BENCH /
                                             "span_report.py"),
                        "--workload", "zamba2-train", "--seed", "3"],
                       capture_output=True, text=True, timeout=300)
    if p.returncode != 2:
        pytest.fail(p.stderr[-2000:])
    assert "no CUDA device" in p.stderr
