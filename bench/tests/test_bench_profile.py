"""The reduction of a profiler trace (``benchkit.profile.reduce``) on a
trace made by hand: the busy union, the idle gaps by host operation, the
device span of each range (its GPU annotation), and the wrapped entry
point."""
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

import _bench_tiny  # noqa: F401  (puts bench/ and src/ on the path)
from benchkit import profile


class Ev:
    def __init__(self, name, start, dur, dev=False, act=""):
        self._n, self._s, self._d = name, start, dur
        self._dev, self._a = dev, act

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return DeviceType.CUDA if self._dev else DeviceType.CPU

    def activity_type(self):
        return self._a


def prof_of(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def trace():
    ev = [Ev(profile.WINDOW, 0, 1000, act="user_annotation"),
          Ev("aten::mm", 0, 100, act="cpu_op"),
          Ev("bench::ssd_scan", 100, 200, act="user_annotation"),
          Ev("cudaLaunchKernel", 110, 10, act="cuda_runtime"),
          Ev("cudaLaunchKernel", 150, 10, act="cuda_runtime"),
          Ev("cudaDeviceSynchronize", 600, 400, act="cuda_runtime"),
          Ev("k_gemm", 50, 150, dev=True, act="kernel"),
          Ev("k_scan", 300, 100, dev=True, act="kernel"),
          Ev("k_tail", 450, 50, dev=True, act="kernel"),
          Ev("k_gemm", 480, 100, dev=True, act="kernel"),
          Ev("bench::ssd_scan", 300, 200, dev=True,
             act="gpu_user_annotation")]
    return prof_of(ev)


def test_reduce():
    r = profile.reduce(trace(), ["ssd_scan", "flash_attention"])
    # busy: 50-200, 300-400, 450-580
    assert r["busy_s"] == pytest.approx(380e-9)
    assert r["window_s"] == pytest.approx(1000e-9)
    assert r["spans"]["ssd_scan"] == [pytest.approx(200e-9)]
    assert r["spans"]["flash_attention"] == []
    assert r["device_ops"][0] == ["k_gemm", pytest.approx(250e-9)]
    gaps = dict(r["idle_gaps"])
    # 0-50 under aten::mm; 200-300 and 400-450 with no host op; 580-1000
    # in the synchronize
    assert gaps["cudaDeviceSynchronize"] == pytest.approx(420e-9)
    assert gaps["aten::mm"] == pytest.approx(50e-9)
    assert gaps["(no host op)"] == pytest.approx(150e-9)


def test_reduce_refuses_a_trace_without_the_device():
    with pytest.raises(RuntimeError, match="no device operation"):
        profile.reduce(prof_of([Ev(profile.WINDOW, 0, 10)]), [])


def test_calls_wrap_and_restore():
    mod = SimpleNamespace(f=lambda x, k=1: x * k)
    calls = profile.Calls(mod, "f", "f", lambda x, k=1: {"n": x.numel()})
    assert mod.f(torch.ones(3), k=2).sum() == 6
    assert calls.shapes == [{"n": 3}]
    calls.clear()
    assert calls.shapes == []
    calls.restore()
    assert mod.f(2) == 2
