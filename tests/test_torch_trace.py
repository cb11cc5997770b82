"""The port's tracer (``repro_torch.obs.trace``) on the profiler's clock, and
the spans inside the train step, the SSD backward and the MoE layer, on the
CPU.

While ``torch.profiler`` records, an enabled tracer's span is also a
profiler range ``repro::<name>`` holding the ops it ran, an operator-kind
event and not a user annotation (which the card's profiler would mirror as
device work); with no profiler recording it enters none, and a disabled
tracer reads no clock and calls nothing of torch.  A span opened on a thread with no open span of its
own takes as parent the innermost span open on the thread that opened the
outermost one.  One training step records ``train.forward``,
``train.backward`` and ``train.optimizer`` (one forward and backward a
microbatch) and one ``ssd.backward`` per SSM layer under
``train.backward``; an MoE prefill records ``moe.route``, ``moe.dispatch``,
``moe.experts`` and ``moe.combine`` once per layer, its logits bit-equal to
the untraced step's.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.registry import ARCHS
from repro_torch.core.workload import WorkloadSpec
from repro_torch.distributed.plan import Plan
from repro_torch.obs import trace
from repro_torch.optim import optimizers as topt
from repro_torch.runtime import steps

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture
def tracer():
    t = trace.Tracer()
    prev = trace.set_tracer(t)
    try:
        yield t
    finally:
        trace.set_tracer(prev)


def _events(prof):
    """(name, start ns, end ns) of the profile's CPU events."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def test_a_span_is_a_profiler_range_holding_its_ops():
    t = trace.Tracer()
    a = torch.randn(16, 16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t.span("outer"):
            with t.span("mm"):
                torch.mm(a, a)
    ev = _events(prof)
    ranges = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("repro::")]
    assert len(ranges) == 2
    assert all(e.activity_type() == "cpu_op" and not e.is_user_annotation()
               for e in ranges)
    (mm_s, mm_e), = [(s, e) for n, s, e in ev if n == "repro::mm"]
    (out_s, out_e), = [(s, e) for n, s, e in ev if n == "repro::outer"]
    aten = [(s, e) for n, s, e in ev if n == "aten::mm"]
    assert len(aten) == 1
    assert mm_s <= aten[0][0] and aten[0][1] <= mm_e
    assert out_s <= mm_s and mm_e <= out_e
    assert [s.name for s in t.spans] == ["mm", "outer"]


def test_no_range_without_a_recording_profiler(monkeypatch):
    entered = []
    real = trace._enter_range
    monkeypatch.setattr(trace, "_enter_range",
                        lambda name: entered.append(name) or real(name))
    t = trace.Tracer()
    with t.span("quiet"):
        torch.mm(torch.ones(2, 2), torch.ones(2, 2))
    assert entered == [] and [s.name for s in t.spans] == ["quiet"]
    with profile(activities=[ProfilerActivity.CPU]):
        with t.span("heard"):
            pass
    assert entered == ["heard"]
    # the profiler's thread-local state: a thread it does not record
    # enters no range either
    with profile(activities=[ProfilerActivity.CPU]):
        th = threading.Thread(target=lambda: t.span("other").__exit__())
        th.start()
        th.join()
    assert entered == ["heard"]


def test_a_disabled_tracer_reads_no_clock_and_calls_no_torch(monkeypatch):
    reads = []
    t = trace.Tracer(enabled=False, clock=lambda: reads.append(1) or 0.0)
    n = len(reads)

    def boom(*a, **kw):
        raise AssertionError("a disabled tracer called torch")

    monkeypatch.setattr(trace, "_profiler_recording", boom)
    monkeypatch.setattr(trace, "_enter_range", boom)
    with profile(activities=[ProfilerActivity.CPU]):
        a = t.span("x", k=1)
        b = trace.NULL_TRACER.span("y")
        with a as sp:
            sp.set(k=2)
        t.instant("z")
    assert a is b
    assert len(reads) == n and t.spans == [] and t.instants == []
    assert not hasattr(t, "dropped")


def test_the_module_imports_without_torch():
    code = ("import sys; import repro_torch.obs.trace as t; "
            "s = t.Tracer(enabled=False).span('x'); "
            "print('torch' in sys.modules)")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "False"


def test_a_worker_span_takes_the_open_main_span_as_parent():
    t = trace.Tracer()
    opened = threading.Event()
    done = threading.Event()

    def work():
        opened.wait(30)
        with t.span("ssd.backward"):
            with t.span("inner"):
                pass
        done.set()

    th = threading.Thread(target=work)
    th.start()
    with t.span("train_step"):
        with t.span("train.backward"):
            opened.set()
            assert done.wait(30)
    th.join()
    by = {s.name: s for s in t.spans}
    assert by["train_step"].parent is None and by["train_step"].depth == 0
    assert by["train.backward"].parent == by["train_step"].id
    assert by["ssd.backward"].parent == by["train.backward"].id
    assert by["ssd.backward"].depth == 2
    assert by["inner"].parent == by["ssd.backward"].id
    assert by["ssd.backward"].thread == th.ident != by["train_step"].thread
    assert len({s.id for s in t.spans}) == 4
    # once every span has closed, a span on the worker's side is a root
    th2 = threading.Thread(target=lambda: t.span("later").__exit__())
    th2.start()
    th2.join()
    assert [s.parent for s in t.spans if s.name == "later"] == [None]


def test_spans_of_many_threads_lose_nothing():
    """More threads than cores open nested spans under one main-thread
    span, switching every microsecond: every span is recorded once, with
    its own id, and hangs under the right parent."""
    t = trace.Tracer()
    n, per = 4 * (os.cpu_count() or 4), 100

    def work():
        for _ in range(per):
            with t.span("a"):
                with t.span("b"):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with t.span("root"):
            threads = [threading.Thread(target=work) for _ in range(n)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(t.spans) == 2 * n * per + 1
    by = {s.id: s for s in t.spans}
    assert len(by) == len(t.spans)
    root = next(s for s in t.spans if s.name == "root")
    for s in t.spans:
        if s.name == "a":
            assert s.parent == root.id and s.depth == 1
        elif s.name == "b":
            a = by[s.parent]
            assert a.name == "a" and a.thread == s.thread != root.thread


def test_the_chrome_export_carries_id_parent_and_thread():
    t = trace.Tracer()
    with t.span("a", predicted_s=1.0, step=3):
        with t.span("b"):
            t.instant("mark", why="x")
    events = t.to_chrome_trace()["traceEvents"]
    json.dumps(events)
    by = {e["name"]: e["args"] for e in events if e["ph"] in ("X", "i")}
    a, b = by["a"], by["b"]
    assert a["step"] == 3 and a["parent"] is None
    assert b["parent"] == a["id"] and b["thread"] == a["thread"]
    assert by["mark"]["parent"] == b["id"] and by["mark"]["why"] == "x"
    assert by["a (predicted)"] == {"measured_s": t.spans[-1].duration_s,
                                   "predicted_s": 1.0,
                                   "gap_s": t.spans[-1].gap_s}


def _batch(cfg, B=2, S=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g,
                         dtype=torch.int32)
    return {"tokens": toks[:, :S], "labels": toks[:, 1:],
            "loss_mask": torch.ones(B, S)}


@pytest.mark.parametrize("microbatches", [1, 2])
def test_a_train_step_records_its_phases(tracer, microbatches):
    cfg = ARCHS["zamba2-2.7b"].reduced()
    o = topt.adamw()
    state = steps.init_train_state(cfg, torch.Generator().manual_seed(0), o,
                                   device="cpu")
    step = steps.make_train_step(cfg, o, Plan(microbatches=microbatches))
    with tracer.span("train_step"):
        state, m = step(state, _batch(cfg, B=2 * microbatches))
    assert torch.isfinite(m["loss"])
    names = [s.name for s in tracer.spans]
    M = microbatches
    assert names.count("train.forward") == M
    assert names.count("train.backward") == M
    assert names.count("train.optimizer") == 1
    assert names.count("ssd.backward") == M * cfg.n_layers
    by_id = {s.id: s for s in tracer.spans}
    root = next(s for s in tracer.spans if s.name == "train_step")
    for s in tracer.spans:
        if s.name.startswith("train."):
            assert s.parent == root.id, s
        elif s.name == "ssd.backward":
            assert by_id[s.parent].name == "train.backward"
            assert {k: s.args[k] for k in ("H", "L", "P")} == {
                "H": cfg.ssm_heads, "L": 32, "P": cfg.ssm.head_dim}
            assert s.args["Bz"] == 2 and s.args["chunk"] >= 1


def test_a_train_step_is_the_same_with_the_tracer_on(tracer):
    cfg = ARCHS["zamba2-2.7b"].reduced()
    o = topt.adamw()
    out = []
    for on in (False, True):
        trace.set_tracer(tracer if on else None)
        state = steps.init_train_state(
            cfg, torch.Generator().manual_seed(0), o, device="cpu")
        step = steps.make_train_step(cfg, o)
        state, m = step(state, _batch(cfg))
        out.append((m["loss"], dict(state.params.named_parameters())))
    (l0, p0), (l1, p1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(p0[n], p1[n]) for n in p0)
    assert tracer.spans


def _moe_prefill(cfg):
    model = steps.init_train_state(cfg, torch.Generator().manual_seed(0),
                                   topt.adamw(), device="cpu").params
    step = steps.make_step(cfg, WorkloadSpec(phase="prefill", global_batch=2,
                                             seq_len=32))
    return lambda: step(model, {"tokens": _batch(cfg)["tokens"]})


MOE_SPANS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")


def test_an_moe_prefill_records_its_four_phases(tracer):
    cfg = ARCHS["mixtral-8x7b"].reduced()
    run = _moe_prefill(cfg)
    trace.set_tracer(None)
    want = run()
    trace.set_tracer(tracer)
    got = run()
    assert torch.equal(got, want)
    names = [s.name for s in tracer.spans]
    assert sorted(names) == sorted(MOE_SPANS * cfg.n_layers)
    # in order, one layer after the other, each phase a root here
    starts = [s.name for s in sorted(tracer.spans,
                                     key=lambda s: s.t_start_s)]
    assert starts == list(MOE_SPANS) * cfg.n_layers
    assert all(s.parent is None for s in tracer.spans)


def test_an_moe_prefill_under_the_profiler_holds_its_ranges(tracer):
    cfg = ARCHS["mixtral-8x7b"].reduced()
    run = _moe_prefill(cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    ev = _events(prof)
    for name in MOE_SPANS:
        ranges = [(s, e) for n, s, e in ev if n == "repro::" + name]
        assert len(ranges) == cfg.n_layers, name
    route = [(s, e) for n, s, e in ev if n == "repro::moe.route"]
    cumsum = [(s, e) for n, s, e in ev if n == "aten::cumsum"]
    assert cumsum and all(any(rs <= s and e <= re for rs, re in route)
                          for s, e in cumsum)
