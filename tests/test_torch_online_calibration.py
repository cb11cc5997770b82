"""Online calibration of the port against the JAX package, on the CPU
(mirrors ``tests/test_online_calibration.py``).

``calibration/telemetry.py`` and ``calibration/online.py`` are numpy copies
of the reference's: the same samples give the same fingerprints, windows,
JSON (a sink saved by either package loads in the other), the same CUSUM
events at the same onsets, and refit weights equal to 1e-10 registered as
the same revisions in a ``tmp_path`` registry.  The port's ``Trainer`` and
``DecodeServer`` feed a calibrator as the reference's do, at reduced size.
"""
from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch

from repro.calibration import online as jonline
from repro.calibration import registry as jregistry
from repro.calibration import telemetry as jtelemetry
from repro.core import predictor as jpredictor
from repro.core.model import LinearCostModel as JModel
from repro.core.workload import WorkloadSpec as JSpec
from repro.distributed.plan import Plan as JPlan
from repro.configs.registry import ARCHS as JARCHS
from repro_torch.calibration import online as tonline
from repro_torch.calibration import registry as tregistry
from repro_torch.calibration import telemetry as ttelemetry
from repro_torch.configs.registry import ARCHS
from repro_torch.core import exprops, predictor
from repro_torch.core.kernelmodel import PALLAS_KERNELS
from repro_torch.core.model import LinearCostModel
from repro_torch.core.workload import WorkloadSpec
from repro_torch.data.pipeline import DataConfig
from repro_torch.distributed.plan import Plan
from repro_torch.runtime.faults import Fault, FaultInjector, FaultPlan
from repro_torch.runtime.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

WEIGHTS_RTOL = 1e-10


@pytest.fixture(autouse=True)
def _isolated_registry(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_MODEL_REGISTRY", str(tmp_path / "ambient-reg"))


def _models(s, device="truth"):
    meta = {"source": "synthetic"}
    return (LinearCostModel(keys=s.keys, weights=s.weights, device=device,
                            meta=dict(meta)),
            JModel(keys=s.keys, weights=s.weights, device=device,
                   meta=dict(meta)))


# ---------------------------------------------------------------------------
# telemetry sink
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("phase", ["", "train", "decode"])
def test_pv_fingerprint_equals_the_reference(phase):
    rng = np.random.default_rng(3)
    for _ in range(5):
        pv = {k: float(v) for k, v in zip(("mxu:16", "const1", "x", "z"),
                                           rng.uniform(0, 1e9, 4))}
        pv["z"] = 0.0
        assert ttelemetry.pv_fingerprint(pv, phase) == \
            jtelemetry.pv_fingerprint(pv, phase)


def _feed_sinks(cap, n, seed):
    rng = np.random.default_rng(seed)
    t, j = ttelemetry.TelemetrySink(cap), jtelemetry.TelemetrySink(cap)
    for i in range(n):
        pv = {"x": float(rng.integers(1, 4)), "const1": 1.0}
        secs = float(rng.choice([0.1 * (i + 1), -1.0, float("nan"),
                                 float("inf")], p=[0.85, 0.05, 0.05, 0.05]))
        tag = "train" if i % 3 else "decode"
        kw = dict(step=i, tag=tag, phase="decode" if i % 3 == 0 else "train")
        assert t.record(pv, secs, **kw) == j.record(pv, secs, **kw)
    return t, j


@pytest.mark.parametrize("cap,n", [(4, 30), (64, 40)])
def test_sink_equals_the_reference(cap, n):
    """Dedup, eviction with gc, the quarantine of non-finite and
    non-positive timings, the windows by seq / tag / phase, and the JSON."""
    t, j = _feed_sinks(cap, n, seed=cap)
    assert t.stats() == j.stats()
    assert t.stats()["n_dropped"] > 0
    assert t.window() == j.window()
    for kw in (dict(since_seq=n // 2), dict(tag="decode"), dict(n=3),
               dict(phase="train"), dict(phase="decode", n=2)):
        assert t.window(**kw) == j.window(**kw), kw
        assert [s.seq for s in t.samples(**kw)] == \
            [s.seq for s in j.samples(**kw)]
    assert t.to_json_dict() == j.to_json_dict()


def test_sink_json_loads_across_the_packages(tmp_path):
    t, j = _feed_sinks(16, 24, seed=1)
    t.save(str(tmp_path / "t.json"))
    j.save(str(tmp_path / "j.json"))
    back_j = jtelemetry.TelemetrySink.load(str(tmp_path / "t.json"))
    back_t = ttelemetry.TelemetrySink.load(str(tmp_path / "j.json"))
    assert back_j.to_json_dict() == j.to_json_dict()
    assert back_t.to_json_dict() == t.to_json_dict()
    assert json.load(open(tmp_path / "t.json"))["schema"] == 2
    with pytest.raises(ValueError, match="not a telemetry record"):
        ttelemetry.TelemetrySink.from_json_dict({"kind": "nope"})
    with pytest.raises(ValueError):
        ttelemetry.TelemetrySink(capacity=0)


# ---------------------------------------------------------------------------
# the CUSUM drift monitor
# ---------------------------------------------------------------------------


def _events(mon):
    return [(e.seq, e.step, e.onset_seq, e.direction, e.phase)
            for e in mon.events]


@pytest.mark.parametrize("stream", ["step_up", "step_down", "noise",
                                    "ramp", "alternating"])
@pytest.mark.parametrize("params", [dict(), dict(slack=0.1, threshold=3.0),
                                    dict(slack=0.05, threshold=1.0,
                                         ewma=0.5)])
def test_drift_monitor_events_equal_the_reference(stream, params):
    """The same residual stream raises the same events (seq, onset,
    direction, magnitude at 1e-12) and leaves the same evidence."""
    rng = np.random.default_rng(len(stream))
    n = 400
    noise = 0.04 * rng.standard_normal(n)
    base = {"step_up": np.where(np.arange(n) < 150, 0.0, 0.6),
            "step_down": np.where(np.arange(n) < 90, 0.0, -0.4),
            "noise": np.zeros(n),
            "ramp": np.linspace(0.0, 1.0, n),
            "alternating": np.where((np.arange(n) // 60) % 2, 0.5, -0.5)
            }[stream]
    t, j = tonline.DriftMonitor(**params), jonline.DriftMonitor(**params)
    for i, r in enumerate(base + noise):
        a = t.observe(i, float(r), step=i, phase="decode")
        b = j.observe(i, float(r), step=i, phase="decode")
        assert (a is None) == (b is None), i
        assert t.evidence == pytest.approx(j.evidence, rel=1e-12, abs=0)
        assert t.status == j.status
    assert _events(t) == _events(j)
    np.testing.assert_allclose([e.magnitude for e in t.events],
                               [e.magnitude for e in j.events], rtol=1e-12)
    if stream == "noise":
        assert not t.events
    if stream == "step_up":
        assert t.events[0].direction == "slow"


@pytest.mark.parametrize("shift", [1.2, 1.5, 2.0])
def test_drift_monitor_flags_within_bounded_samples(shift):
    mon = tonline.DriftMonitor(slack=0.1, threshold=3.0)
    resid = shift - 1.0
    bound = math.ceil(mon.threshold / (resid - mon.slack)) + 2
    for i in range(bound):
        ev = mon.observe(i, resid, step=i)
        if ev is not None:
            break
    assert ev is not None and ev.direction == "slow" and ev.onset_seq == 0
    assert mon.evidence == 0.0         # state reset after the event


# ---------------------------------------------------------------------------
# the calibrator: events, refits, revisions
# ---------------------------------------------------------------------------


def _run_both(s, tmp_path, **kw):
    tm, jm = _models(s)
    tdir, jdir = tmp_path / "t", tmp_path / "j"
    tcache = exprops.BasisCache(maxsize=64)
    t = tonline.OnlineCalibrator(tm, registry_dir=str(tdir), caches=[tcache],
                                 **kw)
    j = jonline.OnlineCalibrator(jm, registry_dir=str(jdir), **kw)
    for i, (pv, secs) in enumerate(zip(s.pvs, s.times)):
        a = t.observe(pv, secs, step=i)
        b = j.observe(pv, secs, step=i)
        assert (a is None) == (b is None), i
    return t, j, tcache


@pytest.mark.parametrize("seed,shift,noise", [(5, 1.5, 0.02),
                                              (11, 1.6, 0.03),
                                              (2, 0.6, 0.02),
                                              (21, 1.0, 0.05)])
@pytest.mark.parametrize("auto_register", [True, False])
def test_calibrator_equals_the_reference(tmp_path, make_drift_stream, seed,
                                         shift, noise, auto_register):
    """Drift events and onsets identical, refit weights to 1e-10, the same
    revisions registered (``register_revision`` into a ``tmp_path``
    registry each), caches cleared once per refit, the same reports."""
    s = make_drift_stream(n_pre=120, n_post=80, shift=shift, noise=noise,
                          seed=seed)
    t, j, cache = _run_both(s, tmp_path, device="drift-dev",
                            auto_register=auto_register, residual=True)
    assert _events(t) == _events(j)
    assert t.refits == j.refits and t.revision == j.revision
    assert cache.invalidations == t.refits
    if shift == 1.0:
        assert t.refits == 0
    if shift > 1.0:
        assert t.refits >= 1 and abs(t.events[0].onset_seq
                                     - s.shift_index) <= 3
    assert t.model.keys == j.model.keys
    np.testing.assert_allclose(t.model.weights, j.model.weights,
                               rtol=WEIGHTS_RTOL)
    assert {k: v for k, v in t.model.meta.items()} == \
        {k: v for k, v in j.model.meta.items()}
    np.testing.assert_allclose(t.rls.w, j.rls.w, rtol=WEIGHTS_RTOL)
    assert t.window_rel_err() == pytest.approx(j.window_rel_err(),
                                               rel=1e-9)
    assert t.report_line() == j.report_line()
    assert t.final_report() == j.final_report()
    if auto_register and t.refits:
        a = tregistry.load_model("drift-dev", str(tmp_path / "t"))
        b = jregistry.load_model("drift-dev", str(tmp_path / "j"))
        assert a.meta["revision"] == b.meta["revision"] == t.revision
        np.testing.assert_allclose(a.weights, b.weights, rtol=WEIGHTS_RTOL)
        # a model the port registered loads in the reference too
        c = jregistry.load_model("drift-dev", str(tmp_path / "t"))
        np.testing.assert_array_equal(c.weights, a.weights)


@pytest.mark.parametrize("phase", ["train", "decode"])
def test_phase_scoped_calibrator_equals_the_reference(tmp_path,
                                                      make_drift_stream,
                                                      phase):
    s = make_drift_stream(n_pre=60, n_post=60, shift=1.8, noise=0.01,
                          seed=4)
    tm, jm = _models(s)
    t = tonline.OnlineCalibrator(tm, device="p", phase=phase, warmup=4)
    j = jonline.OnlineCalibrator(jm, device="p", phase=phase, warmup=4)
    for i, (pv, secs) in enumerate(zip(s.pvs, s.times)):
        ph = "train" if i % 2 else "decode"
        t.observe(pv, secs, step=i, phase=ph)
        j.observe(pv, secs, step=i, phase=ph)
    assert _events(t) == _events(j) and t.events
    assert all(e.phase == phase for e in t.events)
    np.testing.assert_allclose(t.model.weights, j.model.weights,
                               rtol=WEIGHTS_RTOL)
    assert t.sink.stats() == j.sink.stats()


def test_poisoned_samples_are_quarantined_not_fitted(make_drift_stream):
    s = make_drift_stream(n_pre=40, n_post=0, shift=1.0, noise=0.0, seed=8)
    tm, _ = _models(s)
    cal = tonline.OnlineCalibrator(tm, device="q", warmup=4)
    for i, (pv, secs) in enumerate(zip(s.pvs, s.times)):
        poison = [float("nan"), float("inf"), -1.0, 0.0][i % 4] \
            if i % 10 == 5 else secs
        assert cal.observe(pv, poison, step=i) is None
    assert cal.sink.stats()["n_dropped"] == 4
    assert cal.rls.n_samples == 36 and cal.refits == 0


def test_calibrator_warm_starts_from_a_registered_model(tmp_path):
    """A calibrator named by its registry entry tracks from the fitted
    weights and resolves through the hardened loader, as the reference's."""
    m = LinearCostModel(keys=["const1", "x"], weights=np.array([1e-3, 2e-9]),
                        device="warm", meta={"source": "fitted"})
    tregistry.register_revision(m, str(tmp_path))
    t = tonline.OnlineCalibrator("warm", registry_dir=str(tmp_path))
    j = jonline.OnlineCalibrator("warm", registry_dir=str(tmp_path))
    assert t.revision == j.revision == 1
    np.testing.assert_array_equal(t.rls.w, j.rls.w)
    pv = {"const1": 1.0, "x": 1e6}
    assert t.rls.predict(pv) == pytest.approx(j.rls.predict(pv), rel=1e-15)


# ---------------------------------------------------------------------------
# the live property vectors: the reference's workloads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["smollm-360m", "llama3.2-3b"])
def test_live_property_vectors_are_the_references_on_its_kernels(arch):
    """The trainer's and the server's live vectors are
    ``plan_property_vector`` of the reference's workloads: on the
    reference's Pallas blocks they equal its vectors at rtol 1e-12."""
    cases = [(JSpec(phase="train", global_batch=4, seq_len=64,
                    name="train_live"),
              WorkloadSpec(phase="train", global_batch=4, seq_len=64,
                           name="train_live"),
              JPlan(dp_axes=()), Plan(dp_axes=())),
             (JSpec(phase="decode", global_batch=2, seq_len=64,
                    name="decode_live"),
              WorkloadSpec(phase="decode", global_batch=2, seq_len=64,
                           name="decode_live"),
              JPlan(dp_axes=(), tp_axis=None, fsdp=False,
                    sequence_parallel=False),
              Plan(dp_axes=(), tp_axis=None, fsdp=False,
                   sequence_parallel=False))]
    for js, ts, jp, tp in cases:
        want = jpredictor.plan_property_vector(JARCHS[arch], js, jp,
                                               {"data": 1})
        got = predictor.plan_property_vector(ARCHS[arch], ts, tp,
                                             {"data": 1},
                                             kernels=PALLAS_KERNELS)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-12), k


# ---------------------------------------------------------------------------
# the runtime feeds the calibrator
# ---------------------------------------------------------------------------


def _trainer(tmp_path, **tc_kw):
    cfg = ARCHS["smollm-360m"].reduced()
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4,
                    seed=5)
    tc = TrainerConfig(log_every=2, total_steps=6, **tc_kw)
    return cfg, dc, tc


def test_trainer_feeds_calibrator(tmp_path, capsys):
    cfg, dc, tc = _trainer(tmp_path, online_calibrate=True,
                           calib_registry=str(tmp_path))
    t = Trainer(cfg, dc, tc, device="cpu")
    assert t.calibrator is not None and t.calibrator.device == \
        f"{cfg.name}-online"
    live = WorkloadSpec(phase="train", global_batch=4, seq_len=64,
                        name="train_live")
    assert t._step_pv == predictor.plan_property_vector(
        cfg, live, Plan(dp_axes=()), {"data": 1})
    t.train(6)
    assert t.calibrator.sink.stats()["n_recorded"] == 6
    assert t.calibrator.sink.samples(tag="train")
    assert t.calibrator.rls.n_samples == 6
    # the samples are the history's measured seconds
    assert t.calibrator.sink.window()[1] == [m["time_s"] for m in t.history]
    out = capsys.readouterr().out
    assert "[calib] samples=" in out and "drift=" in out


def test_trainer_calibrator_sees_injected_faults(tmp_path, capsys):
    """A slowdown scales the sample the calibrator sees, a poisoned sample
    is quarantined, and a drift event re-anchors the straggler monitor."""
    cfg, dc, tc = _trainer(tmp_path)
    model = LinearCostModel.from_dict({"const1": 1.0})
    cal = tonline.OnlineCalibrator(
        model, device="inj", warmup=1,
        drift=tonline.DriftMonitor(slack=0.15, threshold=1.0))
    inj = FaultInjector(FaultPlan(faults=(
        Fault("slowdown", 3, factor=50.0, duration=3),
        Fault("telemetry_nan", 1))))
    t = Trainer(cfg, dc, tc, calibrator=cal, injector=inj, device="cpu")
    t.train(6)
    assert cal.sink.stats()["n_dropped"] == 1
    assert cal.sink.stats()["n_recorded"] == 5
    secs = cal.sink.window()[1]
    assert [h["time_s"] for h in t.history if h["step"] != 1] == secs
    assert [e.direction for e in cal.events][:1] == ["slow"]
    assert cal.refits >= 1
    assert t.monitor.predicted_step_s == pytest.approx(
        cal.model.predict(t._step_pv))
    assert "drift detected at step" in capsys.readouterr().out
    assert inj.counts() == {"slowdown": 3, "telemetry_nan": 1}


def test_decode_server_feeds_calibrator(tmp_path):
    from repro_torch.models import transformer
    from repro_torch.runtime.server import DecodeServer, Request
    cfg = ARCHS["smollm-360m"].reduced()
    model = transformer.init_params(cfg, device="cpu", seed=0)
    cal = tonline.OnlineCalibrator(None, device="decode-dev",
                                   registry_dir=str(tmp_path))
    inj = FaultInjector(FaultPlan(faults=(Fault("timing_spike", 1,
                                                factor=9.0),)))
    srv = DecodeServer(cfg, model, slots=2, max_len=64, seed=0,
                       calibrator=cal, injector=inj, device="cpu")
    rng = np.random.default_rng(0)
    srv.submit(Request(rid=0, prompt=rng.integers(2, 200, 4).astype(np.int32),
                       max_new=4))
    done = srv.run()
    assert len(done) == 1
    assert cal.sink.stats()["n_recorded"] == 4
    assert all(sm.tag == "decode" and sm.phase == "decode"
               for sm in cal.sink.samples())
    assert inj.counts() == {"timing_spike": 1}
    live = WorkloadSpec(phase="decode", global_batch=2, seq_len=64,
                        name="decode_live")
    assert srv._decode_pv == predictor.plan_property_vector(
        cfg, live, Plan(dp_axes=(), tp_axis=None, fsdp=False,
                        sequence_parallel=False), {"data": 1})
