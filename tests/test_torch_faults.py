"""Fault injection and supervised recovery of the port against the JAX
package, on the CPU (mirrors ``tests/test_faults.py``).

``runtime/faults.py`` and ``runtime/supervisor.py`` are copies of the
reference's: the same seeds give the same plans (JSON equal), the same
grammar parses to the same faults, the same backoff delays, the same
corruption bytes and the same watchdog ladder.  A supervised port run
through an injected ``device_loss`` (and a corrupt newest checkpoint)
equals the port's unsupervised history at rtol 1e-5 and the JAX
``Trainer``'s at rtol 1e-4 (the reference's initial parameters loaded);
the supervisor releases the dead trainer before it builds the next (the
port's one deviation), and the serving supervisor evicts, sheds and
completes as the reference's does.
"""
from __future__ import annotations

import json
import os
import shutil
import weakref

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.data.pipeline import DataConfig as JDataConfig
from repro.runtime import faults as jfaults
from repro.runtime import supervisor as jsup
from repro.runtime.trainer import Trainer as JTrainer
from repro.runtime.trainer import TrainerConfig as JTrainerConfig
from repro_torch.calibration import registry, seeds
from repro_torch.checkpoint import store
from repro_torch.configs.registry import ARCHS
from repro_torch.core import exprops
from repro_torch.core.model import LinearCostModel
from repro_torch.core.workload import WorkloadSpec
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.convert import params_from_reference
from repro_torch.obs import metrics as obs_metrics
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime import supervisor as tsup
from repro_torch.runtime.faults import (DeviceLossError, Fault,
                                        FaultInjector, FaultPlan,
                                        corrupt_checkpoint, corrupt_file)
from repro_torch.runtime.supervisor import (BackoffPolicy, ServingPolicy,
                                            ServingSupervisor, Supervisor,
                                            Watchdog)
from repro_torch.runtime.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

REPLAY_RTOL = 1e-5      # supervised port vs unsupervised port
JAX_RTOL = 1e-4         # supervised port vs the JAX Trainer


# ---------------------------------------------------------------------------
# FaultPlan: determinism, serialization, grammar — equal to the reference
# ---------------------------------------------------------------------------

KINDS = [None, ("slowdown", "timing_spike", "telemetry_nan", "device_loss"),
         tfaults.FAULT_KINDS]


@pytest.mark.parametrize("kinds", KINDS, ids=["default", "mixed", "all"])
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_random_plan_json_equals_the_reference(seed, kinds):
    kw = {} if kinds is None else {"kinds": kinds}
    t = FaultPlan.random(seed=seed, n_steps=100, n_faults=6, **kw)
    j = jfaults.FaultPlan.random(seed=seed, n_steps=100, n_faults=6, **kw)
    assert json.dumps(t.to_json_dict(), sort_keys=True) == \
        json.dumps(j.to_json_dict(), sort_keys=True)
    assert t == FaultPlan.random(seed=seed, n_steps=100, n_faults=6, **kw)
    assert t.describe() == j.describe()
    assert FaultPlan.from_json_dict(j.to_json_dict()) == t


SPECS = ["corrupt_registry@7;device_loss@12:count=2;"
         "slowdown@3:factor=8.0,duration=4",
         "pool_shrink@5:pool=a100,k=2;pool_grow@9:pool=v5e",
         "telemetry_nan@4:value=-1.0;timing_spike@4:factor=16",
         "corrupt_checkpoint@2:mode=garbage;corrupt_compile_cache@2",
         "device_loss@7:pool=h100;slowdown@0"]


@pytest.mark.parametrize("spec", SPECS)
def test_plan_parse_equals_the_reference(spec, tmp_path):
    t = FaultPlan.parse(spec, seed=5)
    j = jfaults.FaultPlan.parse(spec, seed=5)
    assert t.to_json_dict() == j.to_json_dict()
    assert [f.fleet_scoped for f in t.faults] == \
        [f.fleet_scoped for f in j.faults]
    path = str(tmp_path / "plan.json")
    j.save(path)
    assert FaultPlan.parse(path) == t      # a JSON plan path, the CLI's


@pytest.mark.parametrize("bad", [
    lambda m: m.Fault(kind="explode", step=1),
    lambda m: m.Fault(kind="slowdown", step=-1),
    lambda m: m.FaultPlan.parse("slowdown"),
    lambda m: m.Fault(kind="corrupt_registry", step=0, mode="wat"),
    lambda m: m.Fault(kind="timing_spike", step=1, pool="a100"),
    lambda m: m.FaultPlan.from_json_dict({"kind": "nope"})])
def test_plan_rejects_garbage_as_the_reference(bad):
    with pytest.raises(ValueError):
        bad(jfaults)
    with pytest.raises(ValueError):
        bad(tfaults)


@pytest.mark.parametrize("kw", [dict(seed=11), dict(seed=3, base_s=0.1,
                                                    max_s=1.0, jitter=0.25),
                                dict(seed=0, factor=3.0, jitter=0.0)])
def test_backoff_sequence_equals_the_reference(kw):
    t, j = BackoffPolicy(**kw), jsup.BackoffPolicy(**kw)
    assert t.sequence(10) == j.sequence(10)
    assert [t.delay(i) for i in range(6)] == [j.delay(i) for i in range(6)]
    assert all(0.0 <= d <= t.max_s * (1 + t.jitter) for d in t.sequence(10))


# ---------------------------------------------------------------------------
# FaultInjector hooks
# ---------------------------------------------------------------------------


def test_empty_plan_hooks_are_identity():
    inj = FaultInjector(FaultPlan())
    assert not inj.armed()
    inj.step_begin(0)
    inj.decode_begin(3)
    assert inj.perturb_step_time(5, 0.25) == 0.25
    assert inj.perturb_decode_time(5, 0.25) == 0.25
    assert inj.perturb_telemetry(5, 0.25) == 0.25
    assert inj.injected == [] and inj.counts() == {} \
        and inj.fleet_events(0) == []


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_injector_hooks_equal_the_reference(seed):
    """A random plan over every non-file kind: the perturbed step and decode
    times, the telemetry samples, the device losses and the audit tally
    equal the reference's step by step (replays included)."""
    kinds = ("slowdown", "timing_spike", "telemetry_nan", "device_loss")
    plan = FaultPlan.random(seed=seed, n_steps=30, n_faults=8, kinds=kinds)
    t = FaultInjector(plan)
    j = jfaults.FaultInjector(jfaults.FaultPlan.from_json_dict(
        plan.to_json_dict()))
    for step in list(range(30)) + list(range(10, 20)):     # a replay
        lost = []
        for inj, err in ((t, DeviceLossError), (j, jfaults.DeviceLossError)):
            try:
                inj.step_begin(step)
                lost.append(None)
            except err as e:
                lost.append((e.count, e.step))
        assert lost[0] == lost[1], step
        dt = 0.01 * (step + 1)
        assert t.perturb_step_time(step, dt) == j.perturb_step_time(step, dt)
        assert t.perturb_decode_time(step, dt) == \
            j.perturb_decode_time(step, dt)
        a, b = t.perturb_telemetry(step, dt), j.perturb_telemetry(step, dt)
        assert a == b or (np.isnan(a) and np.isnan(b))
    assert t.counts() == j.counts()
    assert [(r.step, r.kind, r.detail) for r in t.injected] == \
        [(r.step, r.kind, r.detail) for r in j.injected]


def test_device_loss_is_one_shot():
    inj = FaultInjector(FaultPlan(faults=(Fault("device_loss", 2,
                                                count=3),)))
    with pytest.raises(DeviceLossError) as ei:
        inj.step_begin(2)
    assert ei.value.count == 3 and ei.value.step == 2
    inj.step_begin(2)           # replay after resume: does not re-fire
    assert inj.counts() == {"device_loss": 1}


@pytest.mark.parametrize("mode", ["truncate", "garbage"])
def test_corrupt_file_bytes_equal_the_reference(tmp_path, mode):
    body = json.dumps({"k": list(range(100))}).encode()
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    a.write_bytes(body)
    b.write_bytes(body)
    assert corrupt_file(str(a), np.random.default_rng(4), mode=mode)
    assert jfaults.corrupt_file(str(b), np.random.default_rng(4), mode=mode)
    assert a.read_bytes() == b.read_bytes() != body
    with pytest.raises(ValueError):
        json.loads(a.read_bytes())
    assert not corrupt_file(str(tmp_path / "missing"), mode=mode)


# ---------------------------------------------------------------------------
# the hardened readers the file faults land on
# ---------------------------------------------------------------------------


def _chaos_model(name="chaos"):
    m = seeds.ANALYTIC_SEEDS["gpu-h100"]()
    return LinearCostModel(keys=list(m.keys), weights=m.weights.copy(),
                           device=name, meta={})


def test_corrupt_registry_falls_back_to_previous_revision(tmp_path):
    """``corrupt_registry`` through the injector lands on the registry copy
    it is wired to; the hardened loader quarantines it and serves the
    previous revision."""
    d = str(tmp_path / "reg")
    m = _chaos_model()
    registry.register_revision(m, d, name="chaos")
    registry.register_revision(m, d, name="chaos")
    path = registry._model_path(d, "chaos")
    before = obs_metrics.REGISTRY.counter(
        "repro_registry_fallbacks_total").value(device="chaos")
    inj = FaultInjector(FaultPlan(faults=(Fault("corrupt_registry", 1),)),
                        registry_dir=d, registry_device="chaos")
    inj.step_begin(1)
    assert inj.injected[0].detail == path
    got = registry.load_model("chaos", d)        # must NOT raise
    assert got.meta.get("revision") == 1
    assert os.path.exists(path + ".corrupt") and not os.path.exists(path)
    assert obs_metrics.REGISTRY.counter(
        "repro_registry_fallbacks_total").value(device="chaos") == before + 1


def test_corrupt_checkpoint_helper_targets_newest(tmp_path):
    ck = str(tmp_path / "ck")
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": np.ones(4, np.float32)}
    store.save(ck, 2, tree)
    store.save(ck, 4, tree)
    target = corrupt_checkpoint(ck, np.random.default_rng(0), mode="garbage")
    assert target is not None and "step_00000004" in target
    out = store.restore_latest_valid(ck, tree)
    assert out is not None and out[2] == 2
    assert os.path.isdir(os.path.join(ck, "quarantine", "step_00000004"))
    assert corrupt_checkpoint(str(tmp_path / "empty")) is None


def test_corrupt_compile_cache_rebuilds(tmp_path, monkeypatch):
    """``corrupt_compile_cache`` corrupts every entry of the port's compile
    cache (``exprops.compile_cache_dir()``); the next load is a miss that
    rebuilds and quarantines the bad entry."""
    from repro_torch.core.symcount import Var
    monkeypatch.setenv("REPRO_COMPILE_CACHE", str(tmp_path))
    calls = []

    def builder():
        calls.append(1)
        return {"p": Var("x") * 3 + 1}

    key = exprops.program_key("chaos-test-program", "v1")
    exprops.load_or_build(key, builder)
    path = os.path.join(exprops.compile_cache_dir(), f"{key}.json")
    inj = FaultInjector(FaultPlan(faults=(Fault("corrupt_compile_cache",
                                                0),)))
    inj.step_begin(0)
    assert inj.injected[0].detail == "entries=1"
    errors_before = exprops.DISK_STATS["errors"]
    prog = exprops.load_or_build(key, builder)   # must NOT raise
    assert len(calls) == 2 and exprops.DISK_STATS["errors"] == \
        errors_before + 1
    got = exprops.score_cells(prog, {"x": np.arange(1, 3, dtype=np.int64)},
                              2, LinearCostModel.from_dict({"p": 2.0}))
    np.testing.assert_allclose(got, 2.0 * (np.arange(1, 3) * 3 + 1))
    assert os.path.exists(path) and os.path.exists(path + ".corrupt")


# ---------------------------------------------------------------------------
# the watchdog ladder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(k=3.0, warmup=2),
                                dict(k=2.0, warmup=0, window=4)])
def test_watchdog_ladder_equals_the_reference(kw):
    rng = np.random.default_rng(2)
    dts = np.concatenate([[60.0], rng.uniform(0.09, 0.11, 8), [1.0] * 5,
                          rng.uniform(0.09, 0.11, 4), [5.0] * 3])
    t, j = Watchdog(**kw), jsup.Watchdog(**kw)
    for i, dt in enumerate(dts):
        pred = 0.1 if i % 3 else None
        a, b = t.observe(float(dt), pred), j.observe(float(dt), pred)
        assert a == b, i
        if a[0] == "rescale":
            assert t.rescale() == j.rescale()
    assert t.observe(1e3)[0] is not None
    assert Watchdog(k=60.0, max_k=64.0).rescale() == 64.0   # bounded


def test_watchdog_warmup_never_breaches():
    w = Watchdog(k=2.0, warmup=2)
    # the first step builds the kernels; warmup must swallow it
    assert w.observe(60.0)[0] is None
    assert w.observe(0.1)[0] is None


# ---------------------------------------------------------------------------
# the supervised trainer
# ---------------------------------------------------------------------------

_ARCH = "smollm-360m"
_TOTAL = 14


def _cfgs(ckpt_dir):
    cfg = ARCHS[_ARCH].reduced()
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4,
                    seed=5)
    tc = TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=5,
                       total_steps=_TOTAL, seed=0, log_every=1000)
    return cfg, dc, tc


@pytest.fixture(scope="module")
def start(tmp_path_factory):
    """A step-0 checkpoint holding the JAX Trainer's initial parameters:
    every port trainer built on a copy of it resumes from them."""
    jcfg = JARCHS[_ARCH].reduced()
    jt = JTrainer(jcfg, JDataConfig(vocab_size=jcfg.vocab_size, seq_len=64,
                                    global_batch=4, seed=5),
                  JTrainerConfig(total_steps=_TOTAL, seed=0,
                                 log_every=1000))
    tree = jax.tree.map(np.asarray, jt.state.params)
    want = jt.train(_TOTAL)
    d = str(tmp_path_factory.mktemp("start-ckpt"))
    cfg, dc, tc = _cfgs(d)
    t = Trainer(cfg, dc, tc, device="cpu")
    t.state.params.load_state_dict(params_from_reference(cfg, tree))
    t._save(blocking=True)
    return d, want


def _ckpt_from(start, tmp_path, name):
    d = str(tmp_path / name)
    shutil.copytree(start[0], d)
    return d


@pytest.fixture(scope="module")
def unsupervised(start, tmp_path_factory):
    """The fault-free unsupervised port run every chaos run must
    reproduce."""
    d = str(tmp_path_factory.mktemp("ref"))
    shutil.rmtree(d)
    shutil.copytree(start[0], d)
    cfg, dc, tc = _cfgs(d)
    return Trainer(cfg, dc, tc, device="cpu").train(_TOTAL)


def _fast_backoff():
    return BackoffPolicy(base_s=0.0, factor=2.0, max_s=0.0, jitter=0.0,
                         seed=2)


def _assert_history(hist, want, rtol, grad_rtol):
    assert [h["step"] for h in hist] == [h["step"] for h in want]
    for h, r in zip(hist, want):
        np.testing.assert_allclose(h["loss"], r["loss"], rtol=rtol)
        np.testing.assert_allclose(h["grad_norm"], r["grad_norm"],
                                   rtol=grad_rtol)


def test_device_loss_replan_resume_exact(tmp_path, start, unsupervised):
    ck = _ckpt_from(start, tmp_path, "chaos")
    cfg, dc, tc = _cfgs(ck)
    inj = FaultInjector(FaultPlan(faults=(Fault("device_loss", 9),),
                                  seed=1), ckpt_dir=ck)
    wl = WorkloadSpec(phase="train", global_batch=4, seq_len=64,
                      name="chaos")
    sup = Supervisor(lambda mesh: Trainer(cfg, dc, tc, injector=inj,
                                          device="cpu"),
                     _TOTAL, cfg=ARCHS[_ARCH], workload=wl, n_devices=8,
                     injector=inj, backoff=_fast_backoff(),
                     sleep=lambda s: None)
    hist = sup.run()
    assert len(sup.recoveries) == 1
    rec = sup.recoveries[0]
    assert rec.cause == "device_loss" and rec.action == "replan"
    assert rec.mttr_s > 0 and sup.mttr_s() == rec.mttr_s
    # power-of-two survivor fallback: 8 - 1 lost -> best mesh over 4
    assert sup.n_devices == 7
    assert int(np.prod(list(sup.mesh.shape.values()))) == 4
    assert sup.steps_run <= _TOTAL + tc.ckpt_every
    _assert_history(hist, unsupervised, REPLAY_RTOL, 1e-4)
    _assert_history(hist, start[1], JAX_RTOL, 1e-3)


def test_empty_plan_supervised_run_is_identical(tmp_path, start,
                                                unsupervised):
    ck = _ckpt_from(start, tmp_path, "clean")
    cfg, dc, tc = _cfgs(ck)
    inj = FaultInjector(FaultPlan(), ckpt_dir=ck)
    sup = Supervisor(lambda mesh: Trainer(cfg, dc, tc, injector=inj,
                                          device="cpu"),
                     _TOTAL, injector=inj, sleep=lambda s: None)
    hist = sup.run()
    assert sup.recoveries == [] and sup.steps_run == _TOTAL
    assert inj.injected == []
    assert [(h["step"], h["loss"], h["grad_norm"], h["lr"])
            for h in hist] == \
        [(h["step"], h["loss"], h["grad_norm"], h["lr"])
         for h in unsupervised]


def test_corrupt_checkpoint_resume_falls_back_one_save(tmp_path, start,
                                                       unsupervised):
    """The newest checkpoint corrupted and a device lost at the same step:
    the rebuild quarantines step 10 and resumes from step 5, and the
    history still equals the fault-free one."""
    ck = _ckpt_from(start, tmp_path, "ckpt-chaos")
    cfg, dc, tc = _cfgs(ck)
    plan = FaultPlan(faults=(Fault("corrupt_checkpoint", 12,
                                   mode="garbage"),
                             Fault("device_loss", 12)), seed=4)
    inj = FaultInjector(plan, ckpt_dir=ck)
    sup = Supervisor(lambda mesh: Trainer(cfg, dc, tc, injector=inj,
                                          device="cpu"),
                     _TOTAL, injector=inj, backoff=_fast_backoff(),
                     sleep=lambda s: None)
    hist = sup.run()
    assert len(sup.recoveries) == 1
    assert os.path.isdir(os.path.join(ck, "quarantine", "step_00000010"))
    assert sup.steps_run == 12 + (_TOTAL - 5)
    _assert_history(hist, unsupervised, REPLAY_RTOL, 1e-4)


def test_old_trainer_is_released_before_the_rebuild(tmp_path, start,
                                                    unsupervised):
    """The port's deviation: when the factory runs again, the dead trainer
    (parameters, optimizer state, the frames of the step that raised) is
    gone; the history is unchanged by it."""
    ck = _ckpt_from(start, tmp_path, "release")
    cfg, dc, tc = _cfgs(ck)
    inj = FaultInjector(FaultPlan(faults=(Fault("device_loss", 7),
                                          Fault("device_loss", 11))),
                        ckpt_dir=ck)
    built, alive_at_build = [], []

    def factory(mesh):
        alive_at_build.append([r() is not None for r in built])
        t = Trainer(cfg, dc, tc, injector=inj, device="cpu")
        built.append(weakref.ref(t))
        built.append(weakref.ref(t.state.params))
        return t

    sup = Supervisor(factory, _TOTAL, injector=inj,
                     backoff=_fast_backoff(), sleep=lambda s: None)
    hist = sup.run()
    assert len(sup.recoveries) == 2
    assert alive_at_build == [[], [False, False], [False] * 4]
    _assert_history(hist, unsupervised, REPLAY_RTOL, 1e-4)


def test_recovery_budget_bounds_runaway(tmp_path, start):
    ck = _ckpt_from(start, tmp_path, "budget")
    cfg, dc, tc = _cfgs(ck)

    class AlwaysLoses:
        """Injector stub whose every segment dies at its first step."""
        def step_begin(self, step):
            raise DeviceLossError(1, step)

    sup = Supervisor(
        lambda mesh: Trainer(cfg, dc, tc, injector=AlwaysLoses(),
                             device="cpu"),
        _TOTAL, backoff=_fast_backoff(), max_recoveries=2,
        sleep=lambda s: None)
    with pytest.raises(RuntimeError, match="recovery budget"):
        sup.run()
    assert len(sup.recoveries) == 2


def test_supervisor_report_line(tmp_path, start, capsys):
    ck = _ckpt_from(start, tmp_path, "report")
    cfg, dc, tc = _cfgs(ck)
    inj = FaultInjector(FaultPlan(faults=(Fault("device_loss", 3),
                                          Fault("slowdown", 1))),
                        ckpt_dir=ck)
    tc.total_steps = 5
    sup = Supervisor(lambda mesh: Trainer(cfg, dc, tc, injector=inj,
                                          device="cpu"),
                     5, injector=inj, backoff=_fast_backoff(),
                     sleep=lambda s: None)
    sup.run()
    line = sup.report(printer=lambda s: None)
    assert line.startswith("[supervisor] steps=5 steps_run=")
    assert "recoveries=1" in line and \
        "faults=device_loss:1,slowdown:1" in line
    assert "cause=device_loss action=keep" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# serving degradation
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def serve_setup():
    from repro.models import transformer as jtransformer
    from repro_torch.models import transformer
    cfg = ARCHS[_ARCH].reduced()
    jcfg = JARCHS[_ARCH].reduced()
    params, _ = jtransformer.init_params(jcfg, jax.random.PRNGKey(0))
    model = transformer.init_params(cfg, device="cpu", seed=0)
    model.load_state_dict(params_from_reference(
        cfg, jax.tree.map(np.asarray, params)))
    return cfg, model, jcfg, params


def _submit(server, cfg, n, max_new=8, request=None):
    from repro_torch.runtime.server import Request
    request = request or Request
    rng = np.random.default_rng(0)
    for rid in range(n):
        prompt = rng.integers(2, cfg.vocab_size, size=6).astype(np.int32)
        server.submit(request(rid=rid, prompt=prompt, max_new=max_new))


def _served(cfg, model, plan, policy, n=6, slots=2):
    from repro_torch.runtime.server import DecodeServer
    inj = FaultInjector(plan)
    srv = DecodeServer(cfg, model, slots=slots, max_len=128, seed=0,
                       injector=inj, eos_id=-1, device="cpu")
    _submit(srv, cfg, n)
    sup = ServingSupervisor(srv, policy, injector=inj)
    return sup, sup.run(max_iters=500)


def _served_reference(jcfg, params, plan, policy, n=6, slots=2):
    from repro.runtime.server import DecodeServer, Request
    inj = jfaults.FaultInjector(jfaults.FaultPlan.from_json_dict(
        plan.to_json_dict()))
    srv = DecodeServer(jcfg, params, slots=slots, max_len=128, seed=0,
                       injector=inj, eos_id=-1)
    _submit(srv, jcfg, n, request=Request)
    pol = jsup.ServingPolicy(**{k: getattr(policy, k) for k in (
        "watchdog_k", "warmup_iters", "max_queue", "throttle_iters",
        "retry_after_s")})
    sup = jsup.ServingSupervisor(srv, pol, injector=inj)
    return sup, sup.run(max_iters=500)


def test_serving_evicts_sheds_and_completes(serve_setup):
    cfg, model, _, _ = serve_setup
    # a long, enormous slowdown window: consecutive watchdog breaches
    # must evict, throttle, and still finish every non-shed request
    plan = FaultPlan(faults=(Fault("slowdown", 3, factor=1e5,
                                   duration=40),))
    sup, done = _served(cfg, model, plan,
                        ServingPolicy(watchdog_k=4.0, max_queue=3))
    assert sup.evictions >= 1 and len(sup.shed) >= 1
    for r in sup.shed:
        assert r.shed and r.retry_after_s == 1.0
    assert all(len(r.out) == 8 and not r.shed for r in done)
    assert len(done) + len(sup.shed) == 6


def test_serving_device_loss_equals_the_reference(serve_setup):
    """A device loss evicts every occupied slot; both packages shed the
    same requests past ``max_queue``, evict the same slots at the same
    iteration, complete the same requests with their full budgets and
    keep every evicted request's generated prefix (the watchdog is held
    open, so the decisions do not depend on this machine's timings)."""
    cfg, model, jcfg, params = serve_setup
    plan = FaultPlan(faults=(Fault("device_loss", 4),))
    policy = ServingPolicy(watchdog_k=1e9, max_queue=4)
    sup, done = _served(cfg, model, plan, policy)
    jsup_, jdone = _served_reference(jcfg, params, plan, policy)
    assert sup.evictions == jsup_.evictions == 2
    assert [r.rid for r in sup.shed] == [r.rid for r in jsup_.shed]
    assert sorted(r.rid for r in done) == sorted(r.rid for r in jdone)
    assert sorted((r.rid, r.evictions) for r in done) == \
        sorted((r.rid, r.evictions) for r in jdone)
    assert all(len(r.out) == 8 for r in done)
    assert sup._iters == jsup_._iters
    assert sup.report(printer=lambda s: None) == \
        jsup_.report(printer=lambda s: None)


def test_serving_clean_run_no_degradation(serve_setup):
    cfg, model, _, _ = serve_setup
    sup, done = _served(cfg, model, FaultPlan(),
                        ServingPolicy(watchdog_k=50.0), n=4)
    assert len(done) == 4 and sup.evictions == 0 and sup.shed == []


def test_evicted_request_resumes_from_prefix(serve_setup):
    from repro_torch.runtime.server import DecodeServer, Request
    cfg, model, _, _ = serve_setup
    srv = DecodeServer(cfg, model, slots=1, max_len=128, seed=0,
                       device="cpu")
    req = Request(rid=0, prompt=np.asarray([5, 6, 7], np.int32), max_new=6)
    srv.submit(req)
    srv._refill()
    srv.step()
    srv.step()
    produced = list(req.out)
    assert len(produced) == 2
    assert srv.evict_slot(0) is req and req.evictions == 1
    assert srv.queue[0] is req and srv.active[0] is None
    srv._refill()                      # re-admit: prefix is replayed
    assert srv.remaining[0] == 4       # owes only the missing tokens
    while not req.done:
        srv.step()
    assert req.out[:2] == produced and len(req.out) <= 6


# ---------------------------------------------------------------------------
# The train launcher's chaos target: the reference's and the port's CLI
# ---------------------------------------------------------------------------

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: a few steps of reduced smollm-360m: the registry corrupted at step 2,
#: then a device lost at step 3, so the replan reads the registry after the
#: corruption
_CHAOS_ARGV = ["--arch", "smollm-360m", "--reduced", "--steps", "4",
               "--batch", "2", "--seq", "32", "--ckpt-every", "2",
               "--devices", "8",
               "--fault-plan", "corrupt_registry@2;device_loss@3"]


def _chaos_cli(tmp_path, name, module, extra):
    """One run of ``module``'s training CLI with ``_CHAOS_ARGV``, its
    registry a temporary directory holding a fitted-looking ``gpu-h100``
    model; returns (stdout, the registry directory, the model file's bytes
    before the run)."""
    import subprocess
    import sys
    reg = tmp_path / f"{name}-reg"
    path = registry.save_model(_chaos_model("gpu-h100"), str(reg))
    with open(path, "rb") as f:
        before = f.read()
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               REPRO_MODEL_REGISTRY=str(reg),
               REPRO_COMPILE_CACHE=str(tmp_path / f"{name}-cc"))
    p = subprocess.run(
        [sys.executable, "-m", *module, *_CHAOS_ARGV, "--ckpt",
         str(tmp_path / f"{name}-ck"), *extra],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=600)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-3000:]
    return p.stdout, reg, path, before


def _fault_lines(text, kind):
    return [l for l in text.splitlines()
            if l.startswith("[faults]") and f"kind={kind}" in l]


def test_train_cli_without_model_leaves_the_registry_alone(tmp_path):
    """Without ``--model`` a ``corrupt_registry`` fault has no target: the
    reference's launcher records ``<no registry device wired>`` and touches
    nothing, and so does the port's, although its replan still prices
    through ``gpu-h100`` (whose file it reads, intact)."""
    ref, _, ref_path, ref_before = _chaos_cli(
        tmp_path, "ref", ["repro.launch.train"], [])
    port, _, path, before = _chaos_cli(
        tmp_path, "port", ["repro_torch.launch", "train"],
        ["--device", "cpu"])
    with open(ref_path, "rb") as f:
        assert f.read() == ref_before
    with open(path, "rb") as f:
        assert f.read() == before
    assert not os.path.exists(path + ".corrupt")
    want = ["[faults] step=2 kind=corrupt_registry "
            "detail=<no registry device wired>"]
    assert _fault_lines(ref, "corrupt_registry") == want
    assert _fault_lines(port, "corrupt_registry") == want
    assert "action=fallback" not in port
    for text in (ref, port):
        assert "cause=device_loss action=replan" in text
        assert "recoveries=1" in text


def test_train_cli_with_model_corrupts_and_falls_back(tmp_path):
    """With ``--model gpu-h100`` the fault lands on that model's file; the
    replan after the device loss quarantines it and falls back."""
    port, reg, path, before = _chaos_cli(
        tmp_path, "port", ["repro_torch.launch", "train"],
        ["--device", "cpu", "--model", "gpu-h100"])
    assert _fault_lines(port, "corrupt_registry") == [
        f"[faults] step=2 kind=corrupt_registry detail={path}"]
    with open(path + ".corrupt", "rb") as f:
        assert f.read() != before
    assert any(l.startswith("[registry]") and "device=gpu-h100" in l
               and "action=fallback" in l for l in port.splitlines())
    assert "cause=device_loss action=replan" in port
    assert "recoveries=1" in port
