"""The fleet allocator and its supervisor of the port against the JAX
package, on the CPU (mirrors ``tests/test_fleet.py``).

``launch/fleet.py`` and ``runtime/fleet_supervisor.py`` are copies of the
reference's.  Priced on the reference's kernel composition
(``kernels=PALLAS_KERNELS``) the port's allocations and placement
histories under pool churn equal the reference's byte for byte; on the
card's kernels (the default) they are deterministic run to run.  A
``TrainerJobRunner`` migrated mid-interval replays to the fault-free
history at rtol 1e-5, and ``python -m repro_torch.launch`` dispatches.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.launch import fleet as jfleet
from repro.runtime import faults as jfaults
from repro.runtime import fleet_supervisor as jfs
from repro_torch.calibration import registry, seeds
from repro_torch.configs.registry import ARCHS
from repro_torch.core.kernelmodel import PALLAS_KERNELS
from repro_torch.core.model import LinearCostModel
from repro_torch.core.workload import WorkloadSpec
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import fleet as tfleet
from repro_torch.launch.__main__ import main as launch_main
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime import fleet_supervisor as tfs
from repro_torch.runtime.faults import (Fault, FaultInjector, FaultPlan,
                                        corrupt_file)
from repro_torch.runtime.fleet_supervisor import (FleetSupervisor,
                                                  TrainerJobRunner)
from repro_torch.runtime.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
P = PALLAS_KERNELS
_ARCH = "smollm-360m"


@pytest.fixture(autouse=True)
def _isolated_registry(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_MODEL_REGISTRY", str(tmp_path / "ambient-reg"))


def _job(name, pri, lo, hi, **kw):
    return {"name": name, "arch": _ARCH, "phase": "train", "global_batch": 8,
            "seq_len": 128, "priority": pri, "min_devices": lo,
            "max_devices": hi, **kw}


#: manifests as JSON dicts (each package builds its own objects), with the
#: churn each is run under: the demo's, the ladder cases of the reference's
#: tests (pause and resume, shrink a lower priority, hysteresis, rebalance)
CASES = {
    "demo-shrink": (None, "pool_shrink@5:pool=a100,k=2", 12),
    "demo-shrink-grow": (None, "pool_shrink@3:pool=a100,k=2;"
                               "pool_grow@8:pool=a100,k=2", 12),
    "demo-loss": (None, "device_loss@4:pool=v5e,count=6;"
                        "pool_grow@9:pool=v5e,k=8", 12),
    "pause-resume": ({"pools": [{"name": "a", "device": "gpu-a100",
                                 "count": 8}],
                      "jobs": [_job("hi", 10, 4, 4), _job("lo", 1, 4, 4)]},
                     "pool_shrink@2:pool=a,k=4;pool_grow@6:pool=a,k=4", 10),
    "shrink-lower": ({"pools": [{"name": "a", "device": "gpu-a100",
                                 "count": 8},
                                {"name": "b", "device": "tpu-v5e",
                                 "count": 4}],
                      "jobs": [_job("hi", 10, 4, 4), _job("mid", 8, 2, 4),
                               _job("lo", 1, 2, 4)]},
                     "pool_shrink@2:pool=a,k=4", 6),
    "rebalance": ({"pools": [{"name": "slow", "device": "tpu-v5e",
                              "count": 4},
                             {"name": "fast", "device": "gpu-h100",
                              "count": 0}],
                   "jobs": [_job("j", 5, 2, 4)]},
                  "pool_grow@2:pool=fast,k=4;pool_grow@3:pool=fast,k=4", 6),
}


def _manifests(d):
    if d is None:
        return tfleet.demo_manifest(), jfleet.demo_manifest()
    return (tfleet.Manifest.from_json_dict(d),
            jfleet.Manifest.from_json_dict(d))


def _run(mod, fsmod, faultmod, manifest, spec, seed, steps, **kw):
    allocator = mod.FleetAllocator(manifest, **kw)
    fplan = faultmod.FaultPlan.parse(spec, seed=seed) if spec \
        else faultmod.FaultPlan(seed=seed)
    sup = fsmod.FleetSupervisor(allocator,
                                injector=faultmod.FaultInjector(fplan),
                                runner_factory=fsmod.SimJobRunner.factory())
    sup.run(steps)
    return sup


def _port(manifest, spec, seed=7, steps=12, kernels=P):
    return _run(tfleet, tfs, tfaults, manifest, spec, seed, steps,
                kernels=kernels)


def _reference(manifest, spec, seed=7, steps=12):
    return _run(jfleet, jfs, jfaults, manifest, spec, seed, steps)


# ---------------------------------------------------------------------------
# grammar and the fleet hook
# ---------------------------------------------------------------------------


def test_pool_fault_grammar_and_roundtrip(tmp_path):
    spec = ("pool_shrink@5:pool=a100,k=2;pool_grow@9:pool=v5e,count=4;"
            "device_loss@7:pool=h100")
    p = FaultPlan.parse(spec, seed=7)
    shrink, loss, grow = p.faults
    assert (shrink.kind, shrink.step, shrink.pool, shrink.count) == \
        ("pool_shrink", 5, "a100", 2)          # k= aliases count=
    assert (grow.kind, grow.pool, grow.count) == ("pool_grow", "v5e", 4)
    assert loss.fleet_scoped and shrink.fleet_scoped and grow.fleet_scoped
    assert not Fault("device_loss", 7).fleet_scoped
    assert p.to_json_dict() == \
        jfaults.FaultPlan.parse(spec, seed=7).to_json_dict()
    path = str(tmp_path / "plan.json")
    p.save(path)
    assert FaultPlan.load(path) == p


def test_fleet_events_one_shot_and_trainer_isolation():
    spec = ("pool_shrink@3:pool=a100,k=2;device_loss@3:pool=a100;"
            "device_loss@5")
    t = FaultInjector(FaultPlan.parse(spec, seed=0))
    j = jfaults.FaultInjector(jfaults.FaultPlan.parse(spec, seed=0))
    t.step_begin(3)       # fleet-scoped churn never raises from this hook
    j.step_begin(3)
    assert [f.to_json_dict() for f in t.fleet_events(3)] == \
        [f.to_json_dict() for f in j.fleet_events(3)]
    assert t.fleet_events(3) == []              # one-shot
    from repro_torch.runtime.faults import DeviceLossError
    with pytest.raises(DeviceLossError):
        t.step_begin(5)
    with pytest.raises(jfaults.DeviceLossError):
        j.step_begin(5)
    assert t.fleet_events(5) == []
    assert [(r.step, r.kind, r.detail) for r in t.injected] == \
        [(r.step, r.kind, r.detail) for r in j.injected]


def test_load_models_batch_degrades_only_corrupt_pool(tmp_path, capsys):
    d = str(tmp_path)
    m = seeds.ANALYTIC_SEEDS["gpu-a100"]()
    registry.save_model(LinearCostModel(
        keys=list(m.keys), weights=m.weights.copy(), device="gpu-a100",
        meta={}), d)
    corrupt_file(registry._model_path(d, "gpu-a100"), mode="truncate")
    models = registry.load_models(["gpu-a100", "tpu-v5e", "gpu-a100"], d)
    assert set(models) == {"gpu-a100", "tpu-v5e"}
    assert models["gpu-a100"].meta.get("source") == "datasheet-seed"
    rollups = [l for l in capsys.readouterr().out.splitlines()
               if l.startswith("[registry]") and "fallbacks=" in l]
    assert len(rollups) == 1 and "gpu-a100:seed" in rollups[0]
    with pytest.raises(registry.UnknownDeviceError):
        registry.load_models(["gpu-a100", "mystery-chip"], d)


# ---------------------------------------------------------------------------
# the allocator and the ladder, byte for byte against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["demo-shrink", "pause-resume",
                                  "shrink-lower", "rebalance"])
def test_allocation_equals_the_reference(case):
    t, j = _manifests(CASES[case][0])
    a = tfleet.FleetAllocator(t, kernels=P).allocate()
    b = jfleet.FleetAllocator(j).allocate()
    assert json.dumps(a.to_json_dict(), sort_keys=True) == \
        json.dumps(b.to_json_dict(), sort_keys=True)
    assert t.to_json_dict() == j.to_json_dict()


@pytest.mark.parametrize("case", sorted(CASES))
def test_placement_history_equals_the_reference_byte_for_byte(case):
    d, spec, steps = CASES[case]
    t, j = _manifests(d)
    got = _port(t, spec, steps=steps)
    want = _reference(j, spec, steps=steps)
    assert got.history_json().encode() == want.history_json().encode()
    assert got.actions == want.actions
    for name in got.runners:
        assert got.runners[name].history == want.runners[name].history


def test_placement_history_on_the_cards_kernels_is_deterministic():
    spec = CASES["demo-shrink-grow"][1]
    s1 = _port(tfleet.demo_manifest(), spec, kernels=None)
    s2 = _port(tfleet.demo_manifest(), spec, kernels=None)
    assert s1.history_json().encode() == s2.history_json().encode()
    assert len(s1.assignment.placements) == 3


def test_empty_fleet_plan_identical_to_bare_allocator():
    bare = tfleet.FleetAllocator(tfleet.demo_manifest(),
                                 kernels=P).allocate()
    sup = _port(tfleet.demo_manifest(), None)
    assert sup.assignment.to_json_dict() == bare.to_json_dict()
    assert sup.actions == {} and len(sup.placement_history) == 2
    for name, p in bare.placements.items():
        hist = sup.runners[name].history
        assert len(hist) == 12 and all(
            h["pool"] == p.pool and h["devices"] == p.devices for h in hist)


def test_ladder_outcomes():
    sup = _port(tfleet.demo_manifest(), CASES["demo-shrink"][1])
    assert len(sup.assignment.placements) == 3 and not sup.assignment.paused
    assert sup.actions.get("migrate", 0) >= 1
    assert sup.used("a100") <= sup.capacity["a100"] == 6
    t, _ = _manifests(CASES["pause-resume"][0])
    sup = _port(t, CASES["pause-resume"][1], steps=10)
    assert sup.actions.get("pause") == 1 and sup.actions.get("resume") == 1
    t, _ = _manifests(CASES["rebalance"][0])
    sup = _port(t, CASES["rebalance"][1], steps=6)
    assert sup.actions.get("rebalance", 0) == 1
    assert sup.assignment.placements["j"].pool == "fast"


def test_manifest_json_roundtrip(tmp_path):
    m = tfleet.demo_manifest()
    path = str(tmp_path / "manifest.json")
    with open(path, "w") as f:
        json.dump(m.to_json_dict(), f)
    assert tfleet.load_manifest(path).to_json_dict() == m.to_json_dict()
    assert jfleet.load_manifest(path).to_json_dict() == m.to_json_dict()
    with pytest.raises(ValueError):
        tfleet.Manifest(pools=[tfleet.PoolSpec("a", "gpu-a100", 2),
                               tfleet.PoolSpec("a", "tpu-v5e", 2)], jobs=[])


# ---------------------------------------------------------------------------
# migration resume of a real (reduced) trainer
# ---------------------------------------------------------------------------

_TOTAL = 14


def _trainer_cfgs(ckpt_dir):
    cfg = ARCHS[_ARCH].reduced()
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4,
                    seed=5)
    tc = TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=5,
                       total_steps=_TOTAL, seed=0, log_every=1000,
                       save_on_exit=False)
    return cfg, dc, tc


def test_migration_resume_matches_fault_free_history(tmp_path):
    cfg, dc, tc = _trainer_cfgs(str(tmp_path / "ref-ckpt"))
    reference = Trainer(cfg, dc, tc, device="cpu").train(_TOTAL)

    job = tfleet.JobSpec(name="j", arch=_ARCH,
                         workload=WorkloadSpec(phase="train",
                                               global_batch=4, seq_len=64,
                                               name="j"),
                         priority=5, min_devices=2, max_devices=2)
    m = tfleet.Manifest(pools=[tfleet.PoolSpec("a100", "gpu-a100", 2),
                               tfleet.PoolSpec("v5e", "tpu-v5e", 2)],
                        jobs=[job])
    allocator = tfleet.FleetAllocator(m)
    assignment = allocator.allocate()
    home = assignment.placements["j"].pool
    fcfg, fdc, ftc = _trainer_cfgs(str(tmp_path / "fleet-ckpt"))
    built = []

    def trainer_factory(job_spec, placement):
        built.append(placement.pool)
        return Trainer(fcfg, fdc, ftc, device="cpu")

    sup = FleetSupervisor(
        allocator, assignment=assignment,
        injector=FaultInjector(FaultPlan.parse(
            f"pool_shrink@9:pool={home},k=2", seed=7)),
        runner_factory=TrainerJobRunner.factory(trainer_factory,
                                                target=_TOTAL))
    sup.run(_TOTAL)
    assert sup.actions.get("migrate") == 1
    other = {"a100": "v5e", "v5e": "a100"}[home]
    assert built == [home, other]
    assert sup.assignment.placements["j"].pool == other
    runner = sup.runners["j"]
    assert runner.done and int(runner.trainer.step) >= _TOTAL
    hist = runner.history
    assert [h["step"] for h in hist] == [h["step"] for h in reference]
    for h, r in zip(hist, reference):
        np.testing.assert_allclose(h["loss"], r["loss"], rtol=1e-5)
        np.testing.assert_allclose(h["grad_norm"], r["grad_norm"],
                                   rtol=1e-4)


# ---------------------------------------------------------------------------
# the dispatcher
# ---------------------------------------------------------------------------


def test_launch_fleet_cli_smoke(tmp_path, capsys):
    hist = str(tmp_path / "hist.json")
    launch_main(["fleet", "--steps", "8",
                 "--fault-plan", "pool_shrink@2:pool=a100,k=2",
                 "--chaos-seed", "7", "--history-json", hist])
    out = capsys.readouterr().out
    for word in ("[fleet]", "replanned", "migrated", "run complete"):
        assert word in out
    entries = json.loads(open(hist).read())
    assert [e["event"] for e in entries] == \
        ["allocate", "pool_shrink:a100", "final"]


def test_launch_dispatch_rejects_unknown_and_names_what_waits(monkeypatch):
    with pytest.raises(SystemExit):
        launch_main(["frobnicate"])
    with pytest.raises(SystemExit):
        launch_main([])
    # no command waits any more: dryrun reaches launch/dryrun.py's main
    # (stubbed here: a real dry run makes this process's default group a
    # fake world; tests/test_torch_dryrun.py runs it in a process of its
    # own)
    import importlib
    seen = []
    mod = importlib.import_module("repro_torch.launch.dryrun")
    monkeypatch.setattr(mod, "main", lambda argv=None: seen.append(argv))
    launch_main(["dryrun", "--arch", "glm4-9b"])
    assert seen == [["--arch", "glm4-9b"]]


@pytest.mark.parametrize("cmd", ["train", "serve", "autoshard"])
def test_launch_dispatches_each_command(cmd, monkeypatch):
    """Each command reaches its module's ``main`` with the rest of the
    arguments."""
    import importlib
    seen = []
    mod = importlib.import_module(f"repro_torch.launch.{cmd}")
    monkeypatch.setattr(mod, "main", lambda argv=None: seen.append(argv))
    launch_main([cmd, "--arch", "glm4-9b", "--x"])
    assert seen == [["--arch", "glm4-9b", "--x"]]


def test_python_m_launch_runs_train_and_serve_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               REPRO_COMPILE_CACHE=str(tmp_path / "cc"))
    train = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch", "train", "--arch",
         _ARCH, "--reduced", "--device", "cpu", "--steps", "4", "--batch",
         "2", "--seq", "32", "--ckpt", str(tmp_path / "ck"), "--ckpt-every",
         "2", "--online-calibrate", "--fault-plan",
         "device_loss@3;slowdown@1", "--calib-device", "cli"],
        capture_output=True, text=True, env=env, timeout=300)
    assert train.returncode == 0, train.stderr[-2000:]
    assert "[supervisor] steps=4" in train.stdout
    assert "recoveries=1" in train.stdout
    assert "[calib] refit report:" in train.stdout
    serve = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch", "serve", "--arch",
         _ARCH, "--reduced", "--device", "cpu", "--requests", "5",
         "--slots", "2", "--max-len", "160", "--max-new", "4",
         "--fault-plan", "device_loss@3", "--max-queue", "3"],
        capture_output=True, text=True, env=env, timeout=300)
    assert serve.returncode == 0, serve.stderr[-2000:]
    assert "[supervisor] action=shed n=2" in serve.stdout
    assert "evictions=2 shed=2" in serve.stdout
    assert "[serve] 3 requests" in serve.stdout
