"""The port's examples (``src/repro_torch/examples/``) on the CPU, each
with its own assertions at reduced steps, and against the reference's
``examples/`` where the two compute the same thing: ``fleet_churn``'s
placement history under the reference's step composition
(``PALLAS_KERNELS``), ``autoshard_search``'s rankings, load-balance picks
and elastic mesh under ``tpu-v5e`` + ``PALLAS_KERNELS`` at the v5e's HBM
budget.  What the reference's example computed is recorded by wrapping
the calls it makes; times are not compared.
"""
from __future__ import annotations

import dataclasses
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from examples import autoshard_search as jautoshard_ex   # noqa: E402
from examples import fleet_churn as jchurn               # noqa: E402
from repro_torch.core.kernelmodel import PALLAS_KERNELS as P  # noqa: E402
from repro_torch.examples import (autoshard_search, fault_tolerance,  # noqa
                                  fleet_churn, kernel_autotune,
                                  quickstart, serve_decode, train_smollm)

torch.set_num_threads(1)

ON_DEVICE = [quickstart, kernel_autotune, serve_decode, train_smollm,
             fault_tolerance]


@pytest.fixture(autouse=True)
def _isolated_registry(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("REPRO_MODEL_REGISTRY", str(tmp_path / "registry"))


@pytest.mark.parametrize("ex", ON_DEVICE,
                         ids=[m.__name__.rsplit(".", 1)[1]
                              for m in ON_DEVICE])
def test_example_runs_on_the_card_by_default(ex):
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex.main([])


def test_train_smollm_loss_falls_and_resumes_at_the_saved_step(tmp_path):
    ck = str(tmp_path / "ck")
    common = ["--device", "cpu", "--batch", "2", "--seq", "32", "--ckpt", ck]
    first = train_smollm.main(common + ["--steps", "12"])
    assert first["arch"] == "smollm-100m" and first["start"] == 0
    assert first["end"] == 12
    assert first["last_loss"] < first["first_loss"]
    again = train_smollm.main(common + ["--steps", "16", "--resume"])
    assert again["start"] == 12 and again["end"] == 16


def test_fault_tolerance_replays_and_recovers(tmp_path):
    res = fault_tolerance.main(["--device", "cpu",
                                "--ckpt", str(tmp_path / "ck"),
                                "--chaos-ckpt", str(tmp_path / "chaos")])
    np.testing.assert_allclose(res["replayed"], res["losses"][20:25],
                               rtol=1e-5)
    np.testing.assert_allclose(res["supervised"], res["losses"], rtol=1e-5)
    assert len(res["losses"]) == 25
    assert res["survivors"] == 7 and res["recoveries"] == 1
    assert res["straggler_host"] == 3


def test_serve_decode_completes_with_model_admission(capsys):
    res = serve_decode.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert res["requests"] == 10 and res["tokens"] >= 10
    admits = [l for l in out.splitlines() if l.startswith("[admit]")]
    assert len(admits) == 10
    assert all("policy=model" in l for l in admits)
    assert "16x16 H100 (gpu-h100)" in out
    assert res["predicted_s"] > 0 and res["predicted_half_s"] > 0
    sim = res["simulated_mean_latency_s"]
    assert sim["model"] <= sim["fifo"]


def test_kernel_autotune_compiled_equals_interpreted_and_auto_is_plain():
    res = kernel_autotune.main(["--device", "cpu"])
    assert [s["kernel"] for s in res["sweeps"]] == \
        ["matmul", "flash_attention", "ssd_scan", "transpose"]
    for s in res["sweeps"]:
        assert s["candidates"] >= 1
        assert set(s["winners"]) == {"gpu-h100", "gpu-a100"}
        for w in s["winners"].values():
            assert 0 < w["seconds"] <= w["worst_seconds"]
    assert res["auto"]["max_abs_err"] <= 1e-3


def test_quickstart_subprocess_smoke(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               REPRO_MODEL_REGISTRY=str(tmp_path / "registry"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.quickstart",
         "--device", "cpu"], env=env, cwd=tmp_path, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "measuring 83 kernels" in out.stdout
    pred = float(re.search(r"predicted\s+([-\d.e+]+) ms", out.stdout)[1])
    assert math.isfinite(pred) and pred > 0
    rows = out.stdout.split("cost attribution:\n", 1)[1].strip().splitlines()
    assert len(rows) == 5 and all(r.strip().endswith("µs") for r in rows)
    assert not list(tmp_path.glob("*.json"))


def _wrap(mp, owner, name, log):
    real = getattr(owner, name)

    def wrapped(*a, **kw):
        out = real(*a, **kw)
        log.append(out)
        return out
    mp.setattr(owner, name, wrapped)


def test_fleet_churn_history_equals_the_reference(monkeypatch, capsys):
    sups = []
    real_run = jchurn.FleetSupervisor.run

    def run(self, *a, **kw):
        sups.append(self)
        return real_run(self, *a, **kw)
    monkeypatch.setattr(jchurn.FleetSupervisor, "run", run)
    jchurn.main()
    ref_out = capsys.readouterr().out
    res = fleet_churn.run(kernels=P)
    out = capsys.readouterr().out
    (sup,) = sups
    assert res["history_json"] == sup.history_json()
    assert res["actions"] == dict(sup.actions)
    assert res["events"] == [e["event"] for e in sup.placement_history]
    mask = lambda s: re.sub(r"repair_ms=[\d.]+", "repair_ms=", s)
    assert mask(out) == mask(ref_out)


def test_fleet_churn_on_the_cards_composition_is_deterministic(capsys):
    a, b = fleet_churn.main([]), fleet_churn.main([])
    assert a["history_json"] == b["history_json"]
    assert a["actions"] == {"migrate": 1, "rebalance": 1}


def test_autoshard_search_equals_the_reference(monkeypatch, capsys):
    searched, predicted, failed = [], [], []
    _wrap(monkeypatch, jautoshard_ex.autoshard, "search", searched)
    _wrap(monkeypatch, jautoshard_ex.predictor, "predict_step", predicted)
    _wrap(monkeypatch, jautoshard_ex.elastic, "on_failure", failed)
    jautoshard_ex.main()
    ref_out = capsys.readouterr().out
    res = autoshard_search.run(model="tpu-v5e", kernels=P, hbm_budget=16e9)
    capsys.readouterr()
    assert res["model"] == "tpu-v5e-analytic"
    want = [[(t, dataclasses.asdict(p), dict(m)) for t, p, m in r]
            for r in searched]
    got = list(res["search"].values()) + [res["sweep_1024"]]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert [x[1:] for x in g] == [x[1:] for x in w]
        np.testing.assert_allclose([x[0] for x in g], [x[0] for x in w],
                                   rtol=1e-9)
    # the load balancing: each queue entry priced on both pools, in order
    assert [b["pool"] for b in res["balance"]] == \
        re.findall(r"-> (pod-\w) \(finishes", ref_out)
    np.testing.assert_allclose(
        [t for b in res["balance"] for t in b["step_s"].values()],
        [p.seconds for p in predicted], rtol=1e-9)
    (opt,) = failed
    assert res["elastic"]["mesh"] == dict(opt.shape)
    assert res["elastic"]["predicted_step_s"] == pytest.approx(
        opt.predicted_step_s, rel=1e-9)


def test_autoshard_search_ranks_under_the_card_model():
    res = autoshard_search.main([])
    assert res["model"] == "gpu-h100"
    for ranked in list(res["search"].values()) + [res["sweep_1024"]]:
        assert ranked and all(t > 0 and math.isfinite(t)
                              for t, _, _ in ranked)
    assert res["elastic"]["mesh"]
