"""The port's cost-model core and calibration against the reference.

``fit_relative`` / ``fit_report`` / ``LinearCostModel`` on the same numpy
vectors and times give bit-equal results in both packages (the reference's
``tests/test_fit_model.py`` cases, run on both); the registry and its seeds
behave as the reference's (``tests/test_calibration.py``); a model file
written by either package loads in the other with identical predictions;
``calibrate`` runs end to end on the CPU at the tiny scale; the CLI lists
and shows models.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from repro.calibration import registry as jregistry
from repro.calibration import seeds as jseeds
from repro.core import fit as jfit
from repro.core import predictor as jpredictor
from repro.core.model import LinearCostModel as JModel
from repro_torch.calibration import (ANALYTIC_SEEDS, UnknownDeviceError,
                                     calibrate, list_models, load_model,
                                     resolve_model, save_model)
from repro_torch.calibration.__main__ import main as cli
from repro_torch.core import fit, measure, predictor
from repro_torch.core import properties as props
from repro_torch.core.model import (SCHEMA_VERSION, LinearCostModel,
                                    ModelSchemaError, geomean, relative_error)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _isolated_registry(tmp_path, monkeypatch):
    """Pin the default registry to an empty tmp dir so fitted models a
    developer registered in ./experiments/registry can't shadow the
    analytic seeds these tests compare against."""
    monkeypatch.setenv("REPRO_MODEL_REGISTRY", str(tmp_path / "ambient-reg"))


def _synthetic(n_kernels=40, n_props=6, seed=0, noise=0.0):
    rng = np.random.default_rng(seed)
    keys = [f"p{i}" for i in range(n_props)]
    true_w = rng.uniform(1e-9, 1e-6, n_props)
    pvs, times = [], []
    for _ in range(n_kernels):
        counts = rng.integers(0, 10 ** 6, n_props).astype(float)
        counts[rng.random(n_props) < 0.3] = 0.0
        t = float(counts @ true_w) + 1e-7
        t *= 1.0 + noise * rng.standard_normal()
        pvs.append(dict(zip(keys, counts)))
        times.append(max(t, 1e-9))
    return pvs, times, keys, true_w


def _awkward_model(cls=LinearCostModel):
    # weights chosen so decimal shortening would be observable
    w = np.array([1.0 / 3.0 * 1e-9, np.pi * 1e-12, -7.3e-11, 2.0 ** -40])
    return cls(keys=["a", "b", "c", "d"], weights=w, device="rt-test",
               meta={"note": "round-trip"})


# ---------------------------------------------------------------------------
# fit and model: bit-equal to the reference on the same inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"ridge": 1e-4}, {"nonneg": True},
                                {"ridge": 1e-2, "nonneg": True}],
                         ids=["plain", "ridge", "nonneg", "ridge_nonneg"])
@pytest.mark.parametrize("noise", [0.0, 0.05])
def test_fit_relative_and_report_bit_equal_to_reference(kw, noise):
    pvs, times, keys, _ = _synthetic(seed=3, noise=noise)
    m = fit.fit_relative(pvs, times, device="d", **kw)
    r = jfit.fit_relative(pvs, times, device="d", **kw)
    assert m.keys == r.keys and m.meta == r.meta
    assert np.array_equal(m.weights, r.weights)
    assert np.array_equal(m.predict_many(pvs), r.predict_many(pvs))
    labels = [f"k{i}" for i in range(len(pvs))]
    assert fit.fit_report(m, pvs, times, labels) == \
        jfit.fit_report(r, pvs, times, labels)
    assert fit.condition_report(pvs, times) == \
        jfit.condition_report(pvs, times)


def test_fit_recovers_exact_synthetic_weights():
    pvs, times, keys, true_w = _synthetic()
    m = fit.fit_relative(pvs, times, keys=keys)
    pred = m.predict_many(pvs)
    errs = [relative_error(p, t) for p, t in zip(pred, times)]
    assert geomean(errs) < 1e-3


def test_fit_is_relative_not_absolute():
    pvs = [{"a": 1.0}, {"a": 1.0, "b": 1.0}]
    times = [1e-6, 1e-3]
    m = fit.fit_relative(pvs, times)
    assert relative_error(m.predict(pvs[0]), times[0]) < 1e-6
    assert relative_error(m.predict(pvs[1]), times[1]) < 1e-6


def test_fit_allows_negative_weights():
    pvs = [{"a": 2.0, "b": 1.0}, {"a": 4.0, "b": 1.0}, {"a": 1.0}]
    times = [3e-6, 7e-6, 2e-6]  # implies b negative
    m = fit.fit_relative(pvs, times)
    assert dict(zip(m.keys, m.weights))["b"] < 0


def test_fit_nonneg_projects():
    pvs, times, keys, _ = _synthetic(seed=3)
    m = fit.fit_relative(pvs, times, keys=keys, nonneg=True)
    assert (m.weights >= 0).all()


def test_model_predict_is_inner_product_and_breakdown_sums():
    keys = ["x", "y", "z"]
    m = LinearCostModel(keys=keys, weights=np.array([1e-9, 2e-9, -1e-9]))
    pv = {"x": 10.0, "y": 5.0, "z": 3.0, "unknown": 99.0}
    expect = 10e-9 + 10e-9 - 3e-9
    assert m.predict(pv) == pytest.approx(expect)
    assert sum(m.breakdown(pv).values()) == pytest.approx(expect)
    r = JModel(keys=keys, weights=np.array([1e-9, 2e-9, -1e-9]))
    assert m.predict(pv) == r.predict(pv)
    assert m.breakdown(pv) == r.breakdown(pv)
    assert m.interpretation_report() == r.interpretation_report()


def test_finalize_adds_minls_and_const():
    pv = props.finalize({
        props.mem_key("load", 32, "s1"): 100.0,
        props.mem_key("store", 32, "s1"): 40.0,
        "zero": 0.0,
    })
    assert pv[props.minls_key(32)] == 40.0
    assert pv[props.CONST1] == 1.0
    assert "zero" not in pv


def test_condition_report_flags_collinearity():
    pvs = [{"a": float(i), "b": 2.0 * i} for i in range(1, 6)]
    rep = fit.condition_report(pvs, [1e-6 * i for i in range(1, 6)])
    assert rep["rank"] < rep["n_cols"]


# ---------------------------------------------------------------------------
# serialization, and model files shared between the packages
# ---------------------------------------------------------------------------


def test_roundtrip_predictions_bitwise_identical(tmp_path):
    m = _awkward_model()
    p = str(tmp_path / "m.json")
    m.save(p)
    m2 = LinearCostModel.load(p)
    assert m2.keys == m.keys and m2.device == m.device and m2.meta == m.meta
    assert np.array_equal(m2.weights, m.weights)  # bitwise, not approx
    pvs = [{"a": 3.0, "b": 1e6, "c": 7.0, "d": 2.0},
           {"a": 1.0}, {"b": 123.456, "d": 1e-3}]
    for pv in pvs:
        assert m2.predict(pv) == m.predict(pv)
    assert np.array_equal(m2.predict_many(pvs), m.predict_many(pvs))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_model_files_are_interchangeable(writer, tmp_path):
    pvs, times, _, _ = _synthetic(seed=5, noise=0.1)
    fitter = fit if writer == "port" else jfit
    model = fitter.fit_relative(pvs, times, device="shared", ridge=1e-4)
    (save_model if writer == "port" else jregistry.save_model)(
        model, str(tmp_path))
    with open(tmp_path / "shared.json") as f:
        d = json.load(f)
    assert d["schema"] == SCHEMA_VERSION and d["kind"] == "linear_cost_model"
    mine = load_model("shared", str(tmp_path))
    theirs = jregistry.load_model("shared", str(tmp_path))
    for m in (mine, theirs):
        assert m.keys == model.keys and m.meta == model.meta
        assert np.array_equal(m.weights, model.weights)
        assert np.array_equal(m.predict_many(pvs), model.predict_many(pvs))
        assert [m.predict(pv) for pv in pvs] == \
            [model.predict(pv) for pv in pvs]


def test_serialized_file_carries_schema_version(tmp_path):
    p = str(tmp_path / "m.json")
    _awkward_model().save(p)
    with open(p) as f:
        d = json.load(f)
    assert d["schema"] == SCHEMA_VERSION
    assert d["kind"] == "linear_cost_model"
    assert d == _awkward_model(JModel).to_json_dict()


def test_legacy_v0_file_still_loads(tmp_path):
    p = str(tmp_path / "legacy.json")
    with open(p, "w") as f:
        json.dump({"device": "old", "keys": ["x"], "weights": [1e-9],
                   "meta": {}}, f)
    m = LinearCostModel.load(p)
    assert m.device == "old" and m.predict({"x": 2.0}) == 2e-9


def test_future_schema_rejected(tmp_path):
    p = str(tmp_path / "future.json")
    with open(p, "w") as f:
        json.dump({"schema": SCHEMA_VERSION + 1, "kind": "linear_cost_model",
                   "keys": ["x"], "weights": [1.0]}, f)
    with pytest.raises(ModelSchemaError):
        LinearCostModel.load(p)


def test_mismatched_lengths_rejected():
    with pytest.raises(ModelSchemaError):
        LinearCostModel.from_json_dict(
            {"schema": 1, "kind": "linear_cost_model",
             "keys": ["x", "y"], "weights": [1.0]})


# ---------------------------------------------------------------------------
# registry and seeds
# ---------------------------------------------------------------------------


def test_registry_save_then_load(tmp_path):
    m = _awkward_model()
    path = save_model(m, str(tmp_path))
    assert os.path.exists(path)
    m2 = load_model("rt-test", str(tmp_path))
    assert np.array_equal(m2.weights, m.weights)
    assert list_models(str(tmp_path))["rt-test"] == "fitted"


def test_registry_unknown_device_error_lists_available(tmp_path):
    with pytest.raises(UnknownDeviceError) as ei:
        load_model("no-such-device", str(tmp_path))
    msg = str(ei.value)
    assert "no-such-device" in msg and "tpu-v5e" in msg
    assert isinstance(ei.value, KeyError)


def test_registry_analytic_seeds_cover_cross_vendor(tmp_path):
    names = set(list_models(str(tmp_path)))
    assert {"tpu-v5e", "gpu-a100", "gpu-h100", "gpu-mi300x"} <= names
    vendors = {load_model(n, str(tmp_path)).meta.get("vendor")
               for n in ("gpu-a100", "gpu-mi300x")}
    assert vendors == {"nvidia", "amd"}


def test_registry_v5e_seed_matches_predictor_seed(tmp_path):
    reg = load_model("tpu-v5e", str(tmp_path))
    ref = predictor.tpu_v5e_weights()
    assert reg.keys == ref.keys
    assert np.array_equal(reg.weights, ref.weights)


def test_registry_fitted_model_shadows_analytic_seed(tmp_path):
    custom = LinearCostModel(keys=["const1"], weights=np.array([1.0]),
                             device="gpu-a100")
    save_model(custom, str(tmp_path))
    assert load_model("gpu-a100", str(tmp_path)).keys == ["const1"]
    assert list_models(str(tmp_path))["gpu-a100"] == "fitted"


def test_analytic_seeds_price_full_taxonomy():
    for name, build in ANALYTIC_SEEDS.items():
        m = build()
        have = set(m.keys)
        assert props.CONST1 in have and props.BARRIER in have, name
        assert props.mxu_key(16) in have, name
        assert props.mem_key("load", 32, "s1") in have, name
        assert props.coll_key("all_reduce") in have, name


def test_analytic_seeds_equal_the_reference_seeds():
    assert list(ANALYTIC_SEEDS) == list(jseeds.ANALYTIC_SEEDS)
    for name, build in ANALYTIC_SEEDS.items():
        m, r = build(), jseeds.ANALYTIC_SEEDS[name]()
        assert m.keys == r.keys and m.device == r.device and m.meta == r.meta
        assert np.array_equal(m.weights, r.weights)
    v5e = predictor.tpu_v5e_weights()
    assert np.array_equal(v5e.weights, jpredictor.tpu_v5e_weights().weights)


def test_resolve_model_forms(tmp_path):
    m = _awkward_model()
    assert resolve_model(m) is m
    by_name = resolve_model("gpu-h100", registry_dir=str(tmp_path))
    assert by_name.device == "gpu-h100"
    default = resolve_model(None, registry_dir=str(tmp_path))
    assert default.device == predictor.tpu_v5e_weights().device
    assert predictor.resolve_model(None) is default
    with pytest.raises(TypeError):
        resolve_model(42)


def test_time_kernel_follows_the_papers_protocol():
    """Two warm-up calls, then ``runs`` samples of which the first ``drop``
    are discarded and the minimum is kept; inner repeats fill a floor."""
    calls = []

    def fn():
        calls.append(1)
        return (torch.zeros(()), [torch.ones(2)])
    tr = measure.time_kernel(fn, runs=7, drop=3)
    assert len(tr.runs) == 7 and len(calls) == 2 + 7
    assert tr.min_s == min(tr.runs[3:])
    assert tr.mean_s == pytest.approx(sum(tr.runs[3:]) / 4)
    calls.clear()
    tr = measure.time_kernel(fn, runs=5, drop=1, min_time_s=1.0)
    assert len(calls) > 2 + 5  # repeated inside each sample
    assert measure.measure_launch_overhead(runs=5, drop=1, device="cpu") > 0


# ---------------------------------------------------------------------------
# end-to-end: calibrate -> registry -> load -> identical predictions
# ---------------------------------------------------------------------------


def test_calibrate_tiny_end_to_end_on_the_cpu(tmp_path):
    res = calibrate("cpu-test", scale="tiny", runs=5, drop=1,
                    classes=("stride1_global", "mm_tiled"),
                    registry_dir=str(tmp_path), verbose=False,
                    torch_device="cpu")
    assert res.registry_path and os.path.exists(res.registry_path)
    assert res.model.meta["source"] == "calibrated"
    assert res.model.meta["classes"] == ["mm_tiled", "stride1_global"]
    assert res.report["n"] == len(res.labels) == 15 + 16
    assert np.isfinite(res.model.weights).all()

    loaded = load_model("cpu-test", str(tmp_path))
    assert np.array_equal(loaded.weights, res.model.weights)
    pv = {k: float(i + 1) for i, k in enumerate(res.model.keys)}
    assert loaded.predict(pv) == res.model.predict(pv)
    # and the reference loads it to the same predictions
    theirs = jregistry.load_model("cpu-test", str(tmp_path))
    assert theirs.predict(pv) == res.model.predict(pv)


def test_calibrate_rejects_unknown_class(tmp_path):
    with pytest.raises(ValueError, match="unknown kernel classes"):
        calibrate("x", scale="tiny", classes=("not_a_class",),
                  registry_dir=str(tmp_path), verbose=False,
                  torch_device="cpu")


def test_calibrate_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        calibrate("x", scale="tiny", classes=("empty",), verbose=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli(["--device", "x", "--scale", "tiny", "--dry-run"])


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_list_and_show(tmp_path, capsys):
    save_model(_awkward_model(), str(tmp_path))
    assert cli(["--list", "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "rt-test" in out and "fitted" in out and "gpu-h100" in out
    assert cli(["--show", "gpu-h100", "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "device: gpu-h100" in out and "Const(1) launch overhead" in out
    assert cli(["--show", "no-such", "--out", str(tmp_path)]) == 1
    assert "cannot load model" in capsys.readouterr().err


def test_cli_calibrates_on_the_cpu(tmp_path, capsys):
    assert cli(["--device", "cpu-cli", "--torch-device", "cpu",
                "--scale", "tiny", "--runs", "5", "--drop", "1",
                "--classes", "empty,stride1_global",
                "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "fit geomean rel |err|" in out and "launch overhead" in out
    assert list_models(str(tmp_path))["cpu-cli"] == "fitted"
