"""The port's paper Tables 1 and 2 and the roofline against the reference's
scripts (``benchmarks/paper_table1.py``, ``paper_table2.py``,
``roofline.py``), on the CPU.

Both sides run from a temporary directory (each writes ``experiments/``
under the working directory) with the model registry pointed there.
Table 1 at the ``tiny`` ladder, 3 runs drop 1: the same measurement
kernels, held-out cases, classes and record keys (times are not
compared).  Table 2: the fitted model's keys, the ``gpu-h100`` seed
column.  The roofline: the reference's ``analyse`` and the port's on the
same dry-run record give the same terms once the rates are substituted
(rtol 1e-12), and the same model flops.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import paper_table1 as jt1   # noqa: E402
from benchmarks import roofline as jroof     # noqa: E402
from repro_torch.benchmarks import paper_table1 as tt1   # noqa: E402
from repro_torch.benchmarks import paper_table2 as tt2   # noqa: E402
from repro_torch.benchmarks import roofline as troof     # noqa: E402
from repro_torch.calibration import seeds                # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """Both sides' Table 1 at the tiny ladder, each in its own directory."""
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for side in ("ref", "port"):
            d = tmp_path_factory.mktemp(side)
            mp.chdir(d)
            mp.setenv("REPRO_MODEL_REGISTRY", str(d / "registry"))
            if side == "ref":
                out[side] = (jt1.run(scale="tiny", runs=3, drop=1,
                                     verbose=False), d)
            else:
                out[side] = (tt1.run(scale="tiny", runs=3, drop=1,
                                     device="cpu", out="experiments",
                                     verbose=False), d)
    finally:
        mp.undo()
    return out


def test_table1_has_the_reference_cases_classes_and_keys(tables):
    (ref, _), (port, d) = tables["ref"], tables["port"]
    assert sorted(port) == sorted(ref)
    assert port["n_measurement_kernels"] == ref["n_measurement_kernels"] \
        == 83
    assert [r["kernel"] for r in port["rows"]] == \
        [r["kernel"] for r in ref["rows"]]
    assert [r["class"] for r in port["rows"]] == \
        [r["class"] for r in ref["rows"]]
    assert sorted(port["per_class_geomean"]) == \
        sorted(ref["per_class_geomean"])
    for a, b in zip(port["rows"], ref["rows"]):
        assert sorted(a) == sorted(b)
        assert a["predicted_ms"] > 0 and a["actual_ms"] > 0
    assert port["paper_band"] == ref["paper_band"]
    assert port["device"] == "cpu-tiny" == ref["device"]


def test_table1_writes_only_port_names_and_registers_the_model(tables):
    (_, rd), (port, d) = tables["ref"], tables["port"]
    ours = {p.name for p in (d / "experiments").iterdir()}
    theirs = {p.name for p in (rd / "experiments").iterdir()}
    assert {"torch_paper_table1.json",
            "torch_model_cpu-tiny_tiny.json"} <= ours
    assert not (ours - {"registry"}) & theirs
    assert (d / "registry" / "cpu-tiny.json").exists()
    rec = json.loads((d / "experiments" / "torch_paper_table1.json")
                     .read_text())
    assert rec == json.loads(json.dumps(port))


def test_heldout_predicts_with_the_given_model(tables):
    from repro_torch.core.model import LinearCostModel
    _, d = tables["port"]
    model = LinearCostModel.load(
        str(d / "experiments" / "torch_model_cpu-tiny_tiny.json"))
    rows, pvs = tt1.heldout(model, "tiny", "cpu", runs=2, drop=1)
    assert len(rows) == len(pvs) == 16
    for r, pv in zip(rows, pvs):
        assert r["predicted_ms"] == model.predict(pv) * 1e3


def test_table2_sets_the_fit_beside_the_h100_and_v5e_seeds(tables,
                                                           monkeypatch,
                                                           capsys):
    _, d = tables["port"]
    monkeypatch.chdir(d)
    rec = tt2.main(["--scale", "tiny", "--device", "cpu"])
    from repro_torch.core.model import LinearCostModel
    fit = LinearCostModel.load(
        str(d / "experiments" / "torch_model_cpu-tiny_tiny.json"))
    assert sorted(rec["fit"]) == sorted(fit.keys)
    h100 = seeds.ANALYTIC_SEEDS["gpu-h100"]()
    assert rec["gpu_h100_seed"] == dict(zip(h100.keys,
                                            map(float, h100.weights)))
    assert rec["gpu_h100_seed"]["mxu:16"] == 1 / 989e12
    assert rec["tpu_v5e_seed"]
    text = capsys.readouterr().out
    assert "h100 seed" in text and "v5e seed (TPU)" in text
    assert (d / "experiments" / "torch_paper_table2.json").exists()


RECORD = {"arch": "llama3.2-3b", "shape": "train_4k", "mesh": "16x16",
          "status": "ok", "n_devices": 256,
          "flops_per_device": 3.693e14, "bytes_per_device": 2.1e12,
          "collective_bytes_per_device": {"all_gather": 1.3e10,
                                          "reduce_scatter": 9.27e10,
                                          "all_reduce": 2.4e4}}


@pytest.mark.parametrize("rec", [
    RECORD, dict(RECORD, arch="zamba2-2.7b", shape="prefill_32k",
                 flops_per_device=1e12, bytes_per_device=5e13),
    dict(RECORD, status="skip", why="n/a")], ids=["train", "prefill",
                                                   "skip"])
def test_roofline_terms_are_the_reference_at_the_h100_rates(rec):
    ref, got = jroof.analyse(rec), troof.analyse(rec)
    if ref is None:
        assert got is None
        return
    assert sorted(got) == sorted(ref)
    assert got["compute_s"] == pytest.approx(
        ref["compute_s"] * jroof.PEAK / 989e12, rel=1e-12)
    assert got["memory_s"] == pytest.approx(
        ref["memory_s"] * jroof.HBM / 3.35e12, rel=1e-12)
    assert got["collective_s"] == pytest.approx(
        ref["collective_s"] * jroof.ICI / 450e9, rel=1e-12)
    assert got["model_flops"] == pytest.approx(ref["model_flops"],
                                               rel=1e-12)
    assert got["useful_ratio"] == pytest.approx(ref["useful_ratio"],
                                                rel=1e-12)
    terms = {k: got[f"{k}_s"] for k in ("compute", "memory", "collective")}
    assert got["dominant"] == max(terms, key=terms.get)


def test_roofline_command_reads_dryrun_records(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    src = tmp_path / "dryrun_torch.json"
    src.write_text(json.dumps([RECORD, dict(RECORD, mesh="2x16x16"),
                               dict(RECORD, status="skip", why="x",
                                    shape="long_500k")]))
    rows = troof.main([str(src), "--mesh", "16x16", "--out", "exp"])
    assert len(rows) == 1
    # the 256-rank llama cell counts 4.17x archcount's model flops
    assert rows[0]["useful_ratio"] == pytest.approx(1 / 4.17, rel=0.02)
    assert (tmp_path / "exp" / "torch_roofline_16x16.json").exists()
    assert not (tmp_path / "exp" / "roofline_16x16.json").exists()
