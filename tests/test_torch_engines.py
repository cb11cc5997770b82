"""The port's engine benchmarks and its benchmark dispatcher against the
reference's scripts (``benchmarks/search_bench.py``, ``fused_bench.py``,
``fleet_bench.py``, ``run.py``), on the CPU.

Each side runs in a temporary directory of its own with the model registry
pointed there, at reduced sizes; the port prices under the reference's
model (``tpu-v5e``), step composition (``PALLAS_KERNELS``) and, for the
streamed sweep, HBM budget (16e9).  What each side scored, streamed or
allocated is recorded by wrapping the engine call the script makes; times
are not compared.
"""
from __future__ import annotations

import dataclasses
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import fleet_bench as jfleet   # noqa: E402
from benchmarks import fused_bench as jfused   # noqa: E402
from benchmarks import run as jrun             # noqa: E402
from benchmarks import search_bench as jsearch  # noqa: E402
from repro.core import planspace as jplanspace  # noqa: E402
from repro.launch import fleet as jlfleet       # noqa: E402
from repro_torch.benchmarks import fleet_bench as tfleet   # noqa: E402
from repro_torch.benchmarks import fused_bench as tfused   # noqa: E402
from repro_torch.benchmarks import run as trun             # noqa: E402
from repro_torch.benchmarks import search_bench as tsearch  # noqa: E402
from repro_torch.core import planspace as tplanspace       # noqa: E402
from repro_torch.core.kernelmodel import PALLAS_KERNELS as P  # noqa: E402
from repro_torch.launch import fleet as tlfleet           # noqa: E402

torch.set_num_threads(1)

V5E_HBM = 16e9


def _record(mp, owner, name, log):
    """Wrap ``owner.name`` so each call's result is appended to ``log``."""
    real = getattr(owner, name)

    def wrapped(*a, **kw):
        out = real(*a, **kw)
        log.append(out)
        return out
    mp.setattr(owner, name, wrapped)


def _in_dir(mp, d):
    mp.chdir(d)
    mp.setenv("REPRO_MODEL_REGISTRY", str(d / "registry"))


def _plans(plans):
    return [dataclasses.asdict(p) for p in plans]


@pytest.fixture(scope="module")
def search(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for side, ps, run in (
                ("ref", jplanspace,
                 lambda o: jsearch.main(["--target-cells", "2000",
                                         "--repeats", "1", "--out", o])),
                ("port", tplanspace,
                 lambda o: tsearch.run(target_cells=2000, repeats=1,
                                       model="tpu-v5e", kernels=P,
                                       out=o))):
            d = tmp_path_factory.mktemp(f"search-{side}")
            _in_dir(mp, d)
            scores = []
            _record(mp, ps.PlanSpace, "scores", scores)
            res = run(str(d / "BENCH.json"))
            mp.undo()
            out[side] = (res, scores, d)
    finally:
        mp.undo()
    return out


def test_search_bench_builds_the_reference_space():
    cfg = tsearch.ARCHS["glm4-9b"]
    shape = tsearch.SHAPES["train_4k"]
    jcfg = jsearch.ARCHS["glm4-9b"]
    jshape = jsearch.SHAPES["train_4k"]
    assert tsearch.DEVICE_LADDER == jsearch.DEVICE_LADDER
    for cells in (2000, 10000):
        plans, meshes = tsearch.build_space(cfg, shape, cells)
        jplans, jmeshes = jsearch.build_space(jcfg, jshape, cells)
        assert _plans(plans) == _plans(jplans)
        assert meshes == jmeshes


def test_search_bench_keys_and_scores_equal_the_reference(search):
    (ref, jscores, _), (port, tscores, d) = search["ref"], search["port"]
    assert sorted(port) == sorted(ref)
    assert port["cells"] == ref["cells"] >= 2000
    assert (port["n_plans"], port["n_meshes"]) == \
        (ref["n_plans"], ref["n_meshes"])
    assert port["model"] == ref["model"] == "tpu-v5e-analytic"
    assert port["baseline"] == ref["baseline"]
    assert port["speedup"] > 0 and port["us_per_cell"] > 0
    # the first scores call is the equivalence check's: every cell
    np.testing.assert_allclose(tscores[0], jscores[0], rtol=1e-9)
    assert len(tscores[0]) == port["cells"]
    assert json.loads((d / "BENCH.json").read_text()) == port


def test_search_bench_defaults_to_the_card_model(tmp_path, monkeypatch):
    _in_dir(monkeypatch, tmp_path)
    res = tsearch.main(["--target-cells", "500", "--repeats", "1"])
    assert res["model"] == "gpu-h100"
    assert (tmp_path / "BENCH_torch_search.json").exists()
    assert not (tmp_path / "BENCH_search.json").exists()


@pytest.fixture(scope="module")
def fused(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    out = {}
    args = dict(target_cells=2000, stream_cells=20000, repeats=1)
    try:
        for side, ps, run in (
                ("ref", jplanspace,
                 lambda o: jfused.main([
                     "--target-cells", "2000", "--stream-cells", "20000",
                     "--repeats", "1", "--out", o])),
                ("port", tplanspace,
                 lambda o: tfused.run(**args, model="tpu-v5e", kernels=P,
                                      hbm_budget=V5E_HBM, out=o))):
            d = tmp_path_factory.mktemp(f"fused-{side}")
            _in_dir(mp, d)
            tops = []
            _record(mp, ps, "stream_topk", tops)
            res = run(str(d / "BENCH.json"))
            mp.undo()
            out[side] = (res, tops)
    finally:
        mp.undo()
    return out


def test_fused_bench_streams_the_reference_top_ten(fused):
    (ref, (jtop,)), (port, (ttop,)) = fused["ref"], fused["port"]
    assert sorted(port["stream"]) == sorted(ref["stream"])
    assert len(ttop) == len(jtop) == 10
    np.testing.assert_allclose([s for s, _, _ in ttop],
                               [s for s, _, _ in jtop], rtol=1e-9)
    assert _plans([p for _, p, _ in ttop]) == _plans([p for _, p, _ in jtop])
    assert [m for _, _, m in ttop] == [m for _, _, m in jtop]
    for k in ("cells", "chunks", "max_chunk_cells", "pruned_cells",
              "top_k"):
        assert port["stream"][k] == ref["stream"][k], k
    assert port["hbm_budget"] == V5E_HBM


def test_fused_bench_keys_and_bars(fused):
    (ref, _), (port, _) = fused["ref"], fused["port"]
    assert set(ref) <= set(port)
    assert sorted(port["obs"]) == sorted(ref["obs"])
    assert port["cells"] == ref["cells"]
    assert (tfused.SPEEDUP_BAR_COLUMNS, tfused.SPEEDUP_BAR_LOOP,
            tfused.OBS_OVERHEAD_BAR) == (jfused.SPEEDUP_BAR_COLUMNS,
                                         jfused.SPEEDUP_BAR_LOOP,
                                         jfused.OBS_OVERHEAD_BAR)
    assert tfused.stream_meshes(list(range(3)), 50) == \
        jfused.stream_meshes(list(range(3)), 50)


def test_fused_bench_budget_is_an_h100s_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU")
    assert tfused.device_memory() == 80e9


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for side, alloc, run in (
                ("ref", jlfleet.FleetAllocator,
                 lambda o: jfleet.main(["--repeats", "2", "--out", o])),
                ("port", tlfleet.FleetAllocator,
                 lambda o: tfleet.run(repeats=2, kernels=P, out=o))):
            d = tmp_path_factory.mktemp(f"fleet-{side}")
            _in_dir(mp, d)
            allocations = []
            _record(mp, alloc, "allocate", allocations)
            res = run(str(d / "BENCH.json"))
            mp.undo()
            out[side] = (res, allocations)
    finally:
        mp.undo()
    return out


def test_fleet_bench_cold_allocation_and_cache_reuse(fleet):
    (ref, jal), (port, tal) = fleet["ref"], fleet["port"]
    assert sorted(port) == sorted(ref)
    jcold, tcold = jal[0], tal[0]
    assert sorted(tcold.placements) == sorted(jcold.placements)
    for name, jp in jcold.placements.items():
        tp = tcold.placements[name]
        assert (tp.pool, tp.device, tp.devices, tp.mesh) == \
            (jp.pool, jp.device, jp.devices, jp.mesh)
        assert dataclasses.asdict(tp.plan) == dataclasses.asdict(jp.plan)
        assert tp.predicted_step_s == pytest.approx(jp.predicted_step_s,
                                                    rel=1e-9)
    assert tcold.paused == jcold.paused
    assert port["cache_reuse"] == ref["cache_reuse"]
    assert (port["jobs"], port["pools"]) == (ref["jobs"], ref["pools"])
    assert (port["ratio_bar"], port["cache_reuse_bar"]) == \
        (ref["ratio_bar"], ref["cache_reuse_bar"])


def _headers(text: str, prefix: str):
    return re.findall(rf"^== {re.escape(prefix)}(\w+)$", text, re.M)


def test_run_dispatches_the_reference_names_in_order(tmp_path, monkeypatch,
                                                     capsys):
    """Both dispatchers with every benchmark stubbed: the same names in the
    same order, and the roofline's notice where there is no dry run."""
    _in_dir(monkeypatch, tmp_path)
    import benchmarks.paper_table1 as j1
    import benchmarks.paper_table2 as j2
    import benchmarks.predictor_validation as j3
    from repro_torch.benchmarks import paper_table1 as t1
    from repro_torch.benchmarks import paper_table2 as t2
    from repro_torch.benchmarks import predictor_validation as t3
    calls = []
    for m in (j1, j2, j3, jsearch, t1, t2, t3, tsearch):
        monkeypatch.setattr(m, "main",
                            lambda *a, _m=m.__name__: calls.append((_m, a)))
    monkeypatch.setattr(sys, "argv", ["run"])
    jrun.main()
    ref_names = _headers(capsys.readouterr().out, "benchmarks.")
    res = trun.main([])
    out = capsys.readouterr().out
    assert _headers(out, "repro_torch.benchmarks.") == ref_names \
        == list(trun.NAMES)
    assert "python -m repro_torch.launch dryrun" in out
    assert res["roofline"] is None
    ported = [a for m, a in calls if m.startswith("repro_torch")]
    assert ported == [(["--scale", "gpu", "--device", "cuda"],)] * 3 + [([],)]


def test_run_only_search_bench_runs_it(tmp_path, monkeypatch):
    _in_dir(monkeypatch, tmp_path)
    res = trun.main(["--only", "search_bench", "--scale", "tiny"])
    assert list(res) == ["search_bench"]
    assert res["search_bench"]["cells"] >= 10000
    assert res["search_bench"]["model"] == "gpu-h100"
    assert (tmp_path / "BENCH_torch_search.json").exists()


def test_run_unknown_name_exits_2(tmp_path, monkeypatch):
    _in_dir(monkeypatch, tmp_path)
    with pytest.raises(SystemExit) as e:
        trun.main(["--only", "no_such_benchmark"])
    assert e.value.code == 2


def test_run_roofline_reads_the_dry_run_record(tmp_path, monkeypatch):
    _in_dir(monkeypatch, tmp_path)
    (tmp_path / "experiments").mkdir()
    calls = []
    from repro_torch.benchmarks import roofline
    monkeypatch.setattr(roofline, "main", lambda argv: calls.append(argv)
                        or [])
    (tmp_path / trun.DRYRUN).write_text("[]")
    res = trun.main(["--only", "roofline"])
    assert calls == [[trun.DRYRUN, "--mesh", m] for m in ("16x16",
                                                          "2x16x16")]
    assert res == {"roofline": {"16x16": [], "2x16x16": []}}
