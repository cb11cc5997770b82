"""BENCHMARK.json and the files it names: every cell's configuration,
traffic, limits, reference and metric readers resolve by name, and the
manifest keeps to the benchmark's contract."""
import re

import pytest

import _bench_tiny  # noqa: F401  (puts bench/ and src/ on the path)
from benchkit import manifest

MAN = manifest.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def test_manifest_has_exactly_the_contract_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "bench/run.py"]
    assert MAN["paths"] == ["bench"]
    assert 1 <= MAN["run_seconds"] <= 51


def test_names_and_units():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in MAN[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cell", [c["name"] for c in MAN["workloads"]])
def test_cell_files_resolve(cell):
    c = manifest.cell(MAN, cell)
    cfg = manifest.config(MAN, c["config"])
    traffic = manifest.traffic(c["traffic"])
    limits = manifest.limits(cell)["limits"]
    assert traffic["kind"] in ("prefill", "train")
    assert limits and all(v > 0 for v in limits.values())
    ref = manifest.reference(c["config"])
    assert callable(ref.logits) and callable(ref.loss)
    assert c["chips"] == 1 and len(c["why"]) <= 200
    assert cfg["name"] == c["config"]
    e2e = [m["name"] for m in manifest.metrics_of(MAN, cell, trace=False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = manifest.metrics_of(MAN, cell, trace=True)
    assert layer
    # each per-layer metric moves an end-to-end metric the cell reports
    assert all(m["moves"] in e2e for m in layer)


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["per_layer"]])
def test_metric_readers_load(metric):
    assert callable(manifest.reader(metric).read)


@pytest.mark.parametrize("name", [c["name"] for c in MAN["configs"]])
def test_configuration_files_say_where_they_come_from(name):
    entry = next(c for c in MAN["configs"] if c["name"] == name)
    cfg = manifest.config(MAN, name)
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert cfg["deployment"] and cfg["assumed"]
    for key in cfg["reduced"]:
        assert key in cfg.get("published", {})


def test_every_config_is_used_and_every_layer_named_alike():
    used = {c["config"] for c in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    for m in MAN["per_layer"]:
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
