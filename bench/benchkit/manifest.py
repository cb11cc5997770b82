"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (``bench/configs/<config>.json``) and a
traffic mix (``bench/traffic/<traffic>.json``); its limits are
``bench/limits/<cell>.json``; a configuration's plain reference is
``bench/reference/<config>.py``; a per-layer metric's reader is
``bench/metrics/<metric>.py``.  Adding a cell, a configuration or a
metric adds files and entries; nothing here changes.

What is particular to an architecture comes with its files:

* the configuration file's keys are the fields of the program's
  ``ArchConfig`` and of its groups' dataclasses, beside the documentary
  ones and copies of the source's own keys that ``published`` holds
  (``program.arch_config``);
* the reference module defines ``logits`` and ``loss``, and may define
  ``param_spec(cfg) -> [weights.Leaf]`` (the weights' names, shapes, types
  and draws), ``forward_flops(cfg, B, S) -> int`` (the model FLOPs the MFU
  readers take) and ``routed_layers(cfg) -> int`` (the layers whose
  experts' picks a prefill's check replays); where it does not, the
  functions of ``weights``, ``counts`` and ``prefill`` for today's
  families apply;
* a reader defines ``read(ctx) -> float or None`` and may export
  ``ENTRY = (module, function name, describe)``: an entry point of the
  program that the traced run then wraps in a range, whose calls and
  device seconds ``ctx.calls(name)`` returns (``entries``).
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(man: dict, name: str) -> dict:
    for c in man["workloads"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                   f"{[c['name'] for c in man['workloads']]})")


def config(man: dict, name: str) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            cfg = load_json(ROOT / c["file"])
            if cfg["name"] != name:
                raise ValueError(f"{c['file']} names {cfg['name']!r}, "
                                 f"not {name!r}")
            return cfg
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return load_json(BENCH / "traffic" / f"{name}.json")


def limits(cell_name: str) -> dict:
    return load_json(BENCH / "limits" / f"{cell_name}.json")


def _module(path: Path, name: str) -> ModuleType:
    if not path.exists():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(config_name: str) -> ModuleType:
    """The plain reference of a configuration."""
    return _module(BENCH / "reference" / f"{config_name}.py",
                   f"reference_{config_name.replace('-', '_')}"
                   .replace(".", "_"))


def reader(metric_name: str) -> ModuleType:
    """The reader of a per-layer metric: ``read(ctx) -> float or None``."""
    return _module(BENCH / "metrics" / f"{metric_name}.py",
                   "metric_" + metric_name.replace(".", "_")
                   .replace("-", "_"))


def metrics_of(man: dict, cell_name: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (``trace`` false) or per-layer metrics
    (``trace`` true): those whose ``workloads`` list the cell, or that
    have no such list."""
    group = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in group
            if cell_name in m.get("workloads", [cell_name])]


def units(man: dict) -> Dict[str, str]:
    return {m["name"]: m["unit"]
            for m in man["end_to_end"] + man["per_layer"]}
