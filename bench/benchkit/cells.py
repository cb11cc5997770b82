"""One run of one cell: its files found by name, the kind of traffic's
driver, the check, and the result line's fields.

A driver (``prefill.run``, ``train.run``) sets up, runs the window and
computes the numbers that decide ``correct``; this module judges them
against the cell's limits, and turns the window into the end-to-end
metrics (``--trace 0``) or hands it to the per-layer metrics' readers
(``--trace 1``), whose declared entry points (``ENTRY``) the traced
window wraps.
"""
from __future__ import annotations

from dataclasses import dataclass
from types import ModuleType
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from benchkit import compare, entries, manifest, prefill, spans, train
from benchkit.window import Result, Window

DRIVERS = {"prefill": prefill.run, "train": train.run}


@dataclass
class Context:
    """What a per-layer metric's reader reads: the cell, its configuration,
    traffic and reference module, and the run's ``Result``."""
    cell: dict
    config: dict
    traffic: dict
    result: Result
    ref: Optional[ModuleType] = None

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    @property
    def spans(self) -> Optional[dict]:
        """The program's spans in the profiled steps (``spans.ranges``), or
        None outside a traced run."""
        return self.result.spans

    def calls(self, name: str) -> List[Tuple[dict, float]]:
        """(problem shape, device seconds) of each call of the entry point
        ``name`` in the profiled steps."""
        prof = self.result.profile
        if prof is None:
            return []
        shapes = self.result.calls.get(name, [])
        secs = prof["spans"].get(name, [])
        if len(shapes) != len(secs):
            raise RuntimeError(f"{self.cell.get('name')}: {name}: "
                               f"{len(shapes)} calls but {len(secs)} device "
                               f"spans in the profile")
        return list(zip(shapes, secs))

    def span_ms(self, names: Sequence[str]) -> Optional[float]:
        """The device milliseconds a profiled step of the kernels, copies
        and memsets launched inside the program's spans ``names``
        (``spans.device_s``), or None where none of them launched one."""
        r = self.spans
        if r is None or not self.result.profiled \
                or not any(n in r["device"] for n in names):
            return None
        return 1e3 * spans.device_s(r, names) / self.result.profiled


def device_info(device, res: Result, trace: bool) -> dict:
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu",
            "count": 1, "memory_peak_bytes": int(res.memory_peak_bytes)}
    if trace and res.profile is not None:
        info["busy_s"] = res.profile["busy_s"]
        info["window_s"] = res.profile["window_s"]
    return info


def readers(man: dict, name: str) -> Dict[str, ModuleType]:
    """The readers of cell ``name``'s per-layer metrics, by metric name."""
    return {m["name"]: manifest.reader(m["name"])
            for m in manifest.metrics_of(man, name, trace=True)}


def run_cell(name: str, seed: int, seconds: float, trace: bool, t0: float,
             device="cuda", man: Optional[dict] = None,
             cfg: Optional[dict] = None, traffic: Optional[dict] = None,
             limits: Optional[Dict[str, float]] = None,
             ref: Optional[ModuleType] = None) -> dict:
    """The result line of one run.  ``cfg`` / ``traffic`` / ``limits`` /
    ``ref`` replace the cell's files (the tests run cells at a small
    size)."""
    return measure(name, seed, seconds, trace, t0, device, man, cfg, traffic,
                   limits, ref)[0]


def measure(name: str, seed: int, seconds: float, trace: bool, t0: float,
            device="cuda", man: Optional[dict] = None,
            cfg: Optional[dict] = None, traffic: Optional[dict] = None,
            limits: Optional[Dict[str, float]] = None,
            ref: Optional[ModuleType] = None) -> Tuple[dict, Result]:
    """(the result line, the run's ``Result``)."""
    man = man or manifest.manifest()
    c = manifest.cell(man, name)
    cfg = cfg or manifest.config(man, c["config"])
    traffic = traffic or manifest.traffic(c["traffic"])
    limits = limits or manifest.limits(name)["limits"]
    ref = ref or manifest.reference(c["config"])
    read = readers(man, name) if trace else {}
    win = Window(device, t0, trace, entries.union(read.values()))
    try:
        res = DRIVERS[traffic["kind"]](cfg, traffic, ref, seed, seconds,
                                       win, device)
    finally:
        win.close()
    correct, compared = compare.judge(res.numbers, limits)
    units = manifest.units(man)
    metrics: Dict[str, dict] = {}
    if trace:
        ctx = Context(c, cfg, traffic, res, ref)
        for metric, reader in read.items():
            value = reader.read(ctx)
            if value is not None:
                metrics[metric] = {"value": float(value),
                                   "unit": units[metric]}
    else:
        values = dict(res.metrics, setup_s=res.setup_s)
        for m in manifest.metrics_of(man, name, trace=False):
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": units[m["name"]]}
    out = {"correct": bool(correct and res.failed == 0),
           "attempted": int(res.attempted), "failed": int(res.failed),
           "metrics": metrics, "device": device_info(device, res, trace)}
    if trace and res.profile is not None:
        out["breakdown"] = {"device_ops": res.profile["device_ops"],
                            "idle_gaps": res.profile["idle_gaps"]}
    out["compared"] = compared
    return out, res
