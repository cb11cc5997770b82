"""One run of one cell: its files found by name, the kind of traffic's
driver, the check, and the result line's fields.

A driver (``prefill.run``, ``train.run``) sets up, runs the window and
computes the numbers that decide ``correct``; this module judges them
against the cell's limits, and turns the window into the end-to-end
metrics (``--trace 0``) or hands it to the per-layer metrics' readers
(``--trace 1``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from benchkit import compare, manifest, prefill, train
from benchkit.window import Result, Window

DRIVERS = {"prefill": prefill.run, "train": train.run}


@dataclass
class Context:
    """What a per-layer metric's reader reads."""
    cell: dict
    config: dict
    traffic: dict
    result: Result

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    def calls(self, name: str) -> List[Tuple[dict, float]]:
        """(problem shape, device seconds) of each call of the entry point
        ``name`` in the profiled steps."""
        prof = self.result.profile
        if prof is None:
            return []
        shapes = self.result.calls.get(name, [])
        secs = prof["spans"].get(name, [])
        if len(shapes) != len(secs):
            raise RuntimeError(f"{name}: {len(shapes)} calls but "
                               f"{len(secs)} device spans in the profile")
        return list(zip(shapes, secs))


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


def run_cell(name: str, seed: int, seconds: float, trace: bool, t0: float,
             device="cuda", man: Optional[dict] = None,
             cfg: Optional[dict] = None, traffic: Optional[dict] = None,
             limits: Optional[Dict[str, float]] = None) -> dict:
    """The result line of one run.  ``cfg`` / ``traffic`` / ``limits``
    replace the cell's files (the tests run cells at a small size)."""
    return measure(name, seed, seconds, trace, t0, device, man, cfg, traffic,
                   limits)[0]


def measure(name: str, seed: int, seconds: float, trace: bool, t0: float,
            device="cuda", man: Optional[dict] = None,
            cfg: Optional[dict] = None, traffic: Optional[dict] = None,
            limits: Optional[Dict[str, float]] = None
            ) -> Tuple[dict, Result]:
    """(the result line, the run's ``Result``)."""
    man = man or manifest.manifest()
    c = manifest.cell(man, name)
    cfg = cfg or manifest.config(man, c["config"])
    traffic = traffic or manifest.traffic(c["traffic"])
    limits = limits or manifest.limits(name)["limits"]
    ref = manifest.reference(c["config"])
    win = Window(device, t0, trace)
    try:
        res = DRIVERS[traffic["kind"]](cfg, traffic, ref, seed, seconds,
                                       win, device)
    finally:
        win.close()
    correct, compared = compare.judge(res.numbers, limits)
    units = manifest.units(man)
    metrics: Dict[str, dict] = {}
    if trace:
        ctx = Context(c, cfg, traffic, res)
        for m in manifest.metrics_of(man, name, trace=True):
            value = manifest.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": units[m["name"]]}
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
