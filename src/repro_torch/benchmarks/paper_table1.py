"""Paper Table 1 on the port's device: the paper's pipeline end to end (the
counterpart of the reference's ``benchmarks/paper_table1.py``).

1. Time the launch floor and the 9-class measurement-kernel library
   (paper §4.1) on the device, under the §4.2 protocol (30 runs, drop 4,
   take the minimum).
2. Extract the property vectors from each kernel's ATen graph (paper §3).
3. Fit the weights by relative-error least squares (paper §4.3): steps
   1–3 are ``calibration.calibrate.calibrate``.
4. Predict the four held-out test kernels (finite difference, skinny
   matmul, convolution, N-body, paper §5; ``heldout``) and report
   per-kernel predicted against actual, and the per-class and overall
   geometric means of the relative error.

The paper's cross-kernel geomeans: Titan X 16 %, C2070 14 %, K40 6 %, R9
Fury 42 %; ``paper_band`` is that range.  The fitted model is registered
under the device's name (``gpu-h100`` on the card, ``cpu-<scale>`` on the
CPU) and written as ``torch_model_<name>_<scale>.json``; the record is
``torch_paper_table1.json`` (the reference's keys).

    PYTHONPATH=src python -m repro_torch.benchmarks.paper_table1 \\
        --scale gpu                              # on the card
    PYTHONPATH=src python -m repro_torch.benchmarks.paper_table1 \\
        --device cpu --scale tiny --runs 3 --drop 1 --registry /tmp/reg
"""
from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.calibration.calibrate import calibrate
from repro_torch.core import measure, mkernels, tkernels
from repro_torch.core.model import LinearCostModel, geomean, relative_error

OUT_DIR = "experiments"
PAPER_BAND = [0.06, 0.42]


def model_name(device: str, scale: str) -> str:
    """The registry name of the fit: the card's catalog name, or the
    reference's ``cpu-<scale>``."""
    return "gpu-h100" if torch.device(device).type == "cuda" \
        else f"cpu-{scale}"


def model_path(out: str, name: str, scale: str) -> str:
    return os.path.join(out, f"torch_model_{name}_{scale}.json")


def heldout(model: LinearCostModel, scale: str, device: str, *,
            runs: int = 30, drop: int = 4, launch_s: float = 0.0
            ) -> Tuple[List[Dict], List[Dict[str, float]]]:
    """The held-out step: ``model`` predicts the test kernels at ``scale``,
    which are timed on ``device`` under the same protocol.  -> (rows, the
    property vectors they were predicted from)."""
    rows, pvs = [], []
    with torch.no_grad():
        for c in tkernels.test_cases(scale, device=device):
            pv = c.properties()
            tr = measure.time_kernel(c.jitted(), runs=runs, drop=drop,
                                     min_time_s=4 * launch_s)
            pred = model.predict(pv)
            rows.append({"kernel": c.name, "class": c.klass,
                         "predicted_ms": pred * 1e3,
                         "actual_ms": tr.min_s * 1e3,
                         "rel_err": relative_error(pred, tr.min_s),
                         "spread": tr.spread})
            pvs.append(pv)
            del c
    return rows, pvs


def record(model: LinearCostModel, launch_s: float, n_measurement: int,
           fit_geomean: float, rows: List[Dict]) -> Dict:
    """The Table 1 record, the reference's keys."""
    per_class: Dict[str, List[float]] = defaultdict(list)
    for r in rows:
        per_class[r["class"]].append(r["rel_err"])
    return {
        "device": model.device,
        "launch_overhead_us": launch_s * 1e6,
        "n_measurement_kernels": n_measurement,
        "fit_geomean_rel_err": fit_geomean,
        "rows": rows,
        "per_class_geomean": {k: geomean(v) for k, v in per_class.items()},
        "overall_geomean_rel_err": geomean(r["rel_err"] for r in rows),
        "paper_band": list(PAPER_BAND),
    }


def write(result: Dict, model: LinearCostModel, scale: str,
          out: str = OUT_DIR) -> str:
    """The record and the model's file under ``out``; -> the model's
    path."""
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "torch_paper_table1.json"), "w") as f:
        json.dump(result, f, indent=1)
    path = model_path(out, model.device, scale)
    model.save(path)
    return path


def report(result: Dict) -> None:
    print(f"\n{'kernel':<26} {'class':<18} {'pred ms':>9} "
          f"{'actual ms':>9} {'rel err':>8}")
    for r in result["rows"]:
        print(f"{r['kernel']:<26} {r['class']:<18} "
              f"{r['predicted_ms']:9.3f} {r['actual_ms']:9.3f} "
              f"{r['rel_err']:8.2f}")
    print("\nper-class geomean rel |err|:")
    for k, v in result["per_class_geomean"].items():
        print(f"  {k:<20} {v:.3f}")
    print(f"overall geomean rel |err|: "
          f"{result['overall_geomean_rel_err']:.3f} "
          f"(paper band {result['paper_band']})")


def run(scale: str = "gpu", runs: int = 30, drop: int = 4,
        ridge: float = 1e-4, device: str = "cuda", out: str = OUT_DIR,
        registry: Optional[str] = None, verbose: bool = True) -> Dict:
    """Measure, fit and register, then the held-out step; writes the
    record and the model under ``out``."""
    name = model_name(device, scale)
    res = calibrate(name, scale=scale, runs=runs, drop=drop, ridge=ridge,
                    registry_dir=registry, torch_device=device,
                    verbose=False)
    if verbose:
        print(f"# launch overhead: {res.launch_overhead_s * 1e6:.1f} µs")
        print(f"# measured {len(res.labels)} measurement kernels "
              f"({res.wall_s:.0f}s)")
    rows, _ = heldout(res.model, scale, device, runs=runs, drop=drop,
                      launch_s=res.launch_overhead_s)
    result = record(res.model, res.launch_overhead_s, len(res.labels),
                    res.report["geomean_rel_err"], rows)
    if verbose:
        report(result)
    write(result, res.model, scale, out)
    if verbose:
        print(f"# model registered at {res.registry_path}")
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", default="gpu", choices=mkernels.SCALES)
    ap.add_argument("--device", default="cuda",
                    help="the device the kernels run on (default: cuda)")
    ap.add_argument("--runs", type=int, default=30)
    ap.add_argument("--drop", type=int, default=4)
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--registry", default=None,
                    help="registry directory (default: "
                         "$REPRO_MODEL_REGISTRY or experiments/registry)")
    a = ap.parse_args(argv)
    run(scale=a.scale, runs=a.runs, drop=a.drop, device=a.device,
        out=a.out, registry=a.registry)


if __name__ == "__main__":
    main()
