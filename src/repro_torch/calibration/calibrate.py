"""The calibration driver — the paper's fit-once-per-device loop, end to end.

One call (or ``python -m repro_torch.calibration``) runs the full black-box
procedure of §4 on the runtime device (the card unless the caller asks for
the CPU):

  1. measure launch overhead (empty-kernel floor, §4.2);
  2. time the 9-class measurement-kernel suite (``core.mkernels``) under the
     paper's protocol — 30 runs, drop 4, take the minimum;
  3. extract each kernel's property vector automatically from its ATen
     graph (``core.extract``) plus schedule-declared properties;
  4. fit weights by relative-error least squares (``core.fit.fit_relative``);
  5. report per-kernel relative error and the Table-2-style weight
     interpretation;
  6. write the fitted model into the device-model registry, where
     ``registry.load_model(device)`` picks it up.

f32 matrix products are held to IEEE f32 on the card
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` set False), so ``mxu:32`` means what it
means in the reference.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

import torch

from repro_torch.calibration import registry
from repro_torch.core import fit, measure, mkernels
from repro_torch.core.model import LinearCostModel


@dataclass
class CalibrationResult:
    model: LinearCostModel
    report: Dict[str, object]        # fit.fit_report output on the fit set
    launch_overhead_s: float
    registry_path: Optional[str]     # None when write_registry=False
    wall_s: float
    labels: List[str] = field(default_factory=list)


def calibrate(device: str = "cpu", *, scale: str = "cpu",
              runs: int = 30, drop: int = 4,
              ridge: float = 1e-4, nonneg: bool = False,
              classes: Optional[Sequence[str]] = None,
              registry_dir: Optional[str] = None,
              write_registry: bool = True,
              seed: int = 0, verbose: bool = True,
              torch_device: Union[str, torch.device] = "cuda"
              ) -> CalibrationResult:
    """Fit a ``LinearCostModel`` named ``device`` from live measurements on
    ``torch_device`` (the registry name and the runtime device are separate,
    as in the reference, where ``device`` names the model).

    ``classes`` restricts the suite to the named measurement-kernel classes
    (e.g. ``("stride1_global", "arith")``) — useful for quick partial
    recalibration and for tests; the default is the full 9-class suite.
    Without a card, ``torch_device="cuda"`` raises: pass ``"cpu"`` to
    calibrate the CPU.
    """
    if runs <= drop:
        raise ValueError(f"runs ({runs}) must exceed dropped warmup runs "
                         f"({drop}) — no timing samples would remain")
    torch_device = torch.device(torch_device)
    if torch_device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: calibrate the card on a "
                               "machine with one, or pass "
                               "torch_device='cpu'")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    launch = measure.measure_launch_overhead(runs=runs, drop=drop,
                                             device=torch_device)
    if verbose:
        print(f"# launch overhead: {launch * 1e6:.1f} µs")

    cases = mkernels.measurement_cases(scale, seed=seed, device=torch_device)
    if classes is not None:
        wanted = set(classes)
        have = {c.klass for c in cases}
        unknown = wanted - have
        if unknown:
            raise ValueError(f"unknown kernel classes {sorted(unknown)}; "
                             f"available: {sorted(have)}")
        cases = [c for c in cases if c.klass in wanted]
    if not cases:
        raise ValueError("no measurement kernels selected")

    pvs, times, labels = [], [], []
    with torch.no_grad():
        for i, c in enumerate(cases):
            pv = c.properties()
            tr = measure.time_kernel(c.jitted(), runs=runs, drop=drop,
                                     min_time_s=4 * launch)
            pvs.append(pv)
            times.append(tr.min_s)
            labels.append(c.name)
            if verbose and (i + 1) % 10 == 0:
                print(f"# measured {i + 1}/{len(cases)} kernels "
                      f"({time.time() - t_start:.0f}s)")

    model = fit.fit_relative(pvs, times, device=device, ridge=ridge,
                             nonneg=nonneg)
    model.meta.update({
        "scale": scale, "runs": runs, "drop": drop,
        "launch_overhead_s": launch,
        "classes": sorted({c.klass for c in cases}),
        "source": "calibrated",
        "runtime_device": (torch.cuda.get_device_name(torch_device)
                           if torch_device.type == "cuda" else "cpu"),
    })
    report = fit.fit_report(model, pvs, times, labels)
    model.meta["fit_geomean_rel_err"] = report["geomean_rel_err"]

    path = None
    if write_registry:
        path = registry.save_model(model, registry_dir)

    wall = time.time() - t_start
    if verbose:
        print(f"\n{'kernel':<28} {'pred ms':>10} {'actual ms':>10} "
              f"{'rel err':>8}")
        for r in report["rows"]:
            print(f"{r['label']:<28} {r['predicted_s'] * 1e3:10.3f} "
                  f"{r['actual_s'] * 1e3:10.3f} {r['rel_err']:8.3f}")
        print(f"\nfit geomean rel |err|: {report['geomean_rel_err']:.3f} "
              f"over {report['n']} kernels "
              f"(max {report['max_rel_err']:.3f})")
        print()
        print(model.interpretation_report())
        if path:
            print(f"\n# model written to {path}")
        print(f"# calibration wall time: {wall:.0f}s")

    return CalibrationResult(model=model, report=report,
                             launch_overhead_s=launch, registry_path=path,
                             wall_s=wall, labels=labels)
