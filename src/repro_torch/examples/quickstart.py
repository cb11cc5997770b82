"""Quickstart: fit the paper's linear cost model on the card and predict a
held-out kernel — the whole pipeline in one minute (the counterpart of the
reference's ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

1. Time the measurement library (paper §4.1) at the ``tiny`` ladder on the
   device: its tiled ``mm`` cases launch the hand-written CUDA matmul at
   the paper's 16³ tile and its tiled ``transpose`` cases the CUDA
   transpose; the properties come from each case's ATen graph (§3).
2. Fit the weights by relative-error least squares (§4.3).
3. Predict a kernel the fit never saw (a 384² product plus pointwise ops,
   extracted with ``extract.extract_graph``; its product is a plain
   ``torch.matmul``, as the reference's is a plain ``a @ a`` outside any
   Pallas kernel) and time it.
4. Attribute its predicted time to properties (Table-2 style).
"""
from __future__ import annotations

import argparse
import math

import torch

from repro_torch.core import extract, fit, measure, mkernels
from repro_torch.examples import add_device_arg, device

HELD_OUT_N = 384


def my_kernel(a):                       # fused polynomial + matmul
    b = a @ a
    return b * a + torch.exp(-a)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_arg(ap)
    dev = device(ap.parse_args(argv).device)

    # 1. measurement library (tiny ladder for the quickstart) ------------
    cases = mkernels.measurement_cases("tiny", device=dev)
    print(f"measuring {len(cases)} kernels (paper §4.1 library, tiny scale) "
          f"on {dev}…")
    pvs, times = [], []
    with torch.no_grad():
        for c in cases:
            pvs.append(c.properties())      # automatic extraction (§3)
            times.append(measure.time_kernel(c.jitted(), runs=10,
                                             drop=2).min_s)

    # 2. black-box fit (§4.3) --------------------------------------------
    model = fit.fit_relative(pvs, times, device=f"quickstart-{dev.type}",
                             ridge=1e-4)
    rep = fit.fit_report(model, pvs, times)
    print(f"fit geomean rel err on the library: {rep['geomean_rel_err']:.2%}")

    # 3. predict a kernel the fit never saw -------------------------------
    gen = torch.Generator(dev).manual_seed(0)
    a = torch.rand((HELD_OUT_N, HELD_OUT_N), generator=gen, device=dev)
    pv = extract.extract_graph(my_kernel, a)   # symbolic -> concrete counts
    predicted = model.predict(pv)              # <alpha, p> inner product
    with torch.no_grad():
        actual = measure.time_kernel(lambda: my_kernel(a), runs=10,
                                     drop=2).min_s
    rel_err = abs(predicted - actual) / actual
    print(f"\nheld-out kernel ({HELD_OUT_N}x{HELD_OUT_N} matmul+pointwise):")
    print(f"  predicted {predicted*1e3:7.3f} ms")
    print(f"  actual    {actual*1e3:7.3f} ms")
    print(f"  rel err   {rel_err:7.2%}")
    assert math.isfinite(predicted) and predicted > 0, predicted

    # 4. what the time is made of (Table-2-style attribution) ------------
    print("\ncost attribution:")
    rows = list(model.breakdown(pv).items())[:5]
    for k, v in rows:
        print(f"  {k:<20} {v*1e6:8.1f} µs")
    return {"device": str(dev), "cases": len(cases),
            "fit_geomean_rel_err": rep["geomean_rel_err"],
            "predicted_s": predicted, "actual_s": actual,
            "rel_err": rel_err, "breakdown": dict(rows)}


if __name__ == "__main__":
    main()
