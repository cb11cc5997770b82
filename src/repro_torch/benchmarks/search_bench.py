"""Search-space sweep benchmark on the port: the per-plan interpreted loop
against the array-batched engine (``core.planspace``), the counterpart of
the reference's ``benchmarks/search_bench.py``.

Builds a ≥10k-cell (plan × mesh-factorization) candidate space, scores it
twice — once through the per-plan path (``predictor.predict_plans_loop``:
per-plan ``plan_property_vector`` assembly + one ``predict_many``) and once
through ``PlanSpace.scores`` (compiled property vectors over array
environments) — checks the two agree at rtol 1e-9, and records wall times
and the speedup.  The bar is the reference's: ≥20× at ≥10k cells.

The scoring is numpy on the host; nothing touches a device.  The default
cost model is the card's, ``gpu-h100`` (a model fitted by the calibration
in the registry, else the H100 datasheet seed), composed on the card's
CUDA kernels (``kernels=None``); ``run(model="tpu-v5e",
kernels=kernelmodel.PALLAS_KERNELS)`` gives the reference's scores.  The
times are host seconds of the machine it runs on.

    PYTHONPATH=src python -m repro_torch.benchmarks.search_bench \\
        [--arch glm4-9b] [--shape train_4k] [--target-cells 10000] \\
        [--repeats 3] [--model gpu-h100] [--out BENCH_torch_search.json]
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List

import numpy as np

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCHS
from repro_torch.core import planspace, predictor
from repro_torch.kernels import ops as kops
from repro_torch.launch.autoshard import candidate_plans

#: chip counts whose factorizations make up the mesh side of the sweep;
#: mixed powers of two and 3·2^k so the dp/tp columns are irregular
DEVICE_LADDER = (256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096, 6144)
#: the reference's acceptance bar: batched over the loop at ≥10k cells
SPEEDUP_BAR = 20.0
OUT = "BENCH_torch_search.json"


def build_space(cfg, shape, target_cells: int):
    plans = candidate_plans(cfg, shape)
    meshes: List[Dict[str, int]] = []
    for n in DEVICE_LADDER:
        meshes.extend(planspace.mesh_factorizations(n))
        if len(plans) * len(meshes) >= target_cells:
            break
    return plans, meshes


def time_fn(fn, repeats: int) -> float:
    """The best wall seconds of ``repeats`` calls."""
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def write(result: dict, out: str) -> None:
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {out}")


def run(arch: str = "glm4-9b", shape: str = "train_4k",
        target_cells: int = 10000, repeats: int = 3,
        model: predictor.ModelLike = kops.CARD_MODEL, kernels=None,
        out: str = OUT) -> dict:
    cfg, shp = ARCHS[arch], SHAPES[shape]
    model = predictor.resolve_model(model)
    plans, meshes = build_space(cfg, shp, target_cells)
    n_cells = len(plans) * len(meshes)
    print(f"sweep: {len(plans)} plans × {len(meshes)} meshes = "
          f"{n_cells} cells ({arch} × {shape}, model {model.device})")

    # warm the compiled-vector caches so both paths time *evaluation*
    # (the loop path shares step_vector_fn's compiled closures too)
    space = planspace.PlanSpace.from_product(cfg, shp, plans, meshes,
                                             kernels=kernels)
    batched = space.scores(model)
    loop_ref = np.concatenate([
        predictor.predict_plans_loop(cfg, shp, plans, m, model,
                                     kernels=kernels)
        for m in meshes])
    # from_product is plan-major; the loop above is mesh-major per plan set
    np.testing.assert_allclose(
        batched.reshape(len(plans), len(meshes)),
        loop_ref.reshape(len(meshes), len(plans)).T, rtol=1e-9)

    def run_loop():
        for m in meshes:
            predictor.predict_plans_loop(cfg, shp, plans, m, model,
                                         kernels=kernels)

    def run_batched():
        planspace.PlanSpace.from_product(cfg, shp, plans, meshes,
                                         kernels=kernels).scores(model)

    loop_s = time_fn(run_loop, repeats)
    batched_s = time_fn(run_batched, repeats)
    speedup = loop_s / batched_s

    result = {
        "benchmark": "search_bench",
        "arch": arch,
        "shape": shape,
        "n_plans": len(plans),
        "n_meshes": len(meshes),
        "cells": n_cells,
        "n_cells": n_cells,            # legacy alias of "cells"
        "us_per_cell": batched_s / n_cells * 1e6,
        "speedup": speedup,
        "baseline": "predict_plans_loop",
        "repeats": repeats,
        "loop_s": loop_s,
        "batched_s": batched_s,
        "loop_us_per_cell": loop_s / n_cells * 1e6,
        "batched_us_per_cell": batched_s / n_cells * 1e6,
        "model": model.device,
        "scores_match_rtol": 1e-9,
    }
    print(f"loop:    {loop_s*1e3:9.1f} ms  "
          f"({result['loop_us_per_cell']:.2f} µs/cell)")
    print(f"batched: {batched_s*1e3:9.1f} ms  "
          f"({result['batched_us_per_cell']:.3f} µs/cell)")
    print(f"speedup: {speedup:.1f}x over {n_cells} cells")
    write(result, out)
    if speedup < SPEEDUP_BAR:
        print(f"WARNING: speedup below the {SPEEDUP_BAR:.0f}x acceptance "
              f"bar")
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="glm4-9b", choices=sorted(ARCHS))
    ap.add_argument("--shape", default="train_4k", choices=sorted(SHAPES))
    ap.add_argument("--target-cells", type=int, default=10000)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--model", default=kops.CARD_MODEL,
                    help="cost-model registry name (default: the card's)")
    ap.add_argument("--out", default=OUT)
    a = ap.parse_args(argv)
    return run(a.arch, a.shape, a.target_cells, a.repeats, a.model,
               out=a.out)


if __name__ == "__main__":
    main()
