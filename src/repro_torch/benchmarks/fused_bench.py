"""Fused-engine benchmark on the port, the counterpart of the reference's
``benchmarks/fused_bench.py``: the basis-program GEMV scorer
(``core.exprops`` + ``PlanSpace.scores``) against the per-key column engine
(``PlanSpace.scores_columns``) and the interpreted per-plan loop
(``predictor.predict_plans_loop``), plus a ≥1M-cell STREAMED sweep
(``planspace.stream_topk``) in bounded memory.

The bars are the reference's: fused ≥5× over the columns and ≥100× over
the loop, and the disabled tracer within 2 % of the uninstrumented path; a
missed bar prints a WARNING.  Scoring is numpy on the host under the card's
``gpu-h100`` on its CUDA kernels by default (``run(model=, kernels=)``
takes the reference's).  The streamed sweep prunes cells whose peak bytes
exceed one device's memory: the card's ``total_memory`` where a card is
present, else the H100's 80 GB (``plan.H100_HBM_BYTES``); never the
reference's v5e 16e9 unless it is passed (``run(hbm_budget=16e9)``).
``stream.rss_delta_mib`` is the growth of the process's peak resident
set over the sweep, so run it in a process of its own.

    PYTHONPATH=src python -m repro_torch.benchmarks.fused_bench \\
        [--arch glm4-9b] [--shape train_4k] [--target-cells 10000] \\
        [--stream-cells 1000000] [--repeats 5] [--out BENCH_torch_fused.json]
"""
from __future__ import annotations

import argparse
import resource
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.benchmarks.search_bench import build_space, time_fn, write
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCHS
from repro_torch.core import planspace, predictor
from repro_torch.distributed import plan as dplan
from repro_torch.kernels import ops as kops
from repro_torch.launch.autoshard import candidate_plans
from repro_torch.obs import trace as obs_trace

#: acceptance bars (the reference's)
SPEEDUP_BAR_COLUMNS = 5.0
SPEEDUP_BAR_LOOP = 100.0
#: observability must be free when off: fused scoring with the default
#: DISABLED tracer within 2% of the uninstrumented internal path
OBS_OVERHEAD_BAR = 1.02
OUT = "BENCH_torch_fused.json"


def stream_meshes(plans, target_cells: int):
    """Mesh factorizations of every chip count 2, 3, … until the product
    space crosses ``target_cells`` — the irregular many-mesh side of the
    streamed sweep."""
    meshes = []
    n = 2
    while len(plans) * len(meshes) < target_cells:
        meshes.extend(planspace.mesh_factorizations(n))
        n += 1
    return meshes


def device_memory() -> float:
    """One device's memory: the card's where there is one, else an H100's."""
    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(0).total_memory)
    return dplan.H100_HBM_BYTES


def run(arch: str = "glm4-9b", shape: str = "train_4k",
        target_cells: int = 10000, stream_cells: int = 1_000_000,
        chunk_cells: int = 65536, repeats: int = 5,
        model: predictor.ModelLike = kops.CARD_MODEL, kernels=None,
        hbm_budget: Optional[float] = None, out: str = OUT) -> dict:
    cfg, shp = ARCHS[arch], SHAPES[shape]
    model = predictor.resolve_model(model)
    budget = device_memory() if hbm_budget is None else hbm_budget
    plans, meshes = build_space(cfg, shp, target_cells)
    space = planspace.PlanSpace.from_product(cfg, shp, plans, meshes,
                                             kernels=kernels)
    n_cells = len(space)
    print(f"sweep: {len(plans)} plans × {len(meshes)} meshes = "
          f"{n_cells} cells ({arch} × {shape}, model {model.device})")

    def loop():
        return [predictor.predict_plans_loop(cfg, shp, plans, m, model,
                                             kernels=kernels)
                for m in meshes]

    # equivalence first (and cache warming): fused ≡ columns ≡ loop
    fused = space.scores(model)
    cols = space.scores_columns(model)
    looped = np.concatenate(loop())
    np.testing.assert_allclose(fused, cols, rtol=1e-9)
    np.testing.assert_allclose(   # from_product is plan-major; loop mesh-major
        fused.reshape(len(plans), len(meshes)),
        looped.reshape(len(meshes), len(plans)).T, rtol=1e-9)
    print("fused ≡ columns ≡ loop at rtol 1e-9")

    fused_s = time_fn(lambda: space.scores(model), repeats)
    cols_s = time_fn(lambda: space.scores_columns(model), repeats)
    loop_s = time_fn(loop, 1)

    # observability overhead: the public scores() consults the module
    # tracer (disabled by default); the internal _scores() is the
    # uninstrumented path.  The disabled delta must stay under the 2% bar;
    # the enabled timing (one span per sweep) is recorded for reference.
    raw_s = time_fn(lambda: space._scores(model), repeats)
    disabled_s = time_fn(lambda: space.scores(model), repeats)
    prev_tracer = obs_trace.set_tracer(obs_trace.Tracer(process_name="bench"))
    try:
        enabled_s = time_fn(lambda: space.scores(model), repeats)
    finally:
        obs_trace.set_tracer(prev_tracer)
    obs_overhead = disabled_s / raw_s if raw_s > 0 else 1.0

    # the streamed sweep: ≥1M cells, bounded memory, HBM pruning
    splans = candidate_plans(cfg, shp)
    smeshes = stream_meshes(splans, stream_cells)
    stream_stats: dict = {}
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    t0 = time.perf_counter()
    top = planspace.stream_topk(cfg, shp, splans, smeshes, model, k=10,
                                chunk_cells=chunk_cells, hbm_budget=budget,
                                stats=stream_stats, kernels=kernels)
    stream_t = time.perf_counter() - t0
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss

    result = {
        "benchmark": "fused_bench",
        "arch": arch,
        "shape": shape,
        "cells": n_cells,
        "us_per_cell": fused_s / n_cells * 1e6,
        "speedup": cols_s / fused_s,
        "baseline": "planspace_scores_columns",
        "repeats": repeats,
        "fused_s": fused_s,
        "columns_s": cols_s,
        "loop_s": loop_s,
        "columns_us_per_cell": cols_s / n_cells * 1e6,
        "loop_us_per_cell": loop_s / n_cells * 1e6,
        "loop_speedup": loop_s / fused_s,
        "scores_match_rtol": 1e-9,
        "model": model.device,
        "hbm_budget": budget,
        "obs": {
            "raw_s": raw_s,
            "disabled_s": disabled_s,
            "enabled_s": enabled_s,
            "overhead": obs_overhead,
            "enabled_overhead": enabled_s / raw_s if raw_s > 0 else 1.0,
            "bar": OBS_OVERHEAD_BAR,
        },
        "stream": {
            "cells": stream_stats.get("cells", 0),
            "seconds": stream_t,
            "us_per_cell": stream_t / max(stream_stats.get("cells", 1), 1)
                           * 1e6,
            "chunk_cells": chunk_cells,
            "top_k": len(top),
            "best_seconds": top[0][0] if top else None,
            "rss_delta_mib": (rss1 - rss0) / 1024.0,
            **stream_stats,
        },
    }
    print(f"loop:    {loop_s*1e3:9.1f} ms ({result['loop_us_per_cell']:.2f}"
          f" µs/cell)")
    print(f"columns: {cols_s*1e3:9.2f} ms "
          f"({result['columns_us_per_cell']:.3f} µs/cell)")
    print(f"fused:   {fused_s*1e3:9.3f} ms "
          f"({result['us_per_cell']:.4f} µs/cell)")
    print(f"speedup: {result['speedup']:.1f}x over columns, "
          f"{result['loop_speedup']:.0f}x over the interpreted loop")
    print(f"obs:     disabled-tracer overhead {100*(obs_overhead-1):+.2f}% "
          f"(bar +{100*(OBS_OVERHEAD_BAR-1):.0f}%), enabled "
          f"{100*(result['obs']['enabled_overhead']-1):+.2f}%")
    print(f"stream:  {stream_stats.get('cells', 0)} cells in "
          f"{stream_t:.2f} s, max chunk "
          f"{stream_stats.get('max_chunk_cells', 0)} cells, pool high-water "
          f"{stream_stats.get('pool_high_water', 0)}, "
          f"{stream_stats.get('pruned_cells', 0)} pruned above "
          f"{budget/1e9:.1f} GB")
    write(result, out)
    if result["speedup"] < SPEEDUP_BAR_COLUMNS:
        print(f"WARNING: fused speedup below the "
              f"{SPEEDUP_BAR_COLUMNS}x bar over the column engine")
    if result["loop_speedup"] < SPEEDUP_BAR_LOOP:
        print(f"WARNING: fused speedup below the "
              f"{SPEEDUP_BAR_LOOP}x bar over the interpreted loop")
    if obs_overhead > OBS_OVERHEAD_BAR:
        print(f"WARNING: disabled-tracer observability overhead "
              f"{obs_overhead:.3f}x exceeds the {OBS_OVERHEAD_BAR}x bar")
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="glm4-9b", choices=sorted(ARCHS))
    ap.add_argument("--shape", default="train_4k", choices=sorted(SHAPES))
    ap.add_argument("--target-cells", type=int, default=10000)
    ap.add_argument("--stream-cells", type=int, default=1_000_000)
    ap.add_argument("--chunk-cells", type=int, default=65536)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--model", default=kops.CARD_MODEL,
                    help="cost-model registry name (default: the card's)")
    ap.add_argument("--out", default=OUT)
    a = ap.parse_args(argv)
    return run(a.arch, a.shape, a.target_cells, a.stream_cells,
               a.chunk_cells, a.repeats, a.model, out=a.out)


if __name__ == "__main__":
    main()
