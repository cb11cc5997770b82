"""Fleet churn-replan benchmark on the port, the counterpart of the
reference's ``benchmarks/fleet_bench.py``.

Times the three latencies the churn-tolerant fleet story rests on:

  * **cold allocate** — pricing the full (job × pool × count × plan ×
    mesh) space of the demo manifest from empty ``BasisCache``s;
  * **warm fleet replan** — the ``FleetSupervisor`` degradation-ladder
    repair after a ``pool_shrink``, re-scoring against the caches the
    allocation warmed (the latency a live churn event actually pays);
  * **single-job warm replan** — one ``elastic.replan`` warm rescore,
    measured in-process so the bar is robust to the machine's speed.

Bars (the reference's; a missed one prints a WARNING):
  * ``warm_replan_s <= 10 × single_warm_replan_s``;
  * ``cache_reuse >= 0.5`` — at least half the basis columns a warm
    fleet replan touches come back from the allocation-warmed caches.

The demo manifest prices its ``a100`` pool with ``gpu-a100`` and its
``v5e`` pool with ``tpu-v5e``: its predictions are the planner's for those
pools, on the card's kernel composition (``kernels=None``;
``run(kernels=kernelmodel.PALLAS_KERNELS)`` gives the reference's).  The
times are host seconds of the machine it runs on; nothing touches a
device.

    PYTHONPATH=src python -m repro_torch.benchmarks.fleet_bench \\
        [--repeats 5] [--registry DIR] [--out BENCH_torch_fleet.json]
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

from repro_torch.benchmarks.search_bench import time_fn, write
from repro_torch.calibration import registry
from repro_torch.configs.registry import ARCHS
from repro_torch.core import exprops
from repro_torch.distributed import elastic
from repro_torch.launch.fleet import FleetAllocator, demo_manifest
from repro_torch.runtime.fleet_supervisor import FleetSupervisor, SimJobRunner

RATIO_BAR = 10.0
CACHE_REUSE_BAR = 0.5
OUT = "BENCH_torch_fleet.json"


def run(repeats: int = 5, registry_dir: Optional[str] = None, kernels=None,
        out: str = OUT) -> dict:
    manifest = demo_manifest()

    # ---- cold allocate: fresh allocator, empty caches -------------------
    t0 = time.perf_counter()
    allocator = FleetAllocator(manifest, registry_dir=registry_dir,
                               kernels=kernels)
    assignment = allocator.allocate()
    cold_allocate_s = time.perf_counter() - t0
    print(f"cold allocate: {len(assignment.placements)} jobs across "
          f"{len(manifest.pools)} pools in {cold_allocate_s*1e3:.2f} ms")

    # ---- warm fleet replan: the supervisor's pool_shrink repair ---------
    # each repeat rebuilds the supervisor on a fresh allocation (warm
    # caches) and times ONE ladder repair of a 2-device a100 shrink
    def one_repair() -> float:
        sup = FleetSupervisor(allocator,
                              runner_factory=SimJobRunner.factory(),
                              assignment=allocator.allocate())
        sup.capacity["a100"] -= 2
        t = time.perf_counter()
        sup._repair_pool("a100", step=2, kind="pool_shrink")
        return time.perf_counter() - t

    one_repair()                         # first repair may still miss
    h0, m0 = (allocator.cache_stats()["hits"],
              allocator.cache_stats()["misses"])
    warm_replan_s = min(one_repair() for _ in range(repeats))
    stats = allocator.cache_stats()
    dh, dm = stats["hits"] - h0, stats["misses"] - m0
    cache_reuse = dh / (dh + dm) if (dh + dm) else 1.0
    print(f"warm fleet replan: {warm_replan_s*1e3:.3f} ms "
          f"(cache reuse {cache_reuse*100:.1f}%: +{dh} hits / +{dm} "
          f"misses over {repeats} repairs)")

    # ---- single-job warm replan baseline --------------------------------
    job = manifest.jobs[0]
    cfg = ARCHS[job.arch]
    model = registry.load_model(manifest.pools[0].device, registry_dir)
    cache = exprops.BasisCache(maxsize=4096)

    def single():
        return elastic.replan(cfg, job.workload, 8, model, cache=cache,
                              kernels=kernels)

    single()                             # warm it
    single_warm_replan_s = time_fn(single, repeats)
    ratio = warm_replan_s / single_warm_replan_s
    print(f"single-job warm replan: {single_warm_replan_s*1e3:.3f} ms "
          f"-> fleet/single ratio {ratio:.1f}x (bar: <= {RATIO_BAR:.0f}x)")

    result = {
        "benchmark": "fleet_bench",
        "manifest": manifest.name,
        "jobs": len(manifest.jobs),
        "pools": len(manifest.pools),
        "repeats": repeats,
        "cold_allocate_s": cold_allocate_s,
        "warm_replan_s": warm_replan_s,
        "single_warm_replan_s": single_warm_replan_s,
        "warm_over_single_ratio": ratio,
        "ratio_bar": RATIO_BAR,
        "cache_reuse": cache_reuse,
        "cache_reuse_bar": CACHE_REUSE_BAR,
    }
    write(result, out)
    if ratio > RATIO_BAR:
        print(f"WARNING: warm fleet replan above the {RATIO_BAR:.0f}x "
              f"single-job bar")
    if cache_reuse < CACHE_REUSE_BAR:
        print("WARNING: BasisCache reuse below the 50% bar")
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--registry", default=None, metavar="DIR")
    ap.add_argument("--out", default=OUT)
    a = ap.parse_args(argv)
    return run(a.repeats, a.registry, out=a.out)


if __name__ == "__main__":
    main()
