"""Fleet churn walkthrough: allocate the demo manifest across two device
pools, shrink a pool mid-run (watch the degradation ladder warm-replan one
job and migrate another), then grow it back and watch the
hysteresis-damped resume/rebalance path (the counterpart of the
reference's ``examples/fleet_churn.py``).

    PYTHONPATH=src python -m repro_torch.examples.fleet_churn

Host only: the pools are names priced by their registry models
(``gpu-a100``, ``tpu-v5e``) on the card's kernel composition;
``run(kernels=kernelmodel.PALLAS_KERNELS)`` reproduces the reference's
history byte for byte.
"""
from __future__ import annotations

import argparse

from repro_torch.launch.fleet import FleetAllocator, demo_manifest
from repro_torch.runtime.faults import FaultInjector, FaultPlan
from repro_torch.runtime.fleet_supervisor import FleetSupervisor, SimJobRunner

CHURN = "pool_shrink@5:pool=a100,k=2;pool_grow@10:pool=a100,k=2"
SEED = 7
STEPS = 14


def show(tag, assignment):
    print(f"\n== {tag} ==")
    for name, p in sorted(assignment.placements.items()):
        mesh = "x".join(f"{k}={v}" for k, v in p.mesh)
        print(f"  {name:9s} -> {p.pool}:{p.devices} ({p.device}) "
              f"mesh {mesh} pred {p.predicted_step_s * 1e3:.2f} ms "
              f"({p.tokens_per_s:,.0f} tok/s)")
    for name, why in sorted(assignment.paused.items()):
        print(f"  {name:9s} -> PAUSED ({why})")


def run(kernels=None) -> dict:
    manifest = demo_manifest()

    # phase 1: model-guided allocation over the heterogeneous pools
    allocator = FleetAllocator(manifest, kernels=kernels)
    assignment = allocator.allocate()
    show("initial allocation", assignment)
    stats = allocator.cache_stats()
    print(f"  basis cache after allocate: {stats['hits']} hits / "
          f"{stats['misses']} misses")

    # phase 2: seeded churn — shrink a100 by 2 at step 5 (ladder:
    # warm replan -> migrate), grow it back at step 10 (hysteresis-
    # damped resume/rebalance)
    plan = FaultPlan.parse(CHURN, seed=SEED)
    sup = FleetSupervisor(allocator, assignment=assignment,
                          injector=FaultInjector(plan),
                          runner_factory=SimJobRunner.factory())
    sup.run(STEPS)
    show("after churn", sup.assignment)
    print(f"  ladder actions: {sup.actions}")

    # phase 3: the placement history is the audit trail — same manifest
    # + same FaultPlan seed reproduces it byte-for-byte
    events = [e["event"] for e in sup.placement_history]
    print(f"  history events: {events}")
    return {"actions": dict(sup.actions), "events": events,
            "history_json": sup.history_json(),
            "placements": {n: (p.pool, p.devices)
                           for n, p in sup.assignment.placements.items()},
            "paused": dict(sup.assignment.paused)}


def main(argv=None) -> dict:
    argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]).parse_args(argv)
    return run()


if __name__ == "__main__":
    main()
