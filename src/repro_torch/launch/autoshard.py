"""Cost-model-driven autosharding search — the paper's §6.2 future-work item
('select the optimal set of kernel configurations'), realized at the
distributed-plan level.

Enumerates candidate ``Plan``s for an (arch × shape) cell — optionally
crossed with every mesh factorization of a device count — and scores the
WHOLE space through the array-batched search engine (``core.planspace``):
compiled property vectors over array environments, vectorized HBM
feasibility, one weighted sum for the scores.  The paper's 'small inner
product' evaluation speed is exactly what makes an exhaustive
(plan × mesh) sweep cheap; ``benchmarks/search_bench.py`` records the
batched engine's speedup over the per-plan interpreted loop.

The cost model may be a registry device name (``--model gpu-h100``, the
card's: the model a calibration fitted there, else its datasheet seed) or
``--model tpu-v5e`` (the reference's analytic default, which ``search``
keeps for ``model=None``); the CLI defaults to ``gpu-h100``.  The step
programs compose the card's kernels (``kernels=None``) or, with
``kernels=kernelmodel.PALLAS_KERNELS``, the reference's Pallas blocks.
Nothing here touches a device: the search is numpy on the host.

    PYTHONPATH=src python -m repro_torch.launch.autoshard --arch glm4-9b \
        --shape train_4k

    # sweep every mesh factorization of 1024 devices, co-tune kernel blocks
    PYTHONPATH=src python -m repro_torch.launch.autoshard --arch glm4-9b \
        --shape train_4k --devices 1024 --tune-kernels
"""
from __future__ import annotations

import argparse
import itertools
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import SHAPES, ShapeConfig, shape_applicable
from repro_torch.configs.registry import ARCHS
from repro_torch.core import planspace, predictor
from repro_torch.core import workload as wl
from repro_torch.distributed.plan import Plan, plan_for
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import report as _obs_report
from repro_torch.obs import trace as _obs_trace

#: a ranked search result: (predicted seconds, plan, mesh shape); with
#: ``tune_kernels`` a fourth element carries {kernel: block sizes}
Ranked = Tuple[float, Plan, Dict[str, int]]
RankedTuned = Tuple[float, Plan, Dict[str, int], Dict[str, Dict[str, int]]]


def candidate_plans(cfg, workload: wl.WorkloadLike, multi_pod: bool = False
                    ) -> List[Plan]:
    """The search space: fsdp × sequence-parallel × microbatches × remat ×
    compression × (EP for MoE) × cache-seq sharding (decode)."""
    shape = wl.as_spec(workload)
    dp = ("pod", "data") if multi_pod else ("data",)
    base = plan_for(cfg, shape, multi_pod=multi_pod)
    out = []
    if shape.kind == "train":
        for fsdp, sp, m, remat, compress in itertools.product(
                (True, False), (True, False), (1, 2, 4, 8, 16),
                ("full", "dots", "none"), (None, "int8_ef")):
            if m > shape.global_batch:
                continue
            out.append(base.with_(dp_axes=dp, fsdp=fsdp,
                                  sequence_parallel=sp, microbatches=m,
                                  remat_policy=remat, compression=compress))
    elif shape.kind == "prefill":
        for fsdp, sp in itertools.product((True, False), (True, False)):
            out.append(base.with_(dp_axes=dp, fsdp=fsdp,
                                  sequence_parallel=sp))
    else:  # decode
        for fsdp, cache_seq in itertools.product(
                (True, False), ((), ("model",))):
            out.append(base.with_(dp_axes=dp, fsdp=fsdp,
                                  cache_seq_axes=cache_seq))
    if cfg.moe is not None:
        out += [p.with_(moe_mode="ep") for p in out]
    return out


def candidate_meshes(workload: wl.WorkloadLike, *, multi_pod: bool = False,
                     n_devices: Optional[int] = None
                     ) -> List[Dict[str, int]]:
    """The mesh side of the space.  Default: the fixed 16×16 pod (2×16×16
    multi-pod).  With ``n_devices``: every (data × model) factorization,
    minus train meshes whose data axis doesn't divide the global batch
    (training keeps exact batch semantics)."""
    shape = wl.as_spec(workload)
    if n_devices is None:
        return [{"pod": 2, "data": 16, "model": 16} if multi_pod
                else {"data": 16, "model": 16}]
    if multi_pod:
        raise ValueError(
            "multi_pod cannot be combined with an n_devices sweep: the "
            "factorization space is 2-axis (data × model) and would "
            "silently leave the pod axis at 1; drop --multi-pod or pass "
            "explicit meshes")
    meshes = planspace.mesh_factorizations(n_devices)
    if shape.kind == "train":
        # never empties: {data: 1, model: n} always divides the batch
        meshes = [m for m in meshes
                  if shape.global_batch % m["data"] == 0]
    return meshes


def search(arch: str, shape_name: str, *, multi_pod: bool = False,
           model: predictor.ModelLike = None, top_k: int = 5,
           n_devices: Optional[int] = None,
           meshes: Optional[Sequence[Mapping[str, int]]] = None,
           tune_kernels: bool = False,
           stream_chunk_cells: Optional[int] = None, kernels=None
           ) -> "List[Ranked] | List[RankedTuned]":
    """Rank (plan × mesh) candidates under ``model`` (a ``LinearCostModel``,
    a registry device name, or None for the analytic v5e seed).

    Returns ``(seconds, plan, mesh)`` triples, best first.  By default the
    mesh side is the fixed 16×16 pod (unchanged picks vs. the pre-engine
    search); pass ``n_devices`` to sweep every mesh factorization, or
    ``meshes`` for an explicit list.  With ``tune_kernels`` each returned
    cell is additionally co-tuned at kernel granularity
    (``planspace.cotune_kernel_blocks``) and the triples become
    ``(seconds, plan, mesh, {kernel: blocks})`` quadruples.

    ``stream_chunk_cells`` switches to the streaming engine
    (``planspace.stream_topk``): the space scores in bounded-memory chunks
    with HBM-infeasible cells pruned from the running top-k pool — the
    way to sweep candidate spaces far past RAM (it does not degrade to
    least-infeasible when nothing fits; the fully-materialized path does).

    ``kernels``: the kernel registry the step programs compose and the
    co-tuning sweeps (None: the card's, ``kernelmodel.KERNELS``).
    """
    cfg = ARCHS[arch]
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise ValueError(why)
    spec = wl.from_shape(shape)  # one workload currency from here down
    # keep the unresolved form for co-tuning: autotune's block-choice memo
    # keys on registry names / None, not on resolved model objects
    raw_model = model
    model = predictor.resolve_model(model)  # resolve once for the sweep
    if meshes is None:
        meshes = candidate_meshes(spec, multi_pod=multi_pod,
                                  n_devices=n_devices)
    plans = candidate_plans(cfg, spec, multi_pod)

    if stream_chunk_cells is not None:
        ranked = planspace.stream_topk(
            cfg, spec, plans, meshes, model, k=top_k,
            chunk_cells=stream_chunk_cells,
            hbm_budget=predictor.HBM_BYTES, kernels=kernels)
    else:
        space = planspace.PlanSpace.from_product(cfg, spec, plans, meshes,
                                                 kernels=kernels)
        fits = space.feasible_mask()
        if fits.any():
            space = space.subset(fits)
        else:  # degrade gracefully: report least-infeasible
            order = np.argsort(space.peak_bytes(), kind="stable")
            space = space.subset(order[:max(top_k, 8)])
        ranked = space.rank(model, top_k=top_k)
    if tune_kernels:
        return [(s, p, m,
                 planspace.cotune_kernel_blocks(cfg, spec, p, m,
                                                raw_model, kernels=kernels))
                for s, p, m in ranked]
    return ranked


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--shape", default="train_4k", choices=sorted(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=5)
    ap.add_argument("--devices", type=int, default=None,
                    help="sweep every (data × model) factorization of this "
                         "device count instead of the fixed 16x16 mesh")
    ap.add_argument("--tune-kernels", action="store_true",
                    help="co-tune kernel block sizes for the ranked cells")
    ap.add_argument("--stream-chunk", type=int, default=None, metavar="N",
                    help="score the sweep in streamed chunks of ~N cells "
                         "(bounded memory; HBM-infeasible cells pruned)")
    ap.add_argument("--model", default="gpu-h100",
                    help="cost-model registry device name (default: "
                         "gpu-h100, the card's); see python -m "
                         "repro_torch.calibration --list")
    ap.add_argument("--trace-json", default=None, metavar="PATH",
                    help="write a Chrome-trace/Perfetto JSON of the sweep "
                         "(measured spans + predicted overlay)")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="dump the metrics registry (cache counters, "
                         "report-line tallies) as JSON")
    ap.add_argument("--explain", action="store_true",
                    help="print the basis-term attribution of the winning "
                         "cell (per-term seconds and cost categories)")
    args = ap.parse_args(argv)

    if args.trace_json:
        _obs_trace.enable(process_name="autoshard")

    # model provenance: which weights are scoring this sweep (source /
    # revision matter once online refits start bumping registry files)
    resolved = predictor.resolve_model(args.model)
    meta = resolved.meta
    prov = [f"device={resolved.device}",
            f"source={meta.get('source', 'analytic-seed')}"]
    if "revision" in meta:
        prov.append(f"revision={meta['revision']}")
    if "fit_geomean_rel_err" in meta:
        prov.append(f"fit_rel_err={meta['fit_geomean_rel_err']:.3f}")
    if "refit_epoch" in meta:
        prov.append(f"refit_epoch={meta['refit_epoch']}")
    _obs_report.emit("autoshard", text=f"cost model: {' '.join(prov)}")

    with _obs_trace.get_tracer().span("autoshard.search", arch=args.arch,
                                      shape=args.shape):
        ranked = search(args.arch, args.shape, multi_pod=args.multi_pod,
                        model=args.model, top_k=args.top,
                        n_devices=args.devices,
                        tune_kernels=args.tune_kernels,
                        stream_chunk_cells=args.stream_chunk)
    # None resolves to the built-in analytic seed, which an explicit
    # "--model tpu-v5e" does NOT (a fitted registry file would shadow it)
    model_label = args.model or "tpu-v5e analytic seed"
    mesh_label = (f"{args.devices}-device factorization sweep"
                  if args.devices
                  else ("2x16x16" if args.multi_pod else "16x16"))
    print(f"top-{args.top} plans for {args.arch} × {args.shape} "
          f"({mesh_label}, model={model_label}):")
    for entry in ranked:
        t, p, mesh = entry[0], entry[1], entry[2]
        mesh_s = "x".join(f"{k}={v}" for k, v in sorted(mesh.items()))
        print(f"  {t*1e3:9.2f} ms  [{mesh_s}] fsdp={p.fsdp} "
              f"sp={p.sequence_parallel} mb={p.microbatches} "
              f"remat={p.remat_policy} moe={p.moe_mode} "
              f"comp={p.compression} cache_seq={p.cache_seq_axes}")
        if args.tune_kernels:
            for kern, blocks in entry[3].items():
                print(f"{'':14}· {kern}: {blocks}")
    if args.explain and ranked:
        t, p, mesh = ranked[0][0], ranked[0][1], ranked[0][2]
        from repro_torch.obs.explain import score_explain
        exp = score_explain(ARCHS[args.arch],
                            wl.from_shape(SHAPES[args.shape]), p, mesh,
                            model=resolved)
        print("winning cell attribution:")
        print(exp.report())
    # persistent fused-program cache telemetry: a repeat invocation of the
    # same search reports "warm" (all programs loaded, zero compiles)
    from repro_torch.core import exprops
    print(exprops.disk_cache_report())

    if args.trace_json:
        _obs_trace.get_tracer().save(args.trace_json)
        print(f"[autoshard] trace written to {args.trace_json}")
    if args.metrics_json:
        _obs_metrics.REGISTRY.save_json(args.metrics_json)
        print(f"[autoshard] metrics written to {args.metrics_json}")


if __name__ == "__main__":
    main()
