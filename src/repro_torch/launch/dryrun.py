"""Multi-pod dry run on a fake world: the per-rank costs of every (arch ×
shape) cell on the production meshes, on a host with no card.

For each cell the step ``step_and_specs`` gives runs as a DTensor program
(``specs.sharded``) over ``make_fake_production_mesh``'s (16, 16) or (2, 16,
16) mesh of the ``fake`` backend, on fake tensors standing for the card's
(``runtime.flags.price_kernels``): no data, no allocation, no peer.  ``core.extract.extract_step`` counts what one
rank computes (flops and bytes of its local ops), the operand bytes of the
collectives it issues, and the bytes it holds at once.  The records keep the
reference's keys where the port has a counterpart; ``trace_s`` (the
seconds the counted run took) stands in the place of ``lower_s`` /
``compile_s``.

What is priced is the card's program: the hand-written
``flash_attention`` and ``ssd_scan`` kernels by their schedules
(``schedule_props``: the tiles each runs, causal tiles skipped), not run;
their backwards (torch ops) and every other op as they dispatch.  The
reference's default prices its XLA chunked attention instead (its
``pallas_enabled()`` is False); ``price_cell`` under
``runtime.flags.use_kernels(False)`` prices that path (the plain chunked
loops then dispatch, which at 32k takes minutes a cell;
``tests/test_torch_dryrun.py`` does so at ``train_4k``).  Each record names
its ``attention`` and ``ssd`` path.

Plans are sized for the card: ``plan_for(..., hbm_budget=)`` the H100's 80
GB (the ``gpu-h100`` catalog entry); each record prints its budget.

The launcher's ``dryrun`` command runs this in a process of its own: a
process has one default group, and the fake world is it.

Usage:
    PYTHONPATH=src python -m repro_torch.launch dryrun --arch llama3.2-3b \\
        --shape train_4k --mesh single --out /tmp/dryrun.json
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.configs.registry import ARCHS
from repro_torch.core import extract as cx
from repro_torch.distributed.plan import H100_HBM_BYTES, Plan, plan_for
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_fake_production_mesh
from repro_torch.models import moe
from repro_torch.runtime import flags


#: where the fake stand-ins live: the card's device type where this
#: PyTorch is built with CUDA (no card is touched: fake tensors hold no
#: memory), else the CPU, where autograd refuses even fake CUDA tensors.
#: On a CPU mesh DTensor moves a shard from one dim to another as an
#: all-gather and a chunk (its fallback for gloo, which has no
#: all-to-all), so there the collective kinds and the peak include that
#: fallback's whole-dim transients.
STANDIN_DEVICE = "cuda" if torch.backends.cuda.is_built() else "cpu"


def _fake_shard(device: str):
    def make_local(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)
    return make_local


def price_cell(cfg, shape, mesh, plan: Plan) -> cx.CompiledCosts:
    """Per-rank costs of ``step_and_specs(cfg, shape, mesh, plan)``'s step
    on fake tensors over ``mesh`` (whose group may be a fake world), the
    kernels priced (``flags.price_kernels``).  The stand-ins live on the
    mesh's device type (``STANDIN_DEVICE``)."""
    step_fn, arg_specs, in_sh, out_sh = specs.step_and_specs(cfg, shape,
                                                             mesh, plan)
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = specs.shard_args(arg_specs, in_sh, mesh,
                                _fake_shard(mesh.device_type))
    # the step runs outside the mode: its fake arguments keep every result
    # fake, while DTensor's own host arithmetic (shard sizes and offsets of
    # the redistribution planner) stays real, which under the mode it
    # cannot be
    with flags.price_kernels():
        return cx.extract_step(
            specs.sharded(step_fn, mesh, plan, in_sh, out_sh), *args)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             plan: Optional[Plan] = None, verbose: bool = True) -> Dict:
    """Price one cell on the fake production mesh; its dry-run record."""
    cfg = ARCHS[arch]
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    rec: Dict = {"arch": arch, "shape": shape_name,
                 "mesh": "2x16x16" if multi_pod else "16x16"}
    if ok and cfg.moe is not None and cfg.moe.dropless:
        ok, why = False, moe.NO_SHARDED_DISPATCH
    if not ok:
        rec["status"] = "skip"
        rec["why"] = why
        return rec

    mesh = make_fake_production_mesh(multi_pod=multi_pod,
                                     device=STANDIN_DEVICE)
    hbm_budget = H100_HBM_BYTES
    plan = plan or plan_for(cfg, shape, multi_pod=multi_pod,
                            hbm_budget=hbm_budget)
    t0 = time.time()
    costs = price_cell(cfg, shape, mesh, plan)
    t_trace = time.time() - t0
    rec.update({
        "status": "ok",
        "plan": {
            "fsdp": plan.fsdp, "microbatches": plan.microbatches,
            "sequence_parallel": plan.sequence_parallel,
            "moe_mode": plan.moe_mode,
            "cache_seq_axes": list(plan.cache_seq_axes),
            "compression": plan.compression,
            "remat": plan.remat_policy or cfg.remat_policy,
        },
        "hbm_budget": hbm_budget,
        "standin_device": mesh.device_type,
        "n_devices": int(mesh.size()),
        "flops_per_device": costs.flops,
        "bytes_per_device": costs.bytes_accessed,
        "collective_bytes_per_device": costs.collective_bytes,
        "peak_bytes_per_device": costs.peak_bytes_per_device,
        "attention": "flash_attention kernel (schedule-priced, causal "
                     "tiles skipped)" if cfg.n_heads else None,
        "ssd": "ssd_scan kernel (schedule-priced)" if cfg.ssm is not None
               else None,
        "kernels_priced": costs.kernels,
        "trace_s": round(t_trace, 2),
    })
    if verbose:
        print(f"[{rec['mesh']}] {arch} × {shape_name}: "
              f"flops/dev={costs.flops:.3e} "
              f"bytes/dev={costs.bytes_accessed:.3e} "
              f"coll={ {k: f'{v:.2e}' for k, v in costs.collective_bytes.items()} } "
              f"peak={costs.peak_bytes_per_device / 1e9:.2f}GB "
              f"budget={hbm_budget / 1e9:.1f}GB (trace {t_trace:.1f}s)",
              flush=True)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all",
                    help="architecture id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=("single", "multi", "both"))
    ap.add_argument("--out", default="experiments/dryrun_torch.json")
    args = ap.parse_args(argv)

    archs = sorted(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    records, failures = [], []
    for multi in meshes:
        for a in archs:
            for s in shapes:
                try:
                    rec = run_cell(a, s, multi_pod=multi)
                except Exception as e:  # a failure here is a bug in the port
                    traceback.print_exc()
                    rec = {"arch": a, "shape": s,
                           "mesh": "2x16x16" if multi else "16x16",
                           "status": "fail",
                           "error": f"{type(e).__name__}: {e}"}
                    failures.append(rec)
                records.append(rec)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(records, f, indent=1)

    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skip" for r in records)
    print(f"\ndry-run: {n_ok} ok, {n_skip} skip (documented), "
          f"{len(failures)} FAILED -> {args.out}")
    if failures:
        for r in failures:
            print(f"  FAIL {r['mesh']} {r['arch']} × {r['shape']}: "
                  f"{r['error']}")
        raise SystemExit(1)


if __name__ == "__main__":
    main()
