"""The three-term roofline of every dry-run cell on the H100 (the
counterpart of the reference's ``benchmarks/roofline.py``):

    compute    = flops      / 989e12      [bf16 dense tensor-core peak]
    memory     = bytes      / 3.35e12     [HBM3]
    collective = coll_bytes / 450e9       [NVLink, one direction]

The rates are the ``gpu-h100`` datasheet's (``calibration/seeds.py``),
never the reference's v5e ``PEAK = 197e12``, ``HBM = 819e9``, ``ICI =
3·50e9``.  ``launch/dryrun.py``'s records (``experiments/dryrun_torch.json``,
the reference's keys) hold per-rank flops and bytes, so the rank count
cancels: term = per-rank quantity / per-card rate.  ``model_flops`` is
``archcount``'s 6·N·D / 2·N_active·D closed form; ``useful_ratio`` (model
flops over the counted flops of every rank) flags remat or redundant work.

    PYTHONPATH=src python -m repro_torch.benchmarks.roofline \\
        experiments/dryrun_torch.json --mesh 16x16
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

from repro_torch.calibration import seeds
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCHS
from repro_torch.core import archcount

H100 = seeds.GPU_DATASHEETS["gpu-h100"]
PEAK = H100.matmul_flops[16]
HBM = H100.mem_bw
LINK = H100.link_bw
OUT_DIR = "experiments"


def model_flops(arch: str, shape_name: str) -> float:
    shape = SHAPES[shape_name]
    sc = archcount.counts_for(ARCHS[arch], shape)
    return sc.concrete_model_flops(
        {"B": shape.global_batch, "S": shape.seq_len})


def analyse(rec: Dict) -> Optional[Dict]:
    if rec.get("status") != "ok":
        return None
    n = rec["n_devices"]
    compute = rec["flops_per_device"] / PEAK
    memory = rec["bytes_per_device"] / HBM
    coll = sum(rec["collective_bytes_per_device"].values()) / LINK
    terms = {"compute": compute, "memory": memory, "collective": coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops(rec["arch"], rec["shape"])
    counted = rec["flops_per_device"] * n
    bound = max(terms.values())
    total = sum(terms.values())
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "compute_s": compute, "memory_s": memory, "collective_s": coll,
        "dominant": dominant,
        "model_flops": mf,
        "useful_ratio": mf / counted if counted else 0.0,
        # the dominant term over the additive model: 1.0 means perfectly
        # overlapped (the dominant term IS the step)
        "roofline_fraction": bound / total if total else 0.0,
        "step_bound_s": bound,
    }


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path", nargs="?",
                    default=os.path.join(OUT_DIR, "dryrun_torch.json"))
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--out", default=OUT_DIR)
    a = ap.parse_args(argv)
    with open(a.path) as f:
        records = json.load(f)
    rows, skips = [], []
    for rec in records:
        if rec["mesh"] != a.mesh:
            continue
        if rec["status"] == "skip":
            skips.append(rec)
            continue
        r = analyse(rec)
        if r:
            rows.append(r)

    hdr = (f"{'arch':<17}{'shape':<13}{'compute':>10}{'memory':>10}"
           f"{'collect':>10}{'dominant':>11}{'useful':>8}{'roofl%':>8}")
    print(hdr)
    print("-" * len(hdr))
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        print(f"{r['arch']:<17}{r['shape']:<13}"
              f"{r['compute_s'] * 1e3:9.2f}m{r['memory_s'] * 1e3:9.2f}m"
              f"{r['collective_s'] * 1e3:9.2f}m{r['dominant']:>11}"
              f"{r['useful_ratio']:8.2f}{r['roofline_fraction'] * 100:7.1f}%")
    for s in skips:
        print(f"{s['arch']:<17}{s['shape']:<13}{s['why']}")

    os.makedirs(a.out, exist_ok=True)
    with open(os.path.join(a.out, f"torch_roofline_{a.mesh}.json"),
              "w") as f:
        json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
