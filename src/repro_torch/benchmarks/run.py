"""Benchmark dispatcher of the port — one module per paper table or figure
plus the framework-level analyses, the counterpart of the reference's
``benchmarks/run.py``.

    PYTHONPATH=src python -m repro_torch.benchmarks.run \\
        [--scale gpu|cpu|tiny] [--device cuda|cpu] [--only NAME]

  paper_table1          paper §5 Table 1 (fit + held-out test kernels)
  paper_table2          paper Table 2 (fitted weights, interpreted)
  predictor_validation  beyond-paper: whole-step prediction on the device
  search_bench          beyond-paper: (plan × mesh) sweep, interpreted loop
                        vs. the array-batched engine (core/planspace.py)
  roofline              the roofline of experiments/dryrun_torch.json
                        (run `python -m repro_torch.launch dryrun` first;
                        skipped with a notice if the record is absent)

The first three measure on ``--device`` (the card unless ``cpu`` is
given); the last two are numpy on the host.  An unknown name exits 2.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from repro_torch.core import mkernels

NAMES = ("paper_table1", "paper_table2", "predictor_validation",
         "search_bench", "roofline")
DRYRUN = os.path.join("experiments", "dryrun_torch.json")
MESHES = ("16x16", "2x16x16")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", default="gpu", choices=mkernels.SCALES,
                    help="measurement-kernel problem-size ladder")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--only", default=None,
                    help="run a single benchmark by name")
    args = ap.parse_args(argv)

    t0 = time.time()
    names = [args.only] if args.only else list(NAMES)
    measured = ["--scale", args.scale, "--device", args.device]
    results = {}
    for name in names:
        print(f"\n{'='*72}\n== repro_torch.benchmarks.{name}\n{'='*72}")
        if name == "paper_table1":
            from repro_torch.benchmarks import paper_table1
            results[name] = paper_table1.main(measured)
        elif name == "paper_table2":
            from repro_torch.benchmarks import paper_table2
            results[name] = paper_table2.main(measured)
        elif name == "predictor_validation":
            from repro_torch.benchmarks import predictor_validation
            results[name] = predictor_validation.main(measured)
        elif name == "search_bench":
            from repro_torch.benchmarks import search_bench
            results[name] = search_bench.main([])
        elif name == "roofline":
            from repro_torch.benchmarks import roofline
            if os.path.exists(DRYRUN):
                results[name] = {}
                for mesh in MESHES:
                    print(f"\n-- mesh {mesh} --")
                    results[name][mesh] = roofline.main([DRYRUN, "--mesh",
                                                         mesh])
            else:
                print(f"{DRYRUN} not found — run `PYTHONPATH=src python -m "
                      f"repro_torch.launch dryrun` first")
                results[name] = None
        else:
            print(f"unknown benchmark {name!r}", file=sys.stderr)
            sys.exit(2)
    print(f"\nall benchmarks done in {time.time()-t0:.0f}s")
    return results


if __name__ == "__main__":
    main()
