"""Runs one cell of the benchmark of ``repro_torch`` once, on the card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, traffic,
limits and metrics are found by name from ``BENCHMARK.json``.  The last
line on standard output is the result, one JSON object; the numbers that
decided ``correct`` are the last lines on standard error, each beside its
limit.  Without a CUDA device, or with fewer than the cell asks for, the
run exits with 2 and prints no result; if JAX or the JAX package was
loaded by the time the window closed, with 3.

Every cache the program or PyTorch keeps lies at a fixed path inside the
checkout: the kernels' ``nvcc`` builds in ``build/``, the rest under
``.bench_cache/``.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".bench_cache"
ENV = {
    "REPRO_TORCH_BUILD_DIR": str(ROOT / "build"),
    "REPRO_COMPILE_CACHE": str(CACHE / "exprops"),
    "TRITON_CACHE_DIR": str(CACHE / "triton"),
    "TORCH_EXTENSIONS_DIR": str(CACHE / "torch_extensions"),
    "TORCHINDUCTOR_CACHE_DIR": str(CACHE / "inductor"),
    "CUDA_CACHE_PATH": str(CACHE / "nv"),
    "USE_FLAX": "0",
    "USE_JAX": "0",
    "OMP_NUM_THREADS": "4",
}
#: top-level modules that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.update(ENV)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "bench")]

    import torch
    from benchkit import cells, manifest
    man = manifest.manifest()
    chips = manifest.cell(man, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = cells.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), T0, device="cuda", man=man)
    bad = forbidden_modules()
    if bad:
        print(f"run.py: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for k, v in result["compared"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
