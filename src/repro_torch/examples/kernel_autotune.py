"""Cost-model-guided block-size autotuning of the card's CUDA kernels, end
to end (the counterpart of the reference's ``examples/kernel_autotune.py``).

Demonstrates the kernel-level prediction granularity (paper §6.2: use the
fitted model to "select the optimal set of kernel configurations"):

  1. enumerate the tiles the CUDA source builds for a kernel + shape
     (``kernels/autotune.candidate_configs`` over ``kernelmodel.KERNELS``);
  2. score EVERY candidate through a registry model with ONE compiled
     vectorized sweep (``Expr.compile``) — and check it against per-point
     interpreted ``Expr.eval`` at rtol 1e-12, with the speedup;
  3. compare the model-chosen tile across two GPUs (the cross-GPU claim:
     same property vectors, different weights, different winners
     possible), ``gpu-h100`` and ``gpu-a100``;
  4. run the hand-written matmul with ``block_sizes="auto"`` on the device
     and check it against ``kernels/ref.matmul``.

Deviation from the reference: it ranks under ``tpu-v5e`` too; here the v5e
column is dropped, since a CUDA tile's shared-memory footprint and blocks
an SM mean nothing on a v5e.

    PYTHONPATH=src python -m repro_torch.examples.kernel_autotune \\
        [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.examples import add_device_arg, device
from repro_torch.kernels import autotune, ops, ref

MODELS = ("gpu-h100", "gpu-a100")
#: the reference's four sweeps
SWEEPS = (
    ("matmul", {"M": 4096, "N": 4096, "K": 4096, "bits": 16}),
    ("flash_attention", {"B": 8, "H": 32, "KVH": 8, "Sq": 8192,
                         "Skv": 8192, "dh": 128, "causal": True,
                         "window": None, "bits": 16}),
    ("ssd_scan", {"Bz": 8, "H": 64, "L": 8192, "P": 64, "N": 128,
                  "bits": 16}),
    ("transpose", {"M": 8192, "N": 8192, "bits": 32}),
)
AUTO_SHAPES = ((256, 512), (512, 384))


def sweep(kernel: str, shape: dict, models=MODELS) -> dict:
    cands = autotune.candidate_configs(kernel, shape)
    print(f"\n=== {kernel} {shape} — {len(cands)} candidates ===")

    # compiled vs interpreted scoring (identical results, one is a sweep);
    # warm once so the one-time Expr.compile codegen isn't in the timing
    autotune.score_configs(kernel, shape, cands)
    t0 = time.perf_counter()
    compiled = autotune.score_configs(kernel, shape, cands)
    t_c = time.perf_counter() - t0
    t0 = time.perf_counter()
    interp = autotune.score_configs_interpreted(kernel, shape, cands)
    t_i = time.perf_counter() - t0
    np.testing.assert_allclose(compiled, interp, rtol=1e-12)
    print(f"scoring: compiled {t_c*1e3:.2f} ms vs interpreted "
          f"{t_i*1e3:.2f} ms  ({t_i/t_c:.1f}x)")

    winners = {}
    for name in models:
        ranked = autotune.rank_block_sizes(kernel, shape, name)
        best_s, best = ranked[0]
        worst_s, _ = ranked[-1]
        winners[name] = {"blocks": best, "seconds": best_s,
                         "worst_seconds": worst_s}
        print(f"{name:>10s}: best {best}  "
              f"{best_s*1e6:8.1f} µs  (worst {worst_s*1e6:8.1f} µs, "
              f"{worst_s/best_s:.1f}x slower)")
    return {"kernel": kernel, "candidates": len(cands),
            "compiled_s": t_c, "interpreted_s": t_i,
            "speedup": t_i / t_c, "winners": winners}


def auto_kernel_check(dev: torch.device) -> dict:
    print(f"\n=== block_sizes='auto' correctness ({dev}) ===")
    gen = torch.Generator(dev).manual_seed(0)
    a = torch.randn(AUTO_SHAPES[0], generator=gen, device=dev)
    b = torch.randn(AUTO_SHAPES[1], generator=gen, device=dev)
    o = ops.matmul(a, b, block_sizes="auto")
    want = ref.matmul(a, b)
    np.testing.assert_allclose(o.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-3, rtol=1e-5)
    shape = {"M": a.shape[0], "K": a.shape[1], "N": b.shape[1], "bits": 32}
    blocks = autotune.best_block_sizes("matmul", shape,
                                       ops.default_model(a))
    print("auto-tuned matmul matches reference:", blocks)
    return {"blocks": blocks,
            "max_abs_err": float((o - want).abs().max())}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_arg(ap)
    dev = device(ap.parse_args(argv).device)
    out = {"sweeps": [sweep(k, s) for k, s in SWEEPS]}
    out["auto"] = auto_kernel_check(dev)
    return out


if __name__ == "__main__":
    main()
