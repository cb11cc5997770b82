#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json] [--seed 0] [--profile]

Builds the CUDA kernels from the sources in this checkout (one ``nvcc`` per
source, all started together), holds each kernel against its plain PyTorch
version on the card, then drives the port's main paths through the entry
points a user calls, each with random weights made on the device from the
seed, and checks that each path really went through its kernels (launch
counts set to 0 just before the path and read just after):

* the dense serving path of ``llama3.2-3b`` at full width and depth (bf16):
  prefill steps on tokens (4, 2048) and a decode server answering 16
  requests — the ``flash_attention`` kernel;
* the hybrid serving path of ``zamba2-2.7b`` at full width and depth (54
  Mamba2 layers, one shared attention block applied at 9 sites): the same
  prefill steps and server — the ``ssd_scan`` and ``flash_attention``
  kernels;
* the ssm path of ``mamba2-370m`` (48 layers): one prefill step — the
  ``ssd_scan`` kernel;
* the paper's calibration loop on the card: ``python -m
  repro_torch.calibration --device gpu-h100 --scale gpu`` (launch overhead,
  the 9 measurement classes timed under the 30-run/drop-4 protocol with
  their properties extracted from ATen graphs, the fit, the registry), then
  the held-out step: the model loaded back by name predicts the 4 held-out
  kernels, which are timed beside it — the ``matmul`` kernel (``mm_tiled``,
  ``skinny_mm``) and the ``transpose`` kernel (the tiled transpose).

Every phase prints one JSON line; any failure ends the run with a non-zero
exit code.  The last line is ``{"ok": true, "device": {...}}``.

It needs a GPU (it fails where ``torch.cuda.is_available()`` is false) and
``nvcc``; it imports ``torch`` and ``repro_torch`` only.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.calibration import __main__ as calib_cli  # noqa: E402
from repro_torch.calibration import registry  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core import extract, measure, mkernels, tkernels  # noqa: E402
from repro_torch.core import properties as props  # noqa: E402
from repro_torch.core.model import geomean, relative_error  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.kernels import transpose as tr  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.runtime import flags, steps  # noqa: E402
from repro_torch.runtime.server import DecodeServer, Request  # noqa: E402

DEV = "cuda"
ARCH = "llama3.2-3b"
HYBRID = "zamba2-2.7b"
SSM = "mamba2-370m"
PREFILL_TOKENS = (4, 2048)   # (batch, sequence) of one prefill step
PREFILL_STEPS = 3
SERVE = dict(slots=8, max_len=2048, requests=16, max_new=32,
             prompt_len=(16, 64))

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates).
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12      # outside the tensor cores
PEAK_HBM_BYTES = 3.35e12

# The reference's own case table for flash attention, plus edges the CUDA
# kernel masks itself (ragged lengths, head_dim below the padded width).
# B, H, KVH, Sq, Skv, dh, causal, window, dtype
FA_CASES = [
    ("mixed", 2, 4, 2, 256, 256, 64, True, None, torch.float32),
    ("mha", 1, 4, 4, 128, 128, 32, True, None, torch.float32),
    ("mqa", 1, 8, 1, 128, 128, 64, True, None, torch.float32),
    ("swa64", 2, 8, 2, 256, 256, 64, True, 64, torch.float32),
    ("noncausal_sq_ne_skv", 1, 2, 1, 128, 256, 64, False, None,
     torch.float32),
    ("bf16", 2, 4, 2, 256, 256, 64, True, None, torch.bfloat16),
    ("bf16_dh128_swa128", 1, 4, 2, 256, 256, 128, True, 128, torch.bfloat16),
    ("ragged_noncausal_dh48", 1, 4, 2, 100, 77, 48, False, None,
     torch.float32),
    ("ragged_swa_dh80", 2, 6, 3, 203, 203, 80, True, 50, torch.float32),
    ("dh16", 2, 4, 2, 40, 40, 16, True, None, torch.float32),
    ("bf16_ragged_dh128", 1, 6, 2, 333, 333, 128, True, None,
     torch.bfloat16),
]
# bf16: the reference's own tolerance.  f32: the reference's 3e-5 loosened
# to 1e-4 because the kernel sums the products in another order (4-wide
# partial sums over head_dim, online rescaling over key tiles) than the
# plain version's matrix products.
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}

# A whole prefill step, kernel path against plain path, relative Frobenius
# error of the logits.  f32: the two paths differ by summation order only.
# bf16: the kernels and their plain versions (both f32 inside) round a few
# outputs to neighbouring bf16 values, and the bf16 layers amplify that;
# 2e-2 was the first guess, the H100 gives about 3e-2 for llama3.2-3b while
# the f32 check holds 1e-4.  Beside each bf16 figure the script prints how
# far bf16 itself moves the logits (bf16 step against f32 step).
TOL_PREFILL_F32 = 1e-4
TOL_PREFILL_BF16 = 5e-2

# The reference's own case table for the SSD scan, plus edges: a chunk that
# is not a multiple of the kernel's 32-row strip, mamba2-370m's d_state at
# chunk 128, two groups, and the largest chunk at the largest d_state.
# Bz, H, G, L, P, N, chunk, dtype of x (B and C are f32 unless the case runs
# in the main path's layout, where they are slices of x's tensor)
SSD_CASES = [
    ("ref0", 2, 4, 1, 256, 32, 16, 64, torch.float32),
    ("ref1_g2", 1, 4, 2, 128, 64, 32, 32, torch.float32),
    ("ref2", 2, 2, 2, 128, 16, 64, 128, torch.float32),
    ("ref3_n128", 1, 4, 1, 256, 64, 128, 64, torch.float32),
    ("ref4_bf16", 2, 4, 1, 256, 32, 16, 64, torch.bfloat16),
    ("chunk100", 1, 2, 1, 200, 32, 16, 100, torch.float32),
    ("n128_chunk128", 1, 2, 1, 256, 64, 128, 128, torch.float32),
    ("g2_h4", 2, 4, 2, 256, 64, 64, 128, torch.bfloat16),
    ("n128_chunk256", 1, 2, 1, 512, 16, 128, 256, torch.float32),
]
# the reference's own tolerances (tests/test_kernels.py): y f32 5e-4, y bf16
# 3e-2, h_final 5e-4; chunk invariance 1e-4
SSD_TOL = {torch.float32: 5e-4, torch.bfloat16: 3e-2}
SSD_TOL_H = 5e-4
SSD_TOL_CHUNKS = 1e-4

# The reference's case table for matmul (tests/test_kernels.py MM_CASES),
# plus the paper's 16³ tile, ragged M/N/K and a ragged bf16 case.
# M, K, N, block, dtype
MM_CASES = [
    ("ref0", 256, 384, 512, 128, torch.float32),
    ("ref1", 128, 128, 128, 128, torch.float32),
    ("ref2", 512, 256, 256, 64, torch.float32),
    ("ref3_skinny", 256, 2048, 256, 128, torch.float32),
    ("ref4_bf16", 256, 256, 256, 128, torch.bfloat16),
    ("tile16", 256, 256, 256, 16, torch.float32),
    ("ragged_tile16", 100, 77, 53, 16, torch.float32),
    ("ragged_tile128", 1000, 333, 257, 128, torch.float32),
    ("bf16_ragged_tile64", 129, 65, 191, 64, torch.bfloat16),
]
# the reference's own tolerances: IEEE f32 products (TF32 would miss them)
MM_TOL = {torch.float32: (1e-3, 1e-5), torch.bfloat16: (1.0, 3e-2)}
# the reference's three transpose cases, then block 16, bf16 and ragged;
# the result must be exact (a copy of bits)
TR_CASES = [
    ("ref0", (256, 256), 128, torch.float32),
    ("ref1", (512, 256), 128, torch.float32),
    ("ref2", (128, 384), 64, torch.float32),
    ("block16", (256, 512), 16, torch.float32),
    ("bf16", (384, 256), 32, torch.bfloat16),
    ("ragged_block16", (100, 77), 16, torch.float32),
    ("bf16_ragged_block256", (333, 1000), 256, torch.bfloat16),
]
CALIB_DEVICE = "gpu-h100"    # the registry name of the fitted model
CALIB_SCALE = "gpu"
# the cases whose timing goes through a hand-written kernel
KERNEL_TIMED = {"mm_tiled_": "matmul", "skinny_mm_": "matmul",
                "transpose_tiled_": "transpose"}

LINES = []


def emit(obj) -> None:
    LINES.append(obj)
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    try:
        yield
    except BaseException as e:
        emit({"phase": name, "ok": False, "error": f"{type(e).__name__}: {e}"})
        raise
    torch.cuda.synchronize()
    emit({"phase": name + ".done", "ok": True,
          "seconds": round(time.perf_counter() - t0, 3)})


def time_ms(fn, warmup: int, iters: int) -> float:
    """Mean milliseconds per call, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def visible_pairs(Sq: int, Skv: int, causal: bool, window) -> int:
    """(q, k) pairs the mask lets through: the work this input needs."""
    q = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(q, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(q - window + 1, 0) if window is not None \
        else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def fa_inputs(B, H, KVH, Sq, Skv, dh, dtype, gen, as_main_path=True):
    """q, k, v as the main path hands them over: (B, S, H, dh) tensors viewed
    as (B, H, S, dh)."""
    def mk(S, heads):
        t = torch.randn((B, S, heads, dh), device=DEV, dtype=torch.float32,
                        generator=gen).to(dtype)
        return t.transpose(1, 2) if as_main_path \
            else t.transpose(1, 2).contiguous()
    return mk(Sq, H), mk(Skv, KVH), mk(Skv, KVH)


def compare(o, r, tol, rtol=None) -> float:
    """Max abs error of o against r; raises beyond ``tol`` abs + ``rtol``
    (default ``tol``) relative."""
    rtol = tol if rtol is None else rtol
    o, r = o.float(), r.float()
    err = (o - r).abs()
    bad = err > tol + rtol * r.abs()
    if not torch.isfinite(o).all() or bool(bad.any()):
        raise AssertionError(
            f"kernel disagrees with its plain version: max abs err "
            f"{float(err.max()):.3e}, tolerance {tol:g} abs / {rtol:g} rel, "
            f"{int(bad.sum())} of {bad.numel()} values out")
    return float(err.max())


# ---------------------------------------------------------------------------


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60
    ).stdout.strip().splitlines()[0].strip()
    # f32 products in IEEE f32 everywhere: mxu:32 means what it means in
    # the reference, and the library yardsticks compute what the kernels do
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "ok": True, "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
    return smi


def phase_build():
    t0 = time.perf_counter()
    logs = _build.build_all(extra_flags=("-Xptxas", "-v"), force=True)
    for name in _build.sources():
        _build.load(name)
    info = {}
    for name, log in logs.items():
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
        with open(_build.build_dir() / f"{name}.nvcc.log", "w") as f:
            f.write(log)
        info[name] = {"kernels_compiled": len(regs),
                      "max_registers": max(regs, default=None),
                      "max_spill_store_bytes": max(spills, default=None)}
    emit({"phase": "build", "ok": True,
          "seconds": round(time.perf_counter() - t0, 2),
          "build_dir": os.path.relpath(_build.build_dir(), ROOT),
          "sources": info})


def phase_kernel_cases(gen):
    """flash_attention against its plain version at the case table."""
    rows = []
    for (cid, B, H, KVH, Sq, Skv, dh, causal, window, dtype) in FA_CASES:
        for main_layout in (False, True):
            q, k, v = fa_inputs(B, H, KVH, Sq, Skv, dh, dtype, gen,
                                as_main_path=main_layout)
            o = kops.flash_attention(q, k, v, causal=causal, window=window,
                                     block_q=64, block_k=64)
            torch.cuda.synchronize()
            r = fa.attention_reference(q, k, v, causal=causal, window=window)
            err = compare(o, r, TOL[dtype])
        rows.append({"case": cid, "max_abs_err": err, "tol": TOL[dtype]})

    # tile-shape invariance: the result must not depend on the tiling
    q, k, v = fa_inputs(1, 2, 2, 256, 256, 64, torch.float32, gen)
    outs = [kops.flash_attention(q, k, v, block_q=bq, block_k=bk)
            for bq, bk in ((64, 64), (128, 64), (64, 128), (256, 256),
                           (32, 32), (32, 128))]
    torch.cuda.synchronize()
    inv = max(float((outs[0] - o).abs().max()) for o in outs[1:])
    if not all(torch.allclose(outs[0], o, atol=1e-5, rtol=1e-5)
               for o in outs[1:]):
        raise AssertionError(f"tile-shape invariance broken: {inv:.3e} "
                             "beyond 1e-5 abs/rel")
    emit({"phase": "kernels.cases", "ok": True, "kernel": "flash_attention",
          "cases": rows, "tile_invariance_max_abs_diff": inv})
    return rows


def phase_kernel_main_shape(cfg, B, S, gen):
    """flash_attention at a main path's shape: error, times, bound."""
    H, KVH, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    dtype = torch.bfloat16
    q, k, v = fa_inputs(B, H, KVH, S, S, dh, dtype, gen)
    o = kops.flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
    torch.cuda.synchronize()
    r = fa.attention_reference(q, k, v, causal=True,
                               window=cfg.sliding_window)
    err = compare(o, r, TOL[dtype])
    del o, r

    def kernel():
        kops.flash_attention(q, k, v, causal=True, window=cfg.sliding_window)

    def plain():
        fa.attention_reference(q, k, v, causal=True,
                               window=cfg.sliding_window)

    # the yardstick: one library call for the same function on the same
    # inputs.  Timed here only; the port never calls it.
    gqa = "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or "")
    if gqa:
        def library():
            F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                           enable_gqa=True)
    else:
        kr = k.repeat_interleave(H // KVH, dim=1)
        vr = v.repeat_interleave(H // KVH, dim=1)

        def library():
            F.scaled_dot_product_attention(q, kr, vr, is_causal=True)

    ms_a = time_ms(kernel, 2, 10)
    plain_ms = time_ms(plain, 1, 3)
    library_ms = time_ms(library, 2, 10)
    ms_b = time_ms(kernel, 1, 10)

    pairs = visible_pairs(S, S, True, cfg.sliding_window)
    flops = 4.0 * B * H * dh * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    ms = min(ms_a, ms_b)
    return {
        "arch": cfg.name,
        "shape": {"B": B, "H": H, "KVH": KVH, "Sq": S, "Skv": S, "dh": dh,
                  "dtype": "bfloat16", "causal": True,
                  "window": cfg.sliding_window,
                  "tile": list(fa.pick_tiles(128, 128, dh))},
        "max_abs_err": err, "tol": TOL[dtype],
        "ms": ms, "kernel_ms": ms, "kernel_ms_runs": [ms_a, ms_b],
        "plain_ms": plain_ms, "library_ms": library_ms,
        "library_call": "F.scaled_dot_product_attention("
                        + ("enable_gqa=True" if gqa else "k, v repeated") + ")",
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "flops": flops, "bytes": nbytes,
        "achieved_tflops": flops / (ms * 1e-3) / 1e12,
    }


# ---------------------------------------------------------------------------
# the SSD scan


def ssd_inputs(Bz, H, G, L, P, N, dtype, gen, as_main_path=True):
    """x, dt, A, B, C drawn as the reference's tests draw them (x 0.5·N(0,1),
    dt = softplus(N(0,1)), A = -exp(0.3·N(0,1)), B and C 0.3·N(0,1)).  As the
    main path hands them over: column slices of one (Bz, L, H·P + 2·G·N)
    tensor in x's type, viewed as (Bz, H, L, P) / (Bz, G, L, N), and dt a
    (Bz, L, H) tensor viewed as (Bz, H, L).  Otherwise contiguous, with B and
    C in f32."""
    def rn(*shape):
        return torch.randn(shape, device=DEV, generator=gen)
    x, Bm, Cm = 0.5 * rn(Bz, L, H, P), 0.3 * rn(Bz, L, G, N), \
        0.3 * rn(Bz, L, G, N)
    dt = F.softplus(rn(Bz, L, H)).transpose(1, 2)
    A = -torch.exp(0.3 * rn(H))
    if not as_main_path:
        return (x.transpose(1, 2).contiguous().to(dtype), dt.contiguous(), A,
                Bm.transpose(1, 2).contiguous(),
                Cm.transpose(1, 2).contiguous())
    xbc = torch.cat([t.reshape(Bz, L, -1) for t in (x, Bm, Cm)],
                    dim=-1).to(dtype)
    d, gn = H * P, G * N
    return (xbc[..., :d].reshape(Bz, L, H, P).transpose(1, 2), dt, A,
            xbc[..., d:d + gn].reshape(Bz, L, G, N).transpose(1, 2),
            xbc[..., d + gn:].reshape(Bz, L, G, N).transpose(1, 2))


def phase_ssd_cases(gen):
    """ssd_scan against the naive recurrence and its plain version at the
    case table, in both layouts, and across chunks."""
    rows = []
    for (cid, Bz, H, G, L, P, N, chunk, dtype) in SSD_CASES:
        err = herr = 0.0
        for main_layout in (False, True):
            x, dt, A, B, C = ssd_inputs(Bz, H, G, L, P, N, dtype, gen,
                                        as_main_path=main_layout)
            y, h = kops.ssd_scan(x, dt, A, B, C, chunk=chunk)
            torch.cuda.synchronize()
            for yr, hr in (kref.ssd(x, dt, A, B, C),
                           ssd.ssd_scan_reference(x, dt, A, B, C,
                                                  chunk=chunk)):
                err = max(err, compare(y, yr, SSD_TOL[dtype]))
                herr = max(herr, compare(h, hr, SSD_TOL_H))
        rows.append({"case": cid, "Bz": Bz, "H": H, "G": G, "L": L, "P": P,
                     "N": N, "chunk": chunk,
                     "dtype": str(dtype).replace("torch.", ""),
                     "p_block": ssd.tile(P, N, chunk)[0],
                     "max_abs_err": err, "tol": SSD_TOL[dtype],
                     "h_max_abs_err": herr, "h_tol": SSD_TOL_H})

    # chunk invariance: the result must not depend on the chunk
    x, dt, A, B, C = ssd_inputs(1, 2, 1, 256, 16, 16, torch.float32, gen)
    outs = [kops.ssd_scan(x, dt, A, B, C, chunk=c)[0]
            for c in (32, 64, 128, 256)]
    torch.cuda.synchronize()
    inv = max(float((outs[0] - o).abs().max()) for o in outs[1:])
    if not all(torch.allclose(outs[0], o, atol=SSD_TOL_CHUNKS,
                              rtol=SSD_TOL_CHUNKS) for o in outs[1:]):
        raise AssertionError(f"chunk invariance broken: {inv:.3e} beyond "
                             f"{SSD_TOL_CHUNKS:g} abs/rel")
    emit({"phase": "kernels.ssd.cases", "ok": True, "kernel": "ssd_scan",
          "layouts": ["contiguous", "main_path_strided"],
          "against": ["ref.ssd (sequential recurrence)",
                      "ssd_scan_reference (chunked plain version)"],
          "cases": rows, "chunk_invariance_max_abs_diff": inv,
          "chunk_invariance_tol": SSD_TOL_CHUNKS})
    return rows


def phase_ssd_main_shape(cfg, B, S, gen):
    """ssd_scan at a main path's prefill shape, in the main path's layout,
    with A as the model makes it: error, times, bound."""
    s = cfg.ssm
    H, P, N, G = cfg.ssm_heads, s.head_dim, s.d_state, s.n_groups
    Q = min(s.chunk, S)
    dtype = torch.bfloat16
    x, dt, _, Bm, Cm = ssd_inputs(B, H, G, S, P, N, dtype, gen)
    A = -torch.linspace(1.0, 16.0, H, device=DEV)
    y, h = kops.ssd_scan(x, dt, A, Bm, Cm, chunk=Q)
    torch.cuda.synchronize()
    yr, hr = ssd.ssd_scan_reference(x, dt, A, Bm, Cm, chunk=Q)
    err = compare(y, yr, SSD_TOL[dtype])
    herr = compare(h, hr, SSD_TOL_H)
    del y, h, yr, hr

    def kernel():
        kops.ssd_scan(x, dt, A, Bm, Cm, chunk=Q)

    def plain():
        ssd.ssd_scan_reference(x, dt, A, Bm, Cm, chunk=Q)

    ms_a = time_ms(kernel, 2, 10)
    plain_ms = time_ms(plain, 1, 3)
    ms_b = time_ms(kernel, 1, 10)

    # operations as the reference's schedule_props counts them; bytes: each
    # input read once, each output written once
    cells = B * H * (S // Q)
    flops = cells * 2.0 * (Q * Q * N + Q * Q * P + 2 * Q * P * N)
    nbytes = (2 * x.numel() * x.element_size()           # x in, y out
              + dt.numel() * 4 + A.numel() * 4
              + (Bm.numel() + Cm.numel()) * Bm.element_size()
              + B * H * P * N * 4)                         # h_final out
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    ms = min(ms_a, ms_b)
    p_block, smem = ssd.tile(P, N, Q)
    return {
        "arch": cfg.name,
        "shape": {"Bz": B, "H": H, "G": G, "L": S, "P": P, "N": N,
                  "chunk": Q, "dtype": "bfloat16",
                  "x_strides": list(x.stride()),
                  "p_block": p_block, "smem_bytes": smem},
        "max_abs_err": err, "tol": SSD_TOL[dtype],
        "h_max_abs_err": herr, "h_tol": SSD_TOL_H,
        "ms": ms, "kernel_ms": ms, "kernel_ms_runs": [ms_a, ms_b],
        "plain_ms": plain_ms, "library_ms": None, "library_call": None,
        "library_note": "no single PyTorch call computes the SSD scan",
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "ops_ms": t_ops * 1e3, "bytes_ms": t_bytes * 1e3,
        "flops": flops, "bytes": nbytes,
        "achieved_tflops": flops / (ms * 1e-3) / 1e12,
    }


# ---------------------------------------------------------------------------
# matmul and transpose, and the calibration path that runs them


def phase_matmul_cases(gen):
    """matmul against its plain version at the case table."""
    rows = []
    for (cid, M, K, N, blk, dtype) in MM_CASES:
        a = torch.randn((M, K), device=DEV, generator=gen).to(dtype)
        b = torch.randn((K, N), device=DEV, generator=gen).to(dtype)
        o = kops.matmul(a, b, block_m=blk, block_n=blk, block_k=blk)
        torch.cuda.synchronize()
        atol, rtol = MM_TOL[dtype]
        err = compare(o, mm.matmul_reference(a, b), atol, rtol)
        rows.append({"case": cid, "M": M, "K": K, "N": N, "block": blk,
                     "dtype": str(dtype).replace("torch.", ""),
                     "tile": list(mm.tile(M, N, K, blk, blk, blk)[:3]),
                     "max_abs_err": err, "atol": atol, "rtol": rtol})
    emit({"phase": "kernels.matmul.cases", "ok": True, "kernel": "matmul",
          "cases": rows})
    return rows


def phase_transpose_cases(gen):
    """transpose against its plain version at the case table: exact."""
    rows = []
    for (cid, shape, blk, dtype) in TR_CASES:
        x = torch.randn(shape, device=DEV, generator=gen).to(dtype)
        o = kops.transpose(x, block=blk)
        torch.cuda.synchronize()
        if not torch.equal(o, tr.transpose_reference(x)):
            raise AssertionError(f"transpose {cid}: not equal to x.t()")
        rows.append({"case": cid, "shape": list(shape), "block": blk,
                     "dtype": str(dtype).replace("torch.", ""),
                     "tile": tr.tile(blk, dtype)[0], "max_abs_err": 0.0,
                     "tol": "exact"})
    emit({"phase": "kernels.transpose.cases", "ok": True,
          "kernel": "transpose", "cases": rows})
    return rows


def largest_tiled(key: str) -> int:
    """n of the calibration's largest tiled case of a class (t = 3)."""
    return 2 ** (mkernels._P[CALIB_SCALE][key] + 3)


def phase_matmul_main_shape(gen):
    """matmul at the calibration's largest mm_tiled case, 16³ tile, f32."""
    n, g = largest_tiled("mm"), mkernels.GSIZE
    a = mkernels._rand(gen, (n, n), DEV)
    b = mkernels._rand(gen, (n, n), DEV)
    o = kops.matmul(a, b, block_m=g, block_n=g, block_k=g)
    torch.cuda.synchronize()
    atol, rtol = MM_TOL[torch.float32]
    err = compare(o, mm.matmul_reference(a, b), atol, rtol)
    del o

    def kernel():
        kops.matmul(a, b, block_m=g, block_n=g, block_k=g)

    def plain():
        mm.matmul_reference(a, b)

    def library():  # the yardstick, timed here only: torch.matmul, no TF32
        torch.matmul(a, b)

    def tile128():
        kops.matmul(a, b, block_m=128, block_n=128, block_k=128)

    ms_a = time_ms(kernel, 1, 5)
    plain_ms = time_ms(plain, 2, 10)
    library_ms = time_ms(library, 2, 10)
    tile128_ms = time_ms(tile128, 1, 5)
    ms_b = time_ms(kernel, 1, 5)
    flops = 2.0 * n ** 3
    nbytes = 3 * n * n * a.element_size()
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    ms = min(ms_a, ms_b)
    bm, bn, bk, smem = mm.tile(n, n, n, g, g, g)
    return {
        "shape": {"M": n, "K": n, "N": n, "dtype": "float32",
                  "block": [g, g, g], "tile": [bm, bn, bk],
                  "smem_bytes": smem},
        "max_abs_err": err, "atol": atol, "rtol": rtol,
        "ms": ms, "kernel_ms": ms, "kernel_ms_runs": [ms_a, ms_b],
        "plain_ms": plain_ms, "library_ms": library_ms,
        "library_call": "torch.matmul (allow_tf32=False)",
        "tile128_ms": tile128_ms,
        "tile128": list(mm.tile(n, n, n, 128, 128, 128)[:3]),
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "ops_ms": t_ops * 1e3, "bytes_ms": t_bytes * 1e3,
        "flops": flops, "bytes": nbytes,
        "achieved_tflops": flops / (ms * 1e-3) / 1e12,
        "tile128_tflops": flops / (tile128_ms * 1e-3) / 1e12,
    }


def phase_transpose_main_shape(gen):
    """transpose at the calibration's largest tiled transpose, 16² tile."""
    n, g = largest_tiled("transpose"), mkernels.GSIZE
    x = mkernels._rand(gen, (n, n), DEV)
    o = kops.transpose(x, block=g)
    torch.cuda.synchronize()
    if not torch.equal(o, tr.transpose_reference(x)):
        raise AssertionError("transpose at the main shape: not x.t()")
    del o

    def kernel():
        kops.transpose(x, block=g)

    def plain():
        tr.transpose_reference(x)

    def library():  # the yardstick, timed here only
        x.t().contiguous()

    def tile64():
        kops.transpose(x, block=64)

    ms_a = time_ms(kernel, 2, 10)
    plain_ms = time_ms(plain, 2, 10)
    library_ms = time_ms(library, 2, 10)
    tile64_ms = time_ms(tile64, 2, 10)
    ms_b = time_ms(kernel, 2, 10)
    nbytes = 2 * n * n * x.element_size()
    t_bytes = nbytes / PEAK_HBM_BYTES
    ms = min(ms_a, ms_b)
    return {
        "shape": {"M": n, "N": n, "dtype": "float32", "block": g,
                  "tile": tr.tile(g)[0]},
        "max_abs_err": 0.0, "tol": "exact",
        "ms": ms, "kernel_ms": ms, "kernel_ms_runs": [ms_a, ms_b],
        "plain_ms": plain_ms, "library_ms": library_ms,
        "library_call": "x.t().contiguous()", "tile64_ms": tile64_ms,
        "bound_ms": t_bytes * 1e3, "bound_by": "bytes", "bytes": nbytes,
        "achieved_tb_per_s": nbytes / (ms * 1e-3) / 1e12,
    }


def kernel_of(case: str):
    """The hand-written kernel a measurement or held-out case is timed
    through, or None."""
    return next((k for pre, k in KERNEL_TIMED.items()
                 if case.startswith(pre)), None)


@contextlib.contextmanager
def counted_timing(records: list):
    """Wrap every ``measure.time_kernel`` call: count the calls the timing
    makes of its callable and the kernel launches they make."""
    orig = measure.time_kernel

    def timed(fn, **kw):
        calls = [0]

        def counted():
            calls[0] += 1
            return fn()
        before = read_launches()
        res = orig(counted, **kw)
        after = read_launches()
        records.append({"calls": calls[0], "min_s": res.min_s,
                        "launches": {k: after[k] - before[k]
                                     for k in after}})
        return res
    measure.time_kernel = timed
    yield
    measure.time_kernel = orig


def check_counts(name: str, rec: dict) -> dict:
    """A kernel-timed case launches its kernel once per call of the timing,
    and nothing else; every other case launches no kernel of the port."""
    k = kernel_of(name)
    want = {n: (rec["calls"] if n == k else 0) for n in rec["launches"]}
    if rec["launches"] != want:
        raise AssertionError(f"{name}: launches {rec['launches']}, "
                             f"{rec['calls']} calls of the timing")
    return {"case": name, "kernel": k, "calls": rec["calls"],
            "launches": rec["launches"].get(k, 0) if k else 0}


def phase_calibrate(out_dir: str):
    """The CLI, as a user runs it, on the card; returns its result."""
    captured, records = {}, []
    orig = calib_cli.calibrate

    def capture(*a, **kw):
        captured["result"] = orig(*a, **kw)
        return captured["result"]
    calib_cli.calibrate = capture
    with counted_timing(records):
        rc = calib_cli.main(["--device", CALIB_DEVICE, "--scale",
                             CALIB_SCALE, "--out", out_dir])
    calib_cli.calibrate = orig
    res = captured["result"]
    if rc != 0 or len(records) != 1 + len(res.labels):
        raise AssertionError(f"calibration exit {rc}, {len(records)} timings "
                             f"for {len(res.labels)} kernels")
    counts = [check_counts(n, r) for n, r in zip(res.labels, records[1:])]
    w = res.model.weights
    if not np.isfinite(w).all():
        raise AssertionError("non-finite fitted weight")
    emit({"phase": "calibrate", "ok": True, "device": CALIB_DEVICE,
          "scale": CALIB_SCALE, "n_kernels": len(res.labels),
          "runs": res.model.meta["runs"], "drop": res.model.meta["drop"],
          "launch_overhead_us": res.launch_overhead_s * 1e6,
          "fit_geomean_rel_err": res.report["geomean_rel_err"],
          "fit_max_rel_err": res.report["max_rel_err"],
          "wall_s": res.wall_s,
          "weights": dict(zip(res.model.keys, [float(x) for x in w])),
          "times_s": {r["label"]: r["actual_s"] for r in res.report["rows"]},
          "kernel_timed": [c for c in counts if c["kernel"]]})
    return res


def phase_heldout(out_dir: str, res):
    """The held-out step: the model loaded back by name predicts the 16
    test cases, which are timed under the same protocol."""
    loaded = registry.load_model(CALIB_DEVICE, out_dir)
    if loaded.keys != res.model.keys \
            or not np.array_equal(loaded.weights, res.model.weights):
        raise AssertionError("the registered model differs from the fitted")
    rows, records = [], []
    with counted_timing(records), torch.no_grad():
        for c in tkernels.test_cases(CALIB_SCALE, device=DEV):
            pv = c.properties()
            pred = loaded.predict(pv)
            if pred != res.model.predict(pv) or not math.isfinite(pred):
                raise AssertionError(f"{c.name}: prediction {pred!r} not "
                                     "bit-identical to the fitted model's")
            t = measure.time_kernel(
                c.jitted(), min_time_s=4 * res.launch_overhead_s).min_s
            count = check_counts(c.name, records[-1])
            rows.append({"case": c.name, "class": c.klass, "actual_s": t,
                         "predicted_s": pred,
                         "rel_err": relative_error(pred, t),
                         "calls": count["calls"],
                         "launches": count["launches"]})
            del c
    classes = sorted({r["class"] for r in rows})
    per_class = {k: geomean(r["rel_err"] for r in rows if r["class"] == k)
                 for k in classes}
    emit({"phase": "heldout", "ok": True, "device": CALIB_DEVICE,
          "cases": rows, "geomean_rel_err_by_class": per_class,
          "geomean_rel_err": geomean(r["rel_err"] for r in rows),
          "paper_geomeans": {"Titan X": 0.16, "C2070": 0.14, "K40": 0.06,
                             "R9 Fury": 0.42}})
    return rows


def phase_closed_form():
    """A few property vectors at ``gpu`` scale against their closed forms
    (traced on meta stand-ins: nothing is allocated)."""
    P = mkernels._P[CALIB_SCALE]

    def meta(*shape):
        return torch.empty(shape, device="meta")
    n = 2 ** (P["s1"] + 8)
    pv = extract.extract_graph(mkernels._copy, meta(n))
    want = {props.mem_key("load", 32, "s1"): n,
            props.mem_key("store", 32, "s1"): n}
    m = 2 ** (P["naive"] + 3)
    pv_mm = extract.extract_graph(mkernels._naive_mm, meta(m, m), meta(m, m))
    v = 2 ** (P["vsa"] + 6)
    pv_vsa = extract.extract_graph(
        functools.partial(mkernels._vsa, s=2, lim=2 * v), meta(2 * v),
        meta(2 * v))
    got = {"s1_copy": {k: pv.get(k) for k in want},
           "mm_naive": pv_mm.get(props.mxu_key(32)),
           "vsa_s2": pv_vsa.get(props.mem_key("load", 32, "s2_1/2"))}
    if got["s1_copy"] != want or got["mm_naive"] != 2.0 * m ** 3 \
            or got["vsa_s2"] != 2.0 * v:
        raise AssertionError(f"closed-form counts: {got}")
    emit({"phase": "extract.closed_form", "ok": True, "scale": CALIB_SCALE,
          "counts": got, "n": {"s1_copy": n, "mm_naive": m, "vsa_s2": v}})


def phase_calibration_profile(seed: int):
    """Optional (--profile): device idle share of the multi-op cases (arith:
    64 steps of ~8 ops; conv: 49 taps) at both ends of the ladder."""
    P, Q = mkernels._P[CALIB_SCALE], tkernels._P[CALIB_SCALE]
    arith = [c for c in mkernels._arith_cases(P["arith"], DEV)
             if c.meta["kind"] == "exp"]
    conv = tkernels._conv_cases(Q["conv"], mkernels._generator(seed, DEV),
                                DEV)
    out = {}
    with torch.no_grad():
        for c in (arith[0], arith[-1], conv[0], conv[-1]):
            out[c.name] = _profile(c.jitted(), 3)
    emit({"phase": "calibrate.profile", "ok": True, "cases": out})


# ---------------------------------------------------------------------------
# the main paths

KERNELS = {"flash_attention": fa.flash_attention, "ssd_scan": ssd.ssd_scan,
           "matmul": mm.matmul, "transpose": tr.transpose}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def launches_per_step(cfg) -> dict:
    """The kernel launches one prefill step of ``cfg`` must make."""
    if cfg.family == "dense":
        return {"flash_attention": cfg.n_layers, "ssd_scan": 0,
                "matmul": 0, "transpose": 0}
    sites = cfg.n_layers // cfg.hybrid.attn_every \
        if cfg.family == "hybrid" else 0
    return {"flash_attention": sites, "ssd_scan": cfg.n_layers,
            "matmul": 0, "transpose": 0}


def rel_frobenius(a, b) -> float:
    num = den = 0.0
    for i in range(a.shape[0]):  # row by row: the f32 copies stay small
        x, y = a[i].float(), b[i].float()
        num += float(((x - y) ** 2).sum())
        den += float((y ** 2).sum())
    return math.sqrt(num / den)


def phase_init(cfg, seed, B, S):
    t0 = time.perf_counter()
    model = transformer.init_params(cfg, device=DEV, seed=seed)
    n_params = transformer.param_count(model)
    if n_params != cfg.n_params():
        raise AssertionError(f"{n_params} parameters, config says "
                             f"{cfg.n_params()}")
    # warm-up at the counted steps' shape (library handles, GEMM choices,
    # allocator); not part of the counted run
    steps.make_prefill_step(cfg)(
        model, {"tokens": torch.zeros((B, S), dtype=torch.long,
                                      device=DEV)})
    torch.cuda.synchronize()
    emit({"phase": "init", "ok": True, "arch": cfg.name,
          "family": cfg.family, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "dtype": cfg.param_dtype,
          "n_params": n_params,
          "seconds": round(time.perf_counter() - t0, 2)})
    return model


def phase_prefill(cfg, model, B, S, seed, n_steps):
    """The counted prefill steps of the main path; returns the logits."""
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S))).to(DEV)
    step = steps.make_prefill_step(cfg)
    times = []
    logits = None
    for _ in range(n_steps):
        del logits
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = step(model, {"tokens": tokens})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    if tuple(logits.shape) != (B, S, cfg.vocab_size):
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("prefill logits are not finite")
    return tokens, logits, times


def phase_serve(cfg, model, seed):
    slots, max_len = SERVE["slots"], SERVE["max_len"]
    n_req, max_new = SERVE["requests"], SERVE["max_new"]
    torch.cuda.reset_peak_memory_stats()
    server = DecodeServer(cfg, model, slots=slots, max_len=max_len, seed=seed,
                          device=DEV)
    rng = np.random.default_rng(seed)
    for rid in range(n_req):
        plen = int(rng.integers(SERVE["prompt_len"][0],
                                SERVE["prompt_len"][1] + 1))
        prompt = rng.integers(2, cfg.vocab_size, size=plen).astype(np.int32)
        server.submit(Request(rid=rid, prompt=prompt, max_new=max_new))
    iters = []
    done = []
    t0 = time.perf_counter()
    while server.queue or any(server.active):
        server._refill()
        before = [r for r in server.active if r]
        iters.append(server.step() * 1e3)
        done.extend(r for r in before if r.done)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(done) != n_req or not all(r.done for r in done):
        raise AssertionError(f"{len(done)} of {n_req} requests completed")
    for r in done:
        if not 1 <= len(r.out) <= max_new:
            raise AssertionError(f"request {r.rid}: {len(r.out)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.out):
            raise AssertionError(f"request {r.rid}: token out of range")
    if not bool(torch.isfinite(server.last_logits).all()):
        raise AssertionError("decode logits are not finite")
    toks = sum(len(r.out) for r in done)
    emit({"phase": "serve", "ok": True, "arch": cfg.name, "slots": slots,
          "max_len": max_len, "requests": n_req, "max_new": max_new,
          "prompt_tokens": int(sum(len(r.prompt) for r in done)),
          "new_tokens": toks, "decode_iterations": len(iters),
          "decode_calls_total": int(server.state["pos"]),
          "ms_per_iteration_median": float(np.median(iters)),
          "ms_per_iteration_mean": float(np.mean(iters)),
          "wall_seconds": wall, "tokens_per_s": toks / wall,
          "tokens_per_s_decode_only": toks / (sum(iters) * 1e-3),
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})


def phase_prefill_compare(cfg, model, tokens, logits, times, launched,
                          n_steps):
    """The counted run's logits against the plain path's (bf16)."""
    before = read_launches()
    with flags.use_kernels(False):
        plain_logits = steps.make_prefill_step(cfg)(model,
                                                    {"tokens": tokens})
    if read_launches() != before:
        raise AssertionError("the plain path launched a kernel")
    rel = rel_frobenius(logits, plain_logits)
    ms = float(np.median(times))
    B, S = tokens.shape
    emit({"phase": "prefill", "ok": rel <= TOL_PREFILL_BF16,
          "arch": cfg.name, "tokens": [B, S],
          "logits": {"shape": list(logits.shape),
                     "dtype": str(logits.dtype).replace("torch.", ""),
                     "held": "whole tensor, finite"},
          "steps": n_steps, "ms_per_step": times,
          "ms_per_step_median": ms, "tokens_per_s": B * S / (ms * 1e-3),
          "launches": launched, "launches_per_step": launches_per_step(cfg),
          "rel_frobenius_vs_plain": rel, "tol": TOL_PREFILL_BF16})
    if not rel <= TOL_PREFILL_BF16:
        raise AssertionError(f"prefill kernel vs plain (bf16): relative "
                             f"Frobenius error {rel:.3e} > "
                             f"{TOL_PREFILL_BF16:g}")


def phase_prefill_compare_f32(cfg, model, tokens, logits):
    """The same model and tokens in f32: here the two paths must agree
    closely, which shows that the bf16 figure is rounding.  Casts ``model``
    to f32 in place."""
    model.float()
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    step32 = steps.make_prefill_step(cfg32)
    before = read_launches()
    k_logits = step32(model, {"tokens": tokens})
    after = read_launches()
    launched = {n: after[n] - before[n] for n in after}
    with flags.use_kernels(False):
        p_logits = step32(model, {"tokens": tokens})
    rel32 = rel_frobenius(k_logits, p_logits)
    emit({"phase": "prefill.f32", "ok": rel32 <= TOL_PREFILL_F32,
          "arch": cfg.name, "tokens": list(tokens.shape),
          "n_layers": cfg32.n_layers, "launches": launched,
          "rel_frobenius_vs_plain": rel32, "tol": TOL_PREFILL_F32,
          # how far bf16 itself moves the logits: the scale against which
          # the bf16 kernel-vs-plain figure is to be read
          "bf16_step_vs_f32_step_rel_frobenius":
              rel_frobenius(logits, k_logits)})
    if launched != launches_per_step(cfg32) or not rel32 <= TOL_PREFILL_F32:
        raise AssertionError(f"prefill kernel vs plain (f32): relative "
                             f"Frobenius error {rel32:.3e} > "
                             f"{TOL_PREFILL_F32:g}, launches {launched}")


def phase_decode_equals_prefill(cfg, seed, n_layers):
    """f32, full width, ``n_layers`` layers: a decode_step chain over 64
    tokens against forward on the same tokens."""
    cfg2 = dataclasses.replace(cfg, n_layers=n_layers, param_dtype="float32",
                               compute_dtype="float32")
    model = transformer.init_params(cfg2, device=DEV, seed=seed + 1)
    B, T = 2, 64
    rng = np.random.default_rng(seed + 1)
    tokens = torch.from_numpy(
        rng.integers(0, cfg2.vocab_size, (B, T))).to(DEV)
    before = read_launches()
    with torch.no_grad():
        full, _ = transformer.forward(model, cfg2, {"tokens": tokens})
        after = read_launches()
        state = transformer.init_decode_state(cfg2, B, T, device=DEV)
        worst = 0.0
        for t in range(T):
            logits, state = transformer.decode_step(model, cfg2, state,
                                                    tokens[:, t:t + 1])
            worst = max(worst, float((logits[:, 0] - full[:, t]).abs().max()))
    launched = {n: after[n] - before[n] for n in after}
    if launched != launches_per_step(cfg2):
        raise AssertionError(f"forward launched {launched}")
    if not worst <= 1e-3:
        raise AssertionError(f"decode chain vs forward: {worst:.3e} > 1e-3")
    emit({"phase": "decode_equals_prefill", "ok": True, "arch": cfg.name,
          "dtype": "float32", "n_layers": n_layers, "tokens": T,
          "max_abs_err": worst, "tol": 1e-3})


def drive_path(cfg, args, serve: bool, decode_layers: int) -> dict:
    """One main path: init, the counted prefill steps (and server run) with
    the launch counts set to 0 just before and read just after, then the
    comparisons against the plain path.  Returns the counts."""
    (B, S), n_steps = PREFILL_TOKENS, (PREFILL_STEPS if serve else 1)
    name = cfg.name
    with phase(f"{name}:init"):
        model = phase_init(cfg, args.seed, B, S)

    # ---- the main path, with the launch counts set to 0 just before -------
    reset_launches()
    with phase(f"{name}:prefill.run"):
        tokens, logits, times = phase_prefill(cfg, model, B, S, args.seed,
                                              n_steps)
    if serve:
        with phase(f"{name}:serve.run"):
            phase_serve(cfg, model, args.seed)
    launched = read_launches()
    # ---- read just after ---------------------------------------------------
    want = {n: k * n_steps for n, k in launches_per_step(cfg).items()}
    if launched != want:
        raise AssertionError(
            f"{name}: kernel launches on the main path {launched}, expected "
            f"{want} ({n_steps} prefill steps, none from the decode path)")

    with phase(f"{name}:prefill.compare"):
        phase_prefill_compare(cfg, model, tokens, logits, times, launched,
                              n_steps)
    if args.profile and serve:
        with phase(f"{name}:profile"):
            phase_profile(cfg, model, tokens, args.seed)
    with phase(f"{name}:prefill.compare_f32"):
        phase_prefill_compare_f32(cfg, model, tokens, logits)
    del model, tokens, logits
    torch.cuda.empty_cache()
    with phase(f"{name}:decode_equals_prefill"):
        phase_decode_equals_prefill(cfg, args.seed, decode_layers)
    torch.cuda.empty_cache()
    return launched


def _profile(fn, calls: int):
    """Runs ``fn`` ``calls`` times under torch.profiler; returns wall ms per
    call, device-busy ms per call, device kernels per call and the kernels
    that took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy_ms = sum(dev_us(e) for e in rows) / 1e3 / calls
    if not rows or busy_ms == 0.0:
        return {"wall_ms": wall_ms, "device_busy_ms": "not measured"}
    rows.sort(key=dev_us, reverse=True)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "device_kernels_per_call": sum(e.count for e in rows) / calls,
            "top_kernels": [{"name": e.key[:80], "calls": e.count / calls,
                             "ms": dev_us(e) / 1e3 / calls}
                            for e in rows[:8]]}


def phase_profile(cfg, model, tokens, seed):
    """Optional (--profile): where one prefill step and one decode iteration
    spend their time."""
    step = steps.make_prefill_step(cfg)
    pre = _profile(lambda: step(model, {"tokens": tokens}), 1)
    server = DecodeServer(cfg, model, slots=SERVE["slots"],
                          max_len=SERVE["max_len"], seed=seed, device=DEV)
    rng = np.random.default_rng(seed)
    for rid in range(SERVE["slots"]):
        prompt = rng.integers(2, cfg.vocab_size, size=16).astype(np.int32)
        server.submit(Request(rid=rid, prompt=prompt, max_new=64))
    server._refill()
    dec = _profile(server.step, 5)
    emit({"phase": "profile", "ok": True, "arch": cfg.name,
          "prefill_step": pre, "decode_iteration": dec})


def kernel_entry(name, source, replaces, launched, rows, cases):
    """One kernel of the ``kernels`` line: the first main-path shape's
    numbers at the top, every timed shape under ``shapes``."""
    total = sum(n for n in launched.values())
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": total,
            "launches_by_path": launched,
            **rows[0],
            "max_abs_err": max(r["max_abs_err"] for r in rows + cases),
            "max_abs_err_over_cases": max(c["max_abs_err"] for c in cases),
            "shapes": rows, "cases": cases}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one prefill step and a few decode "
                         "iterations of each served path, and the multi-op "
                         "calibration cases, with torch.profiler")
    ap.add_argument("--out", default=None,
                    help="also write every phase line to this JSON file")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script runs on a GPU only", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    with phase("device"):
        smi = phase_device()
    with phase("build"):
        phase_build()

    gen = torch.Generator(DEV).manual_seed(args.seed)
    dense, hybrid, pure = get_arch(ARCH), get_arch(HYBRID), get_arch(SSM)
    B, S = PREFILL_TOKENS

    with phase("kernels.cases"):
        fa_cases = phase_kernel_cases(gen)
    with phase("kernels.ssd.cases"):
        ssd_cases = phase_ssd_cases(gen)

    # the main paths; each resets the launch counts just before it runs and
    # reads them just after
    launched = {ARCH: drive_path(dense, args, serve=True, decode_layers=2),
                HYBRID: drive_path(hybrid, args, serve=True,
                                   decode_layers=hybrid.hybrid.attn_every),
                SSM: drive_path(pure, args, serve=False, decode_layers=2)}

    with phase("kernels.main_shape"):
        fa_rows = [phase_kernel_main_shape(cfg, B, S, gen)
                   for cfg in (dense, hybrid)]
        emit({"phase": "kernels.main_shape", "ok": True,
              "kernel": "flash_attention", "shapes": fa_rows})
    torch.cuda.empty_cache()
    with phase("kernels.ssd.main_shape"):
        ssd_rows = [phase_ssd_main_shape(cfg, B, S, gen)
                    for cfg in (hybrid, pure)]
        emit({"phase": "kernels.ssd.main_shape", "ok": True,
              "kernel": "ssd_scan", "shapes": ssd_rows})
    torch.cuda.empty_cache()

    with phase("kernels.matmul.cases"):
        mm_cases = phase_matmul_cases(gen)
    with phase("kernels.transpose.cases"):
        tr_cases = phase_transpose_cases(gen)
    with phase("extract.closed_form"):
        phase_closed_form()

    # the calibration path (measure -> extract -> fit -> register, then the
    # held-out predictions), with the launch counts set to 0 just before it
    # and read just after
    with tempfile.TemporaryDirectory(prefix="registry-") as reg_dir:
        reset_launches()
        with phase("calibrate"):
            res = phase_calibrate(reg_dir)
        with phase("heldout"):
            phase_heldout(reg_dir, res)
        launched["calibration"] = read_launches()
    torch.cuda.empty_cache()
    if args.profile:
        with phase("calibrate.profile"):
            phase_calibration_profile(args.seed)

    with phase("kernels.matmul.main_shape"):
        mm_row = phase_matmul_main_shape(gen)
        emit({"phase": "kernels.matmul.main_shape", "ok": True,
              "kernel": "matmul", "shapes": [mm_row]})
    torch.cuda.empty_cache()
    with phase("kernels.transpose.main_shape"):
        tr_row = phase_transpose_main_shape(gen)
        emit({"phase": "kernels.transpose.main_shape", "ok": True,
              "kernel": "transpose", "shapes": [tr_row]})

    kernels = {"kernels": [
        kernel_entry("flash_attention",
                     "src/repro_torch/kernels/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:116",
                     {a: n["flash_attention"] for a, n in launched.items()},
                     fa_rows, fa_cases),
        kernel_entry("ssd_scan", "src/repro_torch/kernels/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan.py:97",
                     {a: n["ssd_scan"] for a, n in launched.items()},
                     ssd_rows, ssd_cases),
        kernel_entry("matmul", "src/repro_torch/kernels/csrc/matmul.cu",
                     "src/repro/kernels/matmul.py:50",
                     {a: n["matmul"] for a, n in launched.items()},
                     [mm_row], mm_cases),
        kernel_entry("transpose",
                     "src/repro_torch/kernels/csrc/transpose.cu",
                     "src/repro/kernels/transpose.py:30",
                     {a: n["transpose"] for a, n in launched.items()},
                     [tr_row], tr_cases),
    ]}
    for k in kernels["kernels"]:
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} was never launched on a "
                                 "main path")

    total = round(time.perf_counter() - t_start, 1)
    emit({"phase": "total", "ok": True, "seconds": total})
    emit(kernels)
    print(smi, flush=True)
    last = {"ok": True, "device": {"platform": "gpu",
                                   "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"nvidia_smi": smi, "lines": LINES, "last": last}, f,
                      indent=1)
    print(json.dumps(last), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
