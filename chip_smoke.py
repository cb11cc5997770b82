#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json] [--seed 0] [--profile]
    python3 chip_smoke.py --only fa-cases|fa    # flash attention alone
    python3 chip_smoke.py --only ssd-cases|ssd  # the SSD scan alone
    python3 chip_smoke.py --only mm-cases|mm    # matmul alone
    python3 chip_smoke.py --only tr-cases|tr    # the transpose alone
    python3 chip_smoke.py --only autotune       # the autotune phase alone
    python3 chip_smoke.py --only dp             # the data-parallel phase
    python3 chip_smoke.py --only gspmd          # the sharded steps, dry run
    python3 chip_smoke.py --only engines        # the engine benchmarks
    python3 chip_smoke.py --only examples       # the examples on the card
    python3 chip_smoke.py --only docs           # the documents' commands
    python3 chip_smoke.py --only train.ssd_chunk  # zamba2's step by SSD chunk

Builds the CUDA kernels from the sources in this checkout (one ``nvcc`` per
source, all started together), holds each kernel against its plain PyTorch
version on the card, then drives the port's main paths through the entry
points a user calls, each with random weights made on the device from the
seed, and checks that each path really went through its kernels (launch
counts set to 0 just before the path and read just after):

* the dense serving path of ``llama3.2-3b`` at full width and depth (bf16):
  prefill steps on tokens (4, 2048) and a decode server answering 16
  requests — the ``flash_attention`` kernel (bf16: its tensor-core kernel;
  the FP32 kernel serves the f32 comparisons);
* the hybrid serving path of ``zamba2-2.7b`` at full width and depth (54
  Mamba2 layers, one shared attention block applied at 9 sites): the same
  prefill steps and server — the ``ssd_scan`` (bf16: its tensor-core kernel;
  the FP32 kernel serves the f32 comparisons) and ``flash_attention``
  kernels;
* the ssm path of ``mamba2-370m`` (48 layers): one prefill step — the
  ``ssd_scan`` kernel;
* the mixture-of-experts serving path of ``mixtral-8x7b`` at full width
  (8 experts of d_ff 14 336, top-2, GQA 32/8, window 4096) and 16 of its 32
  layers (the whole model does not fit one card): the same prefill steps
  and server — the ``flash_attention`` kernel; the MoE dispatch, expert
  products and combine are einsums, as in the reference.  The share of
  routing picks that differ between the kernel and plain paths is reported
  layer by layer; the f32 comparison runs at 8 layers;
* the vision-language serving path of ``qwen2-vl-7b`` at full size (M-RoPE,
  qkv bias, a group of 7 query heads a KV head; the prefill batch carries
  seeded vision embeddings over its first 256 positions), text-only decode
  — the ``flash_attention`` kernel;
* the audio path of ``musicgen-medium`` at full size (4 codebooks summed in,
  4 heads out, MHA at head_dim 64): 3 prefill steps, then decode through
  ``decode_step`` / ``make_serve_step`` (the server serves one codebook, as
  the reference's) — the ``flash_attention`` kernel;
* the training paths of ``llama3.2-3b`` and ``zamba2-2.7b`` at full width
  and depth (bf16, AdamW, remat ``full``, batch 2 x 4096 from the packed
  loader): one loss + backward through the kernels against the plain paths
  in bf16 and in f32 (loss and every gradient), 3 steps through
  ``Trainer.train``, a step split into forward / backward / optimizer, and,
  at full width but cut depth, 3 steps with an async save and the exit save
  and a fresh ``Trainer`` that resumes and replays the last step — the
  ``flash_attention`` kernel (and ``ssd_scan`` for zamba2) inside their
  autograd Functions, twice a layer per step (forward and remat recompute),
  the first also writing the row log-sum-exp the backward reads;
* data-parallel training (``dp``): ``llama3.2-3b`` at full width and depth
  (batch 2 x 4096, AdamW), 3 steps each of ``make_train_step`` and of
  ``steps.make_manual_dp_train_step`` on ``make_mesh((1,), ("data",))``
  over a one-rank NCCL group, uncompressed (equal to the train step within
  1e-6: losses and every parameter) and under ``int8_ef`` (losses within
  5 %), from the same weights and global batch: step times, peak memory,
  the quantizer's and the collectives' device ms, ``count_collectives``'
  bytes by kind beside ``archcount.collective_counts``' closed form — the
  ``flash_attention`` kernel, twice a layer a step;
* the DTensor-sharded steps (``gspmd.*``) on a (1, 1) ``data, model``
  mesh over the one-rank NCCL group, each beside its unsharded step from
  the same weights and inputs: ``gspmd.train`` (llama3.2-3b uncut, 2 x
  4096, AdamW, 3 steps through ``step_and_specs``' train step on DTensor
  parameters and state; losses and every parameter within 1e-6),
  ``gspmd.prefill`` (zamba2-2.7b, 4 x 2048: the ``ssd_scan`` and
  ``flash_attention`` kernels on each rank's shard under ``local_map``;
  logits within 1e-6), ``gspmd.ep`` (mixtral-8x7b at 16 layers under
  ``moe_mode="ep"``; logits within 1e-6) and ``gspmd.decode`` (llama3.2-3b,
  8 slots x 2048 rows, 16 iterations; the sampled tokens equal); then the
  dry run, ``python -m repro_torch.launch dryrun`` of llama3.2-3b at
  ``train_4k`` on a fake world of 256 ranks in a process of its own, beside
  ``archcount``'s closed form and ``predictor.estimate_peak_bytes``;
  ``roofline``: ``repro_torch.benchmarks.roofline`` on that record at the
  H100's rates (compute / memory / collective terms, ``useful_ratio``);
* the paper's calibration loop on the card: ``python -m
  repro_torch.calibration --device gpu-h100 --scale gpu`` (launch overhead,
  the 9 measurement classes timed under the 30-run/drop-4 protocol with
  their properties extracted from ATen graphs, the fit, the registry), then
  the held-out step (``benchmarks.paper_table1.heldout``): the model loaded
  back by name predicts the 4 held-out kernels, which are timed beside it
  — the ``matmul`` kernel (``mm_tiled``, ``skinny_mm``) and the
  ``transpose`` kernel (the tiled transpose); ``table1`` is the paper's
  Table 1 record and ``table2`` its Table 2 (the fitted weights beside the
  ``gpu-h100`` and v5e seeds), both written under
  ``chiprun_out/experiments``;
* ``validate`` (``benchmarks.predictor_validation`` at the ``gpu`` scale):
  every architecture's AdamW training step at full width, 2 x 2048, its
  depth cut only as far as the card forces (llama3-405b a ``skip`` row),
  its properties extracted from the step's ATen graph in processes of
  their own, predicted by the fit and timed (10 calls of each step, the
  ``flash_attention`` and ``ssd_scan`` kernels twice a layer a call);
* ``kernel_roofline`` (``benchmarks.kernel_roofline`` in a process of its
  own): glm4-9b ``prefill_32k`` at 4 of 40 layers on the fake 256-rank
  world, attention's share of the plain path against the kernel's schedule
  at the tiles ``gpu-h100`` picks;
* the SSD chunk of a training step (``train.ssd_chunk``, zamba2): steps at
  the chunk ``"auto"`` picks under autograd (the backward kernels priced,
  the same at every chunk: 64, the pick for the kernel alone) and at 64,
  128 and 256, in turns, with the pick's seconds over the fastest's; the
  training path's bf16 backward runs on the SSD backward kernels (four
  launches a layer a step, counted from just before the counted steps to
  just after);
* the step predictor (``predict`` lines): for every path measured above (the
  prefill steps, the servers' decode iterations with their slots, mean
  occupancy and cache rows, the train steps, the second f32 prefill step of
  each f32 comparison), ``core.predictor.predict_step`` under the
  ``gpu-h100`` model fitted in this run and under the analytic ``gpu-h100``
  seed, beside the measured seconds, with the properties the fitted model
  leaves unpriced, once on the reference's Pallas blocks and once on the
  card's kernels (``kernels``: ``pallas`` / ``cuda``); ``predict_plans``
  and ``StragglerMonitor.from_model`` must agree with it to 1e-9;
* the autotuner (``autotune`` lines): at the main paths' kernel shapes, the
  f32 attention of the f32 comparison steps and the calibration's largest
  matmul and transpose in f32 and bf16, every candidate of the grid
  ``kernels.autotune`` sweeps is launched (its tile and shared memory as the
  C query reports them must equal the tuner's Python mirrors), held against
  the plain version and timed on the device (the median of the replays of
  a CUDA graph of its calls; mamba2's bf16 SSD row also by host calls, and
  the FP32 SSD kernel at chunks 32 and 64 over grids of one and two blocks
  an SM: ``autotune.ssd_chunk_steps``), beside its predicted seconds under the
  analytic ``gpu-h100`` seed and the model fitted in this run (with the
  keys the fit leaves unpriced), Spearman's rank correlation of predicted
  and measured, the tile ``block_sizes="auto"`` picks on the card and the
  fastest (above 1.25x fails); each candidate's blocks an SM holds (the
  tuner's residency mirrors) equal the CUDA occupancy calculator for
  its instance, its registers this build's ``ptxas``; the main paths
  themselves run at ``"auto"``'s tiles, as the reference's do, and the
  SSD pick on a prefill path must be a tensor-core chunk;
* ``explain``: ``score_explain`` of llama3.2-3b's bf16 prefill step under
  the fitted model, its rows summing to the fused score within 1e-9;
* ``admission``: a llama3.2-3b server (4 slots x 512 rows, full width and
  depth) answering 8 requests in an order adversarial to FIFO, under
  ``admission="fifo"`` and ``"model"``, measured latencies and orders
  beside ``simulate_serving``'s and the scorer's span predictions beside
  the measured spans;
* ``autoshard``: one plan search on the host under ``gpu-h100``;
* ``engines``: the planner's engine benchmarks (``python -m
  repro_torch.benchmarks.search_bench``, ``fused_bench``, ``fleet_bench``
  at their defaults under ``gpu-h100``, then ``run --only search_bench``),
  each in a process of its own: every ratio beside the reference's bar (a
  missed bar is reported with the scripts' WARNING, not fatal);
* ``examples``: every ``repro_torch.examples`` module through its ``main``
  on the card, each with its own assertions: ``quickstart`` (the tiny
  ladder's tiled cases launch the ``matmul`` and ``transpose`` kernels),
  ``kernel_autotune`` (``block_sizes="auto"`` launches the ``matmul``
  kernel once), ``serve_decode``, ``train_smollm`` (the ~100M config 60
  steps at 4 x 256, resumed for 60 more, then smollm-360m whole for 100:
  the ``flash_attention`` kernel a layer a step, twice under remat
  ``full``), ``fault_tolerance`` (replay and supervised losses at 1e-5),
  ``fleet_churn``, ``autoshard_search``; the launches of each, counted
  from its reset just before to its read just after, must equal its
  reckoning;
* ``docs``: every command of ``docs/torch/*.md`` in its card form (full
  width, ``--device`` at its default), each in a process of its own, the
  commands under one heading in order in a temporary directory of their
  own, every heading's side by side: each exits 0 and prints the lines its
  document promises,
  and a ``corrupt_registry`` run without ``--model`` leaves the registry's
  ``gpu-h100`` file byte for byte; the line gives each command's seconds
  and the bytes each heading's commands left behind (the phase runs
  beside ``kernel_roofline``, which times nothing on the card);
* online calibration and supervised recovery: ``robust.serve`` (llama3.2-3b,
  full width and depth, 8 slots x 2048 rows: two prefill steps through the
  attention kernel, then a ``DecodeServer`` under ``ServingSupervisor`` with
  an ``OnlineCalibrator`` warm-started from the fitted ``gpu-h100`` and a
  ``FaultInjector``: a x3 slowdown, a spike, a poisoned sample and a device
  loss that evicts every slot; per iteration the measured and predicted ms
  and the CUSUM evidence, the drift events, refits and the windowed error
  around them; every request completes and an evicted request keeps a prefix
  equal to a clean run's), ``robust.train`` (llama3.2-3b at train.resume's
  cut under a ``Supervisor``: a device loss, the newest save, a copy of the
  registry and a compile cache of its own corrupted; the history equals an
  unsupervised run's within 1e-5, the resume falls back one save, the
  registry one revision, the cache rebuilds; MTTR and the ``[supervisor]``
  and ``[calib]`` lines) and ``robust.fleet`` (``python -m
  repro_torch.launch fleet`` twice in-process, byte-equal histories, then a
  ``TrainerJobRunner`` migrated by a pool shrink, replaying to 1e-5).

The prefill and serve steps the script builds itself come from
``steps.make_step`` and a ``WorkloadSpec``.  The run has its own compile
cache (``REPRO_COMPILE_CACHE`` points to a temporary directory), so the step
programs of the predict phase are built cold.

Every phase prints one JSON line; any failure ends the run with a non-zero
exit code.  The last line is ``{"ok": true, "device": {...}}``.  With
``--only`` it builds, holds one kernel (flash attention: ``fa``; SSD scan:
``ssd``; matmul: ``mm``; transpose: ``tr``) against its plain version at its
case table and (without ``-cases``) times it at the main paths' shapes, runs
no main path, and says so in its last line; ``--only autotune`` builds and
runs the autotune phase under the analytic seed alone, ``--only
train.ssd_chunk`` zamba2's trainer and that phase alone, ``--only dp`` the
data-parallel phase alone, ``--only gspmd`` the sharded steps and the dry
run alone, ``--only engines`` / ``--only examples`` / ``--only docs``
that phase alone.  The
``kernels`` line
gives each matmul kernel (``paper16``, ``fma128``, ``wgmma``), each SSD-scan
kernel (``wgmma``, ``fma``) and each transpose kernel (``vec16``,
``scalar``) with its tile, registers and spills; the build fails if a tensor-core instance of
any kernel, or an instance of the transpose's vector kernel, spills, if
an ``fa_wgmma_kernel`` instance of a padded head width is missing or its
SASS touches local memory (the line gives the highest register each
names).  The
transpose is timed at the calibration's four sizes beside the empty kernel
over the same grid (the floor one block per tile sets).

It needs a GPU (it fails where ``torch.cuda.is_available()`` is false) and
``nvcc``; it imports ``torch`` and ``repro_torch`` only.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import functools
import glob
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.benchmarks import kernel_roofline  # noqa: E402
from repro_torch.benchmarks import paper_table1, paper_table2  # noqa: E402
from repro_torch.benchmarks import predictor_validation  # noqa: E402
from repro_torch.benchmarks import roofline  # noqa: E402
from repro_torch.calibration import __main__ as calib_cli  # noqa: E402
from repro_torch.calibration import registry, seeds  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core import extract, measure, mkernels, tkernels  # noqa: E402
from repro_torch.core import exprops, kernelmodel, planspace  # noqa: E402
from repro_torch.core import predictor  # noqa: E402
from repro_torch.core import properties as props  # noqa: E402
from repro_torch.core.workload import WorkloadSpec  # noqa: E402
from repro_torch.core.model import geomean, relative_error  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.kernels import transpose as tr  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.data.pipeline import DataConfig, PackedLoader  # noqa: E402
from repro_torch.distributed.plan import Plan  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import autoshard, specs  # noqa: E402
from repro_torch.models import moe, transformer  # noqa: E402
from repro_torch.obs import trace as _obs_trace  # noqa: E402
from repro_torch.obs.explain import score_explain  # noqa: E402
from repro_torch.optim import optimizers as opt  # noqa: E402
from repro_torch.runtime import flags, steps  # noqa: E402
from repro_torch.runtime.server import (AdmissionScorer,  # noqa: E402
                                        DecodeServer, Request,
                                        simulate_serving)
from repro_torch.runtime.straggler import StragglerMonitor  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.calibration.online import OnlineCalibrator  # noqa: E402
from repro_torch.launch.__main__ import main as launch_main  # noqa: E402
from repro_torch.launch.fleet import (FleetAllocator, JobSpec,  # noqa: E402
                                      Manifest, PoolSpec)
from repro_torch.runtime.faults import FaultInjector, FaultPlan  # noqa: E402
from repro_torch.runtime.fleet_supervisor import (  # noqa: E402
    FleetSupervisor, TrainerJobRunner)
from repro_torch.runtime.supervisor import (  # noqa: E402
    BackoffPolicy, ServingPolicy, ServingSupervisor, Supervisor)

DEV = "cuda"
ARCH = "llama3.2-3b"
HYBRID = "zamba2-2.7b"
SSM = "mamba2-370m"
MOE = "mixtral-8x7b"
VLM = "qwen2-vl-7b"
AUDIO = "musicgen-medium"
# mixtral-8x7b is 46.7e9 parameters, 93 GB in bf16: 16 of its 32 layers
# (1.451e9 parameters, 2.90 GB each) and the embedding and head come to ~47
# GB, which leaves the card room for the server's caches and the prefill's
# expert buffers; its f32 comparison runs at 8 layers (~47 GB in f32)
MOE_LAYERS = 16
MOE_F32_LAYERS = 8
PREFILL_TOKENS = (4, 2048)   # (batch, sequence) of one prefill step
PREFILL_STEPS = 3
# The server feeds a prompt token by token, one host-bound decode call a
# token: prompts of 4-16 tokens keep a whole run inside its time limit on a
# busy host (16-64 took ~700 calls a server); slots, cache rows, requests
# and new tokens are the measured decode's
SERVE = dict(slots=8, max_len=2048, requests=16, max_new=32,
             prompt_len=(4, 16))
# The training paths: the reference's train_4k sequence length; one card
# holds two sequences of llama3.2-3b with its f32 AdamW state
TRAIN_TOKENS = (2, 4096)     # (batch, sequence) of one train step
TRAIN_STEPS = 3
TRAIN_LR = dict(lr=3e-4, warmup=20, total_steps=1000)  # warmup_cosine

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
    # bf16 twins of the f32 cases: every branch of the tensor-core kernel
    # (GQA, MHA, MQA, window, Sq != Skv without a mask, ragged lengths,
    # dh below 64, between 64 and 128, and the reduced configs' 16)
    ("bf16_mha", 1, 4, 4, 128, 128, 32, True, None, torch.bfloat16),
    ("bf16_mqa", 1, 8, 1, 128, 128, 64, True, None, torch.bfloat16),
    ("bf16_swa64", 2, 8, 2, 256, 256, 64, True, 64, torch.bfloat16),
    ("bf16_noncausal_sq_ne_skv", 1, 2, 1, 128, 256, 64, False, None,
     torch.bfloat16),
    ("bf16_ragged_noncausal_dh48", 1, 4, 2, 100, 77, 48, False, None,
     torch.bfloat16),
    ("bf16_ragged_swa_dh80", 2, 6, 3, 203, 203, 80, True, 50,
     torch.bfloat16),
    ("bf16_dh16", 2, 4, 2, 40, 40, 16, True, None, torch.bfloat16),
    # zamba2-2.7b's head layout: dh 80, 32 heads, MHA, at a ragged length
    ("bf16_zamba2_dh80", 1, 32, 32, 333, 333, 80, True, None,
     torch.bfloat16),
    # qwen2-vl-7b's group of 7 query heads a KV head at dh 128 (no other case
    # has a ratio between 4 and 8), musicgen-medium's MHA at dh 64
    ("bf16_gqa7_dh128", 1, 28, 4, 256, 256, 128, True, None, torch.bfloat16),
    ("gqa7_dh128", 1, 28, 4, 256, 256, 128, True, None, torch.float32),
    ("bf16_mha_dh64", 1, 24, 24, 256, 256, 64, True, None, torch.bfloat16),
    ("mha_dh64", 1, 24, 24, 256, 256, 64, True, None, torch.float32),
    # the two padded head widths no case above reaches (96, 112), at
    # lengths ragged against the 128-key tile, one under a window
    ("bf16_ragged_dh96", 1, 8, 2, 301, 301, 96, True, None, torch.bfloat16),
    ("bf16_ragged_swa_dh112", 1, 8, 2, 517, 517, 112, True, 200,
     torch.bfloat16),
]
# bf16: the reference's own tolerance.  f32: the reference's 3e-5 loosened
# to 1e-4 because the kernel sums the products in another order (4-wide
# partial sums over head_dim, online rescaling over key tiles) than the
# plain version's matrix products.
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# the kernel each input type goes to
VARIANT = {torch.bfloat16: "wgmma+tma bf16", torch.float32: "fp32 fma"}

# A whole prefill step, kernel path against plain path, relative Frobenius
# error of the logits.  f32: the two paths differ by summation order only.
# bf16: the kernels and their plain versions (both f32 inside) round a few
# outputs to neighbouring bf16 values, and the bf16 layers amplify that;
# 2e-2 was the first guess, the H100 gives about 3e-2 for llama3.2-3b while
# the f32 check holds 1e-4.  Beside each bf16 figure the script prints how
# far bf16 itself moves the logits (bf16 step against f32 step).
TOL_PREFILL_F32 = 1e-4
TOL_PREFILL_BF16 = 5e-2
# One loss + backward of a whole model, kernels against plain paths.  bf16:
# the relative difference of the loss; each parameter's gradient, as its
# relative Frobenius distance to the f32 plain gradient of the same weights,
# may exceed the bf16 plain path's distance by at most the prefill step's
# bar.  (bf16 itself puts both paths 7-17 % from the f32 gradient at full
# depth, so a bar on their distance from each other alone would measure
# bf16, not the kernels.)  f32: kernels against plain paths, each gradient
# 1e-3 (sums in other orders through 28 / 54 layers; the kernels' own f32
# bars are 1e-4 / 5e-4).  A resumed run replays its last step's loss to
# 1e-5.
TOL_TRAIN_LOSS = 1e-2
TOL_TRAIN_GRAD = TOL_PREFILL_BF16
TOL_TRAIN_F32 = 1e-3
TOL_REPLAY = 1e-5

# The reference's own case table for the SSD scan, plus edges: a chunk that
# is not a multiple of the FP32 kernel's 32-row strip, mamba2-370m's d_state
# at chunk 128, two groups, and the largest chunk at the largest d_state; then
# bf16 cases for the tensor-core kernel (chunk 64, 128 and 256, N
# 16/32/64/80/128, G 2, P 16/32/48/64/128, at least 8 chunks so the state
# carries, and one chunk alone: at 256 its two halves) and bf16 the variant
# rule sends to the FP32 kernel.  x is in the case's type; B and C are in the
# case's B/C type in the contiguous layout, and in x's type in the main
# path's layout (slices of x's tensor).  The last two fields: the kernel each
# layout must land on (contiguous, main path's).
# Bz, H, G, L, P, N, chunk, dtype of x, of B/C, variants
F32, BF16 = torch.float32, torch.bfloat16
SSD_CASES = [
    ("ref0", 2, 4, 1, 256, 32, 16, 64, F32, F32, ("fma", "fma")),
    ("ref1_g2", 1, 4, 2, 128, 64, 32, 32, F32, F32, ("fma", "fma")),
    ("ref2", 2, 2, 2, 128, 16, 64, 128, F32, F32, ("fma", "fma")),
    ("ref3_n128", 1, 4, 1, 256, 64, 128, 64, F32, F32, ("fma", "fma")),
    ("ref4_bf16", 2, 4, 1, 256, 32, 16, 64, BF16, F32, ("fma", "wgmma")),
    ("chunk100", 1, 2, 1, 200, 32, 16, 100, F32, F32, ("fma", "fma")),
    ("n128_chunk128", 1, 2, 1, 256, 64, 128, 128, F32, F32, ("fma", "fma")),
    ("g2_h4", 2, 4, 2, 256, 64, 64, 128, BF16, F32, ("fma", "wgmma")),
    ("n128_chunk256", 1, 2, 1, 512, 16, 128, 256, F32, F32, ("fma", "fma")),
    ("wg_q128_n64_g2", 2, 4, 2, 1024, 64, 64, 128, BF16, BF16,
     ("wgmma", "wgmma")),
    ("wg_q64_n16_p32_g2", 2, 4, 2, 512, 32, 16, 64, BF16, BF16,
     ("wgmma", "wgmma")),
    ("wg_q128_n128", 1, 4, 1, 1024, 64, 128, 128, BF16, BF16,
     ("wgmma", "wgmma")),
    ("wg_q64_n128_g2", 1, 4, 2, 512, 64, 128, 64, BF16, BF16,
     ("wgmma", "wgmma")),
    ("wg_q128_n16_p32", 2, 2, 2, 1024, 32, 16, 128, BF16, BF16,
     ("wgmma", "wgmma")),
    ("wg_p128_two_slices", 1, 2, 1, 1024, 128, 64, 128, BF16, BF16,
     ("wgmma", "wgmma")),
    # the walk's ends (one chunk), the reduced configs' P, N padded inside
    # the 64- and 128-wide state
    ("wg_one_chunk", 2, 4, 1, 128, 64, 64, 128, BF16, BF16,
     ("wgmma", "wgmma")),
    ("wg_p16_n32", 1, 4, 1, 512, 16, 32, 64, BF16, BF16,
     ("wgmma", "wgmma")),
    ("wg_p48_n80", 1, 2, 1, 1024, 48, 80, 128, BF16, BF16,
     ("wgmma", "wgmma")),
    # chunk 256, walked as two halves of 128 rows: N 64 and 128, G 2, P in
    # two slices, one chunk alone
    ("wg_q256_n64_g2", 2, 4, 2, 2048, 64, 64, 256, BF16, BF16,
     ("wgmma", "wgmma")),
    ("wg_q256_n128", 1, 4, 1, 2048, 64, 128, 256, BF16, BF16,
     ("wgmma", "wgmma")),
    ("wg_q256_p128_n16", 1, 2, 1, 2048, 128, 16, 256, BF16, BF16,
     ("wgmma", "wgmma")),
    ("wg_q256_one_chunk", 2, 4, 1, 256, 64, 64, 256, BF16, BF16,
     ("wgmma", "wgmma")),
    ("bf16_chunk32", 1, 4, 1, 256, 32, 16, 32, BF16, BF16, ("fma", "fma")),
    ("bf16_p40_n24", 1, 2, 1, 512, 40, 24, 128, BF16, BF16, ("fma", "fma")),
]
# the reference's own tolerances (tests/test_kernels.py): y f32 5e-4, y bf16
# 3e-2, h_final 5e-4; chunk invariance 1e-4 (y of f32 inputs, and h_final of
# bf16 inputs on the tensor-core kernel, chunk 64 against 128 and 256)
SSD_TOL = {torch.float32: 5e-4, torch.bfloat16: 3e-2}
SSD_TOL_H = 5e-4
SSD_TOL_CHUNKS = 1e-4

# The reference's case table for matmul (tests/test_kernels.py MM_CASES),
# plus the paper's 16³ tile, ragged M/N/K, and layouts that send a call to
# each copy path and each kernel: a base one element past a 16-byte boundary
# (offset: wide[:, 1:]), leading strides not a multiple of 4 (stride: cols +
# 3), K not a multiple of 4, leading strides padded to a multiple of 8 with
# a ragged K (pad8), and bf16 on the tensor cores (wgmma) or, where TMA
# cannot read it, on the FP32 pipes (fma128).
# id, M, K, N, block, dtype, layout of a and b, kernel that must serve it
MM_CASES = [
    ("ref0", 256, 384, 512, 128, torch.float32, "contig", "fma128"),
    ("ref1", 128, 128, 128, 128, torch.float32, "contig", "fma128"),
    ("ref2", 512, 256, 256, 64, torch.float32, "contig", "fma128"),
    ("ref3_skinny", 256, 2048, 256, 128, torch.float32, "contig", "fma128"),
    ("ref4_bf16", 256, 256, 256, 128, torch.bfloat16, "contig", "wgmma"),
    ("tile16", 256, 256, 256, 16, torch.float32, "contig", "paper16"),
    ("ragged_tile16", 100, 77, 53, 16, torch.float32, "contig", "paper16"),
    ("ragged_tile128", 1000, 333, 257, 128, torch.float32, "contig",
     "fma128"),
    ("bf16_ragged_tile64", 129, 65, 191, 64, torch.bfloat16, "contig",
     "fma128"),
    ("offset4_tile16", 200, 96, 144, 16, torch.float32, "offset", "paper16"),
    ("offset4_tile128", 300, 160, 200, 128, torch.float32, "offset",
     "fma128"),
    ("ld_not4_tile16", 130, 70, 90, 16, torch.float32, "stride", "paper16"),
    ("ld_not4_tile128", 260, 150, 270, 128, torch.float32, "stride",
     "fma128"),
    ("k_not4_tile16", 64, 61, 48, 16, torch.float32, "contig", "paper16"),
    ("k_not4_tile128", 256, 61, 256, 128, torch.float32, "contig", "fma128"),
    ("k_ragged_pad8_tile16", 48, 62, 40, 16, torch.float32, "pad8",
     "paper16"),
    ("n_ragged_pad8_tile128", 200, 100, 150, 128, torch.float32, "pad8",
     "fma128"),
    ("bf16_wgmma_ragged", 300, 200, 264, 128, torch.bfloat16, "contig",
     "wgmma"),
    ("bf16_wgmma_pad8_k77", 333, 77, 150, 128, torch.bfloat16, "pad8",
     "wgmma"),
    ("bf16_offset_fma128", 200, 96, 136, 128, torch.bfloat16, "offset",
     "fma128"),
    ("bf16_offset_tile16", 100, 40, 72, 16, torch.bfloat16, "offset",
     "paper16"),
]
# the reference's own tolerances: IEEE f32 products (TF32 would miss them)
MM_TOL = {torch.float32: (1e-3, 1e-5), torch.bfloat16: (1.0, 3e-2)}
# The reference's three transpose cases, then block 16, bf16 and ragged,
# then layouts that send a call to each kernel: a base one element past a
# 16-byte boundary (offset), a leading stride not a multiple of one access
# (stride: cols + 3), a padded aligned stride (pad: cols + 8), ragged edges
# vec16 masks as whole accesses, the calibration's contiguous n x n; and
# scalar named on a layout vec16 takes.  The result must be exact (a copy of
# bits).
# id, (M, N), block, dtype, layout, variant named by the caller (None: the
# one pick_variant names), the variant pick_variant must name
TR_CASES = [
    ("ref0", (256, 256), 128, F32, "contig", None, "scalar"),
    ("ref1", (512, 256), 128, F32, "contig", None, "scalar"),
    ("ref2", (128, 384), 64, F32, "contig", None, "scalar"),
    ("block16", (256, 512), 16, F32, "contig", None, "vec16"),
    ("bf16", (384, 256), 32, BF16, "contig", None, "scalar"),
    ("ragged_block16", (100, 77), 16, F32, "contig", None, "scalar"),
    ("bf16_ragged_block256", (333, 1000), 256, BF16, "contig", None,
     "scalar"),
    ("bf16_block16", (384, 256), 16, BF16, "contig", None, "vec16"),
    ("m100_block16", (100, 64), 16, F32, "contig", None, "vec16"),
    ("bf16_m104_n40_block16", (104, 40), 16, BF16, "contig", None, "vec16"),
    ("offset_block16", (256, 512), 16, F32, "offset", None, "scalar"),
    ("bf16_offset_block16", (384, 256), 16, BF16, "offset", None, "scalar"),
    ("stride_block16", (256, 512), 16, F32, "stride", None, "scalar"),
    ("bf16_stride_block16", (384, 256), 16, BF16, "stride", None, "scalar"),
    ("pad_block16", (256, 520), 16, F32, "pad", None, "vec16"),
    ("bf16_pad_block16", (384, 264), 16, BF16, "pad", None, "vec16"),
    ("calibration_2048", (2048, 2048), 16, F32, "contig", None, "vec16"),
    ("scalar16_aligned", (256, 512), 16, F32, "contig", "scalar", "vec16"),
]
CALIB_DEVICE = "gpu-h100"    # the registry name of the fitted model
CALIB_SCALE = "gpu"
# the cases whose timing goes through a hand-written kernel
KERNEL_TIMED = {"mm_tiled_": "matmul", "skinny_mm_": "matmul",
                "transpose_tiled_": "transpose"}
# the evaluation scripts (``repro_torch.benchmarks``): their records go
# under the checkout's ``chiprun_out/experiments``; the reference's keys
# each record must hold
EXPERIMENTS_OUT = os.path.join(ROOT, "chiprun_out", "experiments")
TABLE1_KEYS = ("device", "launch_overhead_us", "n_measurement_kernels",
               "fit_geomean_rel_err", "rows", "per_class_geomean",
               "overall_geomean_rel_err", "paper_band")
TABLE2_KEYS = ("fit", "gpu_h100_seed", "tpu_v5e_seed")
VALIDATION_KEYS = ("rows", "geomean_rel_err", "geomean_rel_err_calibrated",
                   "calibration_factor", "B", "S")
VALIDATION_ROW_KEYS = ("arch", "predicted_ms", "actual_ms", "rel_err")
#: the step traces run in processes of their own while the card times
VALIDATE_TRACE_WORKERS = 4
ROOFLINE_KEYS = ("arch", "shape", "mesh", "compute_s", "memory_s",
                 "collective_s", "dominant", "model_flops", "useful_ratio",
                 "roofline_fraction", "step_bound_s")
#: the 256-rank llama3.2-3b train_4k cell counts 4.17x archcount's model
#: flops (24 q and 8 kv heads do not divide 16 ranks)
ROOFLINE_USEFUL = (0.2, 0.3)
#: the reference's default cell, its depth cut to 4 of 40 layers (the
#: plain chunked attention dispatches every chunk pair on fake tensors)
KROOF_ARGS = ["--arch", "glm4-9b", "--shape", "prefill_32k", "--layers",
              "4"]
KROOF_TIMEOUT = 600
KROOF_KEYS = ("arch", "shape", "n_devices", "autotuned_blocks",
              "attention_attributable", "kernel_attention", "xla_terms_s",
              "kernel_terms_s", "xla_dominant", "kernel_dominant",
              "memory_term_reduction", "step_bound_xla_s",
              "step_bound_kernel_s")

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


def ptxas_entries(log: str) -> list:
    """Per kernel entry of an ``nvcc -Xptxas -v`` log: mangled name,
    registers, spill bytes (stores, loads)."""
    out = []
    for part in log.split("Compiling entry function '")[1:]:
        name = part.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", part)
        out.append({"function": name,
                    "registers": int(regs.group(1)) if regs else None,
                    "spill_store_bytes": int(spill.group(1)) if spill else None,
                    "spill_load_bytes": int(spill.group(2)) if spill else None})
    return out


def wgmma_ptxas(entries: list) -> list:
    """The bf16 tensor-core kernel's instances among ``ptxas_entries``."""
    return [e for e in entries if "fa_wgmma_kernel" in e["function"]]


#: padded head widths the bf16 attention kernel is built for
FA_WGMMA_WIDTHS = (16, 32, 48, 64, 80, 96, 112, 128)


def sass_registers(source: str, kernel: str) -> dict:
    """The highest register each instance of ``kernel`` in the built
    ``lib<source>.so`` names in its SASS (``cuobjdump -sass``), by its first
    template argument, with its local-memory loads and stores.  ``ptxas
    -v`` reports the registers a thread is launched with; a warp-specialised
    kernel's consumers run at what ``setmaxnreg`` gives them, which only the
    code shows."""
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()),
                             "cuobjdump")
    sass = subprocess.run(
        [cuobjdump, "-sass", str(_build.build_dir() / f"lib{source}.so")],
        check=True, capture_output=True, text=True, timeout=300).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split("\n", 1)[0]
        m = re.search(r"ILi(\d+)E", name)
        if kernel not in name or not m:
            continue
        out[int(m.group(1))] = {
            "max_register": max(int(r) for r in
                                re.findall(r"\bR(\d+)\b", part)),
            "local_loads": len(re.findall(r"\bLDL\b", part)),
            "local_stores": len(re.findall(r"\bSTL\b", part))}
    return out


def ssd_ptxas(entries: list) -> list:
    """Every SSD-scan kernel instance among ``ptxas_entries``: its variant,
    template arguments (wgmma: chunk, padded N; fma: padded N, P slice),
    registers and spills."""
    out = []
    for e in entries:
        fn = e["function"]
        variant = "wgmma" if "ssd_wgmma_kernel" in fn else \
            "fma" if "ssd_fwd_kernel" in fn else None
        if variant is None:
            continue
        m = re.search(r"ILi(\d+)ELi(\d+)E", fn)
        args = [int(g) for g in m.groups()] if m else []
        keys = ("chunk", "state_padded") if variant == "wgmma" \
            else ("state_padded", "p_block")
        out.append({"variant": variant, **dict(zip(keys, args)),
                    **{k: e[k] for k in ("registers", "spill_store_bytes",
                                         "spill_load_bytes")}})
    return out


# the matmul kernels by the name of their entry function
MM_KERNELS = {"mm16_kernel": "paper16", "mm128_kernel": "fma128",
              "mm_wgmma_kernel": "wgmma"}


def mm_ptxas(entries: list) -> list:
    """Every matmul kernel instance among ``ptxas_entries``: its variant,
    input type, how it reads A and B (16-byte or element copies, TMA), its
    k step and stages where they are template arguments, registers and
    spills."""
    out = []
    for e in entries:
        fn = e["function"]
        variant = next((v for k, v in MM_KERNELS.items() if k in fn), None)
        if variant is None:
            continue
        row = {"variant": variant,
               "dtype": "bfloat16" if "bfloat16" in fn
               or variant == "wgmma" else "float32"}
        m = re.search(r"Li(\d+)ELi(\d+)ELb([01])ELb([01])E", fn)
        if variant == "wgmma":
            row.update(a_copies="tma", b_copies="tma")
        elif m:   # fma128<T, BK, STAGES, VA, VB>
            row.update(bk=int(m.group(1)), stages=int(m.group(2)),
                       a_copies="16-byte" if m.group(3) == "1" else "element",
                       b_copies="16-byte" if m.group(4) == "1" else "element")
        else:     # paper16<T, VA>; B is always copied element by element
            row.update(a_copies="16-byte" if "Lb1E" in fn else "element",
                       b_copies="element")
        out.append({**row, **{k: e[k] for k in (
            "registers", "spill_store_bytes", "spill_load_bytes",
            "function")}})
    return out


def tr_ptxas(entries: list) -> list:
    """Every transpose kernel instance among ``ptxas_entries``: its kernel,
    element type, tile (scalar) or elements an access (the vector kernel),
    registers and spills."""
    out = []
    for e in entries:
        fn = e["function"]
        vec = re.search(r"transpose_vec_kernelI([jt])Li(\d+)E", fn)
        sca = re.search(r"transpose_kernelI([jt])Li(\d+)E", fn)
        if vec:
            row = {"kernel": "transpose_vec_kernel",
                   "elems_per_access": int(vec.group(2))}
        elif sca:
            row = {"kernel": "transpose_kernel", "tile": int(sca.group(2))}
        else:
            continue
        row["dtype"] = "float32" if (vec or sca).group(1) == "j" \
            else "bfloat16"
        out.append({**row, **{k: e[k] for k in (
            "registers", "spill_store_bytes", "spill_load_bytes")}})
    return out


def phase_build():
    t0 = time.perf_counter()
    logs = _build.build_all(extra_flags=("-Xptxas", "-v"), force=True)
    for name in _build.sources():
        _build.load(name)
    info, entries = {}, {}
    for name, log in logs.items():
        entries[name] = ptxas_entries(log)
        regs = [e["registers"] for e in entries[name]
                if e["registers"] is not None]
        spills = [e["spill_store_bytes"] for e in entries[name]
                  if e["spill_store_bytes"] is not None]
        with open(_build.build_dir() / f"{name}.nvcc.log", "w") as f:
            f.write(log)
        info[name] = {"kernels_compiled": len(entries[name]),
                      "max_registers": max(regs, default=None),
                      "max_spill_store_bytes": max(spills, default=None)}
    wg = wgmma_ptxas(entries.get("flash_attention", []))
    # ptxas's notes that it serialised the bf16 kernel's products
    serialised = sorted({m.group(1) for m in re.finditer(
        r"\((C75\d\d)\) Potential Performance Loss.*fa_wgmma_kernel",
        logs.get("flash_attention", ""))})
    if sorted(int(re.search(r"ILi(\d+)E", e["function"]).group(1))
              for e in wg) != list(FA_WGMMA_WIDTHS) \
            or any(e["spill_store_bytes"] or e["spill_load_bytes"]
                   for e in wg):
        raise AssertionError(f"an fa_wgmma_kernel instance spills or was "
                             f"not compiled: {wg}")
    wg_sass = sass_registers("flash_attention", "fa_wgmma_kernel")
    if sorted(wg_sass) != list(FA_WGMMA_WIDTHS) or any(
            r["local_loads"] or r["local_stores"] for r in wg_sass.values()):
        raise AssertionError(f"an fa_wgmma_kernel instance touches local "
                             f"memory: {wg_sass}")
    # ptxas's notes on the bf16 kernel's setmaxnreg (C7508: ignored)
    maxnreg_notes = sorted({m.group(0) for m in re.finditer(
        r"\(C75\d\d\)[^\n]*setmaxnreg[^\n]*",
        logs.get("flash_attention", ""))})
    mmx = mm_ptxas(entries.get("matmul", []))
    if {e["variant"] for e in mmx} != set(MM_KERNELS.values()) or any(
            e["spill_store_bytes"] or e["spill_load_bytes"] for e in mmx):
        raise AssertionError(f"a matmul kernel spills or was not compiled: "
                             f"{mmx}")
    mm_serialised = sorted({m.group(1) for m in re.finditer(
        r"\((C75\d\d)\) Potential Performance Loss.*mm_wgmma_kernel",
        logs.get("matmul", ""))})
    ssx = ssd_ptxas(entries.get("ssd_scan", []))
    ss_wg = [e for e in ssx if e["variant"] == "wgmma"]
    if len(ss_wg) != 4 or any(e["spill_store_bytes"] or e["spill_load_bytes"]
                              for e in ss_wg):
        raise AssertionError(f"an ssd_wgmma_kernel instance spills or was not "
                             f"compiled: {ss_wg}")
    ssd_serialised = sorted({m.group(1) for m in re.finditer(
        r"\((C75\d\d)\) Potential Performance Loss.*ssd_wgmma_kernel",
        logs.get("ssd_scan", ""))})
    trx = tr_ptxas(entries.get("transpose", []))
    tr_vec = [e for e in trx if e["kernel"] == "transpose_vec_kernel"]
    if len(tr_vec) != 2 or any(e["spill_store_bytes"] or e["spill_load_bytes"]
                               for e in tr_vec):
        raise AssertionError(f"a transpose_vec_kernel instance spills or was "
                             f"not compiled: {tr_vec}")
    # the toolkit that built them: the registers the mirrors pin are its
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], check=True,
                          capture_output=True, text=True, timeout=60)
    emit({"phase": "build", "ok": True,
          "seconds": round(time.perf_counter() - t0, 2),
          "nvcc": nvcc.stdout.strip().splitlines()[-1],
          "build_dir": os.path.relpath(_build.build_dir(), ROOT),
          "sources": info, "flash_attention_wgmma_ptxas": wg,
          "flash_attention_wgmma_serialised": serialised,
          "flash_attention_wgmma_sass": wg_sass,
          "flash_attention_wgmma_setmaxnreg_notes": maxnreg_notes,
          "matmul_ptxas": mmx, "matmul_wgmma_serialised": mm_serialised,
          "ssd_scan_ptxas": ssx, "ssd_scan_wgmma_serialised": ssd_serialised,
          "transpose_ptxas": trx})
    return {"flash_attention": wg, "matmul": mmx, "ssd_scan": ssx,
            "transpose": trx}


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
        rows.append({"case": cid, "dtype": str(dtype).replace("torch.", ""),
                     "variant": VARIANT[dtype], "max_abs_err": err,
                     "tol": TOL[dtype]})

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


def phase_lse_cases(gen):
    """The row log-sum-exp both attention kernels write (``return_lse``)
    against the plain version's at the case table, in both layouts; the
    output with lse asked for must be bit-equal to the output without."""
    rows = []
    for (cid, B, H, KVH, Sq, Skv, dh, causal, window, dtype) in FA_CASES:
        err = 0.0
        for main_layout in (False, True):
            q, k, v = fa_inputs(B, H, KVH, Sq, Skv, dh, dtype, gen,
                                as_main_path=main_layout)
            o, lse = kops.flash_attention(q, k, v, causal=causal,
                                          window=window, return_lse=True)
            o0 = kops.flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            _, rlse = fa.attention_reference(q, k, v, causal=causal,
                                             window=window, return_lse=True)
            err = max(err, compare(lse, rlse, TOL[dtype]))
            if not torch.equal(o, o0):
                raise AssertionError(f"{cid}: the output changes when the "
                                     "kernel also writes lse")
        rows.append({"case": cid, "dtype": str(dtype).replace("torch.", ""),
                     "variant": VARIANT[dtype], "lse_max_abs_err": err,
                     "tol": TOL[dtype]})
    emit({"phase": "kernels.lse.cases", "ok": True,
          "kernel": "flash_attention", "against":
              "attention_reference(return_lse=True)", "cases": rows,
          "output_with_lse": "bit-equal to the output without"})
    return rows


def phase_kernel_main_shape(cfg, B, S, gen):
    """flash_attention at a main path's shape: error, times, bound, and the
    tile the bf16 kernel ran (its C query, held to ``tile_rule``)."""
    H, KVH, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    dtype = torch.bfloat16
    tile = fa.tile(dh)
    if tile != fa.tile_rule(dh):
        raise AssertionError(f"the bf16 kernel runs {tile} at head_dim {dh}; "
                             f"tile_rule says {fa.tile_rule(dh)}")
    q, k, v = fa_inputs(B, H, KVH, S, S, dh, dtype, gen)
    o = kops.flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
    torch.cuda.synchronize()
    r = fa.attention_reference(q, k, v, causal=True,
                               window=cfg.sliding_window)
    err = compare(o, r, TOL[dtype])
    del o, r

    def kernel():
        kops.flash_attention(q, k, v, causal=True, window=cfg.sliding_window)

    def kernel_lse():   # the training path's call: the row lse written too
        kops.flash_attention(q, k, v, causal=True, window=cfg.sliding_window,
                             return_lse=True)

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
    lse_a = time_ms(kernel_lse, 2, 10)
    plain_ms = time_ms(plain, 1, 3)
    library_ms = time_ms(library, 2, 10)
    lse_b = time_ms(kernel_lse, 1, 10)
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
                  "window": cfg.sliding_window},
        "variant": VARIANT[dtype],
        "tile": dict(zip(("block_q", "block_k", "stages", "smem_bytes"),
                         tile)),
        "max_abs_err": err, "tol": TOL[dtype],
        "ms": ms, "kernel_ms": ms, "kernel_ms_runs": [ms_a, ms_b],
        "lse_ms": min(lse_a, lse_b), "lse_ms_runs": [lse_a, lse_b],
        "lse_note": "the same call with return_lse=True (the training "
                    "path's), timed in turns with the one without",
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


def ssd_inputs(Bz, H, G, L, P, N, dtype, gen, as_main_path=True,
               bc_dtype=torch.float32):
    """x, dt, A, B, C drawn as the reference's tests draw them (x 0.5·N(0,1),
    dt = softplus(N(0,1)), A = -exp(0.3·N(0,1)), B and C 0.3·N(0,1)).  As the
    main path hands them over: column slices of one (Bz, L, H·P + 2·G·N)
    tensor in x's type, viewed as (Bz, H, L, P) / (Bz, G, L, N), and dt a
    (Bz, L, H) tensor viewed as (Bz, H, L).  Otherwise contiguous, with B and
    C in ``bc_dtype``."""
    def rn(*shape):
        return torch.randn(shape, device=DEV, generator=gen)
    x, Bm, Cm = 0.5 * rn(Bz, L, H, P), 0.3 * rn(Bz, L, G, N), \
        0.3 * rn(Bz, L, G, N)
    dt = F.softplus(rn(Bz, L, H)).transpose(1, 2)
    A = -torch.exp(0.3 * rn(H))
    if not as_main_path:
        return (x.transpose(1, 2).contiguous().to(dtype), dt.contiguous(), A,
                Bm.transpose(1, 2).contiguous().to(bc_dtype),
                Cm.transpose(1, 2).contiguous().to(bc_dtype))
    xbc = torch.cat([t.reshape(Bz, L, -1) for t in (x, Bm, Cm)],
                    dim=-1).to(dtype)
    d, gn = H * P, G * N
    return (xbc[..., :d].reshape(Bz, L, H, P).transpose(1, 2), dt, A,
            xbc[..., d:d + gn].reshape(Bz, L, G, N).transpose(1, 2),
            xbc[..., d + gn:].reshape(Bz, L, G, N).transpose(1, 2))


def phase_ssd_cases(gen):
    """ssd_scan against the naive recurrence and its plain version at the
    case table, in both layouts, each layout on the kernel the table names,
    and across chunks."""
    rows = []
    for (cid, Bz, H, G, L, P, N, chunk, dtype, bc_dtype, want) in SSD_CASES:
        err = herr = 0.0
        variants = []
        for main_layout, v_want in zip((False, True), want):
            x, dt, A, B, C = ssd_inputs(Bz, H, G, L, P, N, dtype, gen,
                                        as_main_path=main_layout,
                                        bc_dtype=bc_dtype)
            t = ssd.tile_for(x, B, C, chunk)
            if t.variant != v_want:
                raise AssertionError(
                    f"ssd {cid} ({'main path' if main_layout else 'contiguous'}"
                    f" layout): served by {t.variant}, expected {v_want}")
            variants.append(t._asdict())
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
                     "bc_dtype_contiguous":
                         str(bc_dtype).replace("torch.", ""),
                     "tile": {"contiguous": variants[0],
                              "main_path": variants[1]},
                     "max_abs_err": err, "tol": SSD_TOL[dtype],
                     "h_max_abs_err": herr, "h_tol": SSD_TOL_H})

    # chunk invariance: the result must not depend on the chunk
    x, dt, A, B, C = ssd_inputs(1, 2, 1, 256, 16, 16, torch.float32, gen)
    outs = [kops.ssd_scan(x, dt, A, B, C, chunk=c)[0]
            for c in (32, 64, 128, 256)]
    x, dt, A, B, C = ssd_inputs(2, 4, 1, 1024, 64, 64, torch.bfloat16, gen)
    hs = [kops.ssd_scan(x, dt, A, B, C, chunk=c)[1] for c in (64, 128, 256)]
    torch.cuda.synchronize()
    inv = max(float((outs[0] - o).abs().max()) for o in outs[1:])
    inv_h = max(float((hs[0] - h).abs().max()) for h in hs[1:])
    if not all(torch.allclose(outs[0], o, atol=SSD_TOL_CHUNKS,
                              rtol=SSD_TOL_CHUNKS) for o in outs[1:]) \
            or not all(torch.allclose(hs[0], h, atol=SSD_TOL_CHUNKS,
                                      rtol=SSD_TOL_CHUNKS) for h in hs[1:]):
        raise AssertionError(f"chunk invariance broken: y (f32) {inv:.3e}, "
                             f"h_final (bf16, wgmma) {inv_h:.3e} beyond "
                             f"{SSD_TOL_CHUNKS:g} abs/rel")
    emit({"phase": "kernels.ssd.cases", "ok": True, "kernel": "ssd_scan",
          "layouts": ["contiguous", "main_path_strided"],
          "against": ["ref.ssd (sequential recurrence)",
                      "ssd_scan_reference (chunked plain version)"],
          "cases": rows, "chunk_invariance_max_abs_diff": inv,
          "chunk_invariance_h_bf16_wgmma_max_abs_diff": inv_h,
          "chunk_invariance_tol": SSD_TOL_CHUNKS})
    return rows


def phase_ssd_main_shape(cfg, B, S, gen, train: bool = False):
    """ssd_scan at a main path's shape, in the main path's layout, with A
    as the model makes it, at the chunk the path resolves (``"auto"``; a
    training path calls under autograd, where the backward's recompute is
    priced too), on the tensor-core kernel: error, times, bound, the FP32
    kernel on the same values (the earlier design) and, at chunk 256 (two
    halves of 128 rows), the same kernel at chunk 128."""
    from repro_torch.kernels import autotune
    s = cfg.ssm
    H, P, N, G = cfg.ssm_heads, s.head_dim, s.d_state, s.n_groups
    dtype = torch.bfloat16
    x, dt, _, Bm, Cm = ssd_inputs(B, H, G, S, P, N, dtype, gen)
    Q = autotune.best_block_sizes(
        "ssd_scan", dict(kops.ssd_scan_shape(x, Bm, Cm), grad=train),
        kops.CARD_MODEL)["chunk"]
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

    # the FP32 kernel on the same values: B and C in f32 send the call to it
    # (mixed types), the design this kernel replaces
    Bf, Cf = Bm.float(), Cm.float()

    def fp32_kernel():
        kops.ssd_scan(x, dt, A, Bf, Cf, chunk=Q)

    def at_128():
        kops.ssd_scan(x, dt, A, Bm, Cm, chunk=128)

    if ssd.tile_for(x, Bf, Cf, Q).variant != "fma":
        raise AssertionError("mixed types must go to the FP32 kernel")
    ms_a = time_ms(kernel, 2, 10)
    plain_ms = time_ms(plain, 1, 3)
    fma_ms = time_ms(fp32_kernel, 1, 5)
    ms_128 = time_ms(at_128, 1, 10) if Q == 256 else None
    ms_b = time_ms(kernel, 1, 10)

    t = ssd.tile_for(x, Bm, Cm, Q)
    if t.variant != "wgmma":
        raise AssertionError(f"{cfg.name}: the main path's SSD scan is served "
                             f"by {t.variant}, not the tensor-core kernel")

    # operations as the reference's schedule_props counts them, at the chunk
    # rows the kernel walks (two halves of 128 at chunk 256); bytes: each
    # input read once, each output written once
    def schedule_flops(q):
        return B * H * (S // q) * 2.0 * (q * q * N + q * q * P + 2 * q * P * N)

    flops = schedule_flops(ssd.wgmma_rows(Q))
    nbytes = (2 * x.numel() * x.element_size()           # x in, y out
              + dt.numel() * 4 + A.numel() * 4
              + (Bm.numel() + Cm.numel()) * Bm.element_size()
              + B * H * P * N * 4)                         # h_final out
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    ms = min(ms_a, ms_b)
    bound = max(t_ops, t_bytes) * 1e3
    return {
        "arch": cfg.name,
        "shape": {"Bz": B, "H": H, "G": G, "L": S, "P": P, "N": N,
                  "chunk": Q, "dtype": "bfloat16",
                  "x_strides": list(x.stride())},
        "path": "train" if train else "prefill",
        "variant": t.variant, "tile": t._asdict(),
        "max_abs_err": err, "tol": SSD_TOL[dtype],
        "h_max_abs_err": herr, "h_tol": SSD_TOL_H,
        "ms": ms, "kernel_ms": ms, "kernel_ms_runs": [ms_a, ms_b],
        "plain_ms": plain_ms, "library_ms": None, "library_call": None,
        "library_note": "no single PyTorch call computes the SSD scan",
        "fp32_kernel_ms": fma_ms,
        "fp32_kernel_note": "ssd_fwd_kernel on the same values (B and C in "
                            "f32), timed in the same run",
        **({"wgmma_ms_at_chunk_128": ms_128,
            "chunk_256_note": "walked as two halves of 128 rows by the "
                              "chunk-128 instance",
            "ops_ms_one_256_chunk": schedule_flops(Q) / PEAK_BF16_FLOPS * 1e3}
           if Q == 256 else {}),
        "bound_ms": bound, "share_of_bound": bound / ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "ops_ms": t_ops * 1e3, "bytes_ms": t_bytes * 1e3,
        "flops": flops, "bytes": nbytes,
        "achieved_tflops": flops / (ms * 1e-3) / 1e12,
    }


def phase_ssd_backward_main_shape(cfg, B, S, gen) -> dict:
    """The SSD scan's backward kernels at a training path's shape, in the
    main path's layout: each gradient against ``torch.autograd.grad``
    through the plain version in f32 at the chunk the path picks, held to
    its own limit (``TOL_SSD_BACKWARD``), the kernels' time (CUDA events),
    the function's bound and the time of the plain recompute it replaced
    (``ssd_scan_reference`` and its autograd at that chunk, host clock: it
    is host-bound).  The bound is what the function must do, not what the
    kernels do: its products a step of ``ssd.BACKWARD_STEP`` rows, each
    MAC once, at the bf16 peak, or its inputs read once and its gradients
    written once at the memory peak, whichever is longer; the kernels'
    workspaces (f32 states, per-head shares) are theirs, not the
    function's."""
    from repro_torch.kernels import autotune
    s = cfg.ssm
    H, P, N, G = cfg.ssm_heads, s.head_dim, s.d_state, s.n_groups
    x, dt, A, Bm, Cm = ssd_inputs(B, H, G, S, P, N, torch.bfloat16, gen)
    if ssd.backward_path(x, dt, A, Bm, Cm) != "kernel":
        raise AssertionError(f"{cfg.name}: the training path's SSD backward "
                             "does not go to the backward kernels")
    Q = autotune.best_block_sizes(
        "ssd_scan", dict(kops.ssd_scan_shape(x, Bm, Cm), grad=True),
        kops.CARD_MODEL)["chunk"]
    dy = torch.randn(x.shape, device=DEV, generator=gen).to(x.dtype)
    before = ssd.ssd_scan_backward.launches
    got = kops.ssd_scan_backward(x, dt, A, Bm, Cm, dy)
    launches = ssd.ssd_scan_backward.launches - before
    torch.cuda.synchronize()

    def plain():
        ins = [t.detach().float().requires_grad_()
               for t in (x, dt, A, Bm, Cm)]
        yr, _ = ssd.ssd_scan_reference(*ins, chunk=Q)
        return torch.autograd.grad(yr, ins, dy.float())

    want = plain()
    errs = {n: rel_diff(a, b) for n, a, b in zip(("x", "dt", "A", "B", "C"),
                                                 got, want)}
    del got, want
    ms = time_ms(lambda: kops.ssd_scan_backward(x, dt, A, Bm, Cm, dy), 2, 10)
    plain()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        plain()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) / 2 * 1e3
    # a step of T rows: C Bᵀ, dy xᵀ, Wᵀ dy, dS B and dSᵀ C over T × T (the
    # masked ones counted whole, as the forward's schedule counts them), the
    # two state terms, and the three products with h and dh
    T = ssd.BACKWARD_STEP
    flops = B * H * (S // T) * 2.0 * (T * T * (3 * N + 2 * P)
                                      + 5 * T * P * N)
    # x and dy in, dx out; dt in, ddt out; A in, dA out; B and C in, dB and
    # dC out
    nbytes = (3 * x.numel() * x.element_size()
              + 2 * dt.numel() * 4 + 2 * A.numel() * 4
              + 2 * (Bm.numel() + Cm.numel()) * Bm.element_size())
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    bound = max(t_ops, t_bytes) * 1e3
    ok = all(errs[n] <= TOL_SSD_BACKWARD[n] for n in errs) \
        and launches == ssd.BACKWARD_LAUNCHES
    return {"arch": cfg.name, "ok": ok,
            "shape": {"Bz": B, "H": H, "G": G, "L": S, "P": P, "N": N,
                      "chunk": Q, "x_strides": list(x.stride())},
            "rel_err": errs, "tol": TOL_SSD_BACKWARD,
            "launches": launches, "step": ssd.BACKWARD_STEP,
            "ms": ms, "plain_ms": plain_ms,
            "plain_note": "ssd_scan_reference and torch.autograd.grad at "
                          "the chunk, f32, host clock",
            "bound_ms": bound, "share_of_bound": bound / ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops_ms": t_ops * 1e3, "bytes_ms": t_bytes * 1e3,
            "flops": flops, "bytes": nbytes,
            "achieved_tflops": flops / (ms * 1e-3) / 1e12,
            "pipes": "TF32 mma.sync, f32 operands as hi + lo pairs; the "
                     "bound counts each MAC once at the bf16 peak"}


# ---------------------------------------------------------------------------
# matmul and transpose, and the calibration path that runs them


def mm_operand(rows, cols, dtype, layout, gen):
    """A (rows, cols) operand laid out as ``layout`` says (see
    ``MM_CASES``)."""
    extra = {"contig": 0, "offset": 1, "stride": 3,
             "pad8": -cols % 8 + 8}[layout]
    wide = torch.randn((rows, cols + extra), device=DEV,
                       generator=gen).to(dtype)
    return wide[:, 1:] if layout == "offset" else wide[:, :cols]


def phase_matmul_cases(gen):
    """matmul against its plain version at the case table, each case served
    by the kernel the table names."""
    rows = []
    for (cid, M, K, N, blk, dtype, layout, want) in MM_CASES:
        a = mm_operand(M, K, dtype, layout, gen)
        b = mm_operand(K, N, dtype, layout, gen)
        t = mm.tile_for(a, b, blk, blk, blk)
        if t.variant != want:
            raise AssertionError(f"matmul {cid}: served by {t.variant}, "
                                 f"expected {want}")
        o = kops.matmul(a, b, block_m=blk, block_n=blk, block_k=blk)
        torch.cuda.synchronize()
        atol, rtol = MM_TOL[dtype]
        err = compare(o, mm.matmul_reference(a, b), atol, rtol)
        rows.append({"case": cid, "M": M, "K": K, "N": N, "block": blk,
                     "dtype": str(dtype).replace("torch.", ""),
                     "layout": layout, "lda": a.stride(0),
                     "ldb": b.stride(0), "variant": t.variant,
                     "tile": [t.bm, t.bn, t.bk], "stages": t.stages,
                     "max_abs_err": err, "atol": atol, "rtol": rtol})
    emit({"phase": "kernels.matmul.cases", "ok": True, "kernel": "matmul",
          "cases": rows})
    return rows


def tr_operand(shape, dtype, layout, gen):
    """An (M, N) input laid out as ``layout`` says (see ``TR_CASES``)."""
    M, N = shape
    if layout == "offset":
        flat = torch.randn(M * N + 1, device=DEV, generator=gen).to(dtype)
        return flat[1:].view(M, N)
    extra = {"contig": 0, "stride": 3, "pad": 8}[layout]
    return torch.randn((M, N + extra), device=DEV,
                       generator=gen).to(dtype)[:, :N]


def phase_transpose_cases(gen):
    """transpose against its plain version at the case table, each case on
    the variant the table names: exact.  vec16 named for a layout it cannot
    read must be refused, not served by another kernel."""
    rows = []
    for (cid, shape, blk, dtype, layout, forced, want) in TR_CASES:
        x = tr_operand(shape, dtype, layout, gen)
        if tr.pick_variant(x, blk) != want:
            raise AssertionError(f"transpose {cid}: pick_variant says "
                                 f"{tr.pick_variant(x, blk)}, expected {want}")
        variant = forced or want
        o = tr.transpose(x, block=blk, variant=forced) if forced \
            else kops.transpose(x, block=blk)
        torch.cuda.synchronize()
        if not torch.equal(o, tr.transpose_reference(x)):
            raise AssertionError(f"transpose {cid}: not equal to x.t()")
        if want == "scalar" and blk < 32:
            try:
                tr.transpose(x, block=blk, variant="vec16")
            except RuntimeError:
                pass
            else:
                raise AssertionError(f"transpose {cid}: vec16 was not "
                                     "refused for a layout it cannot read")
        t = tr.tile(blk, dtype, variant)
        rows.append({"case": cid, "shape": list(shape), "block": blk,
                     "dtype": str(dtype).replace("torch.", ""),
                     "layout": layout, "ldx": x.stride(0),
                     "variant": variant, "tile": t.edge,
                     "threads": t.threads, "max_abs_err": 0.0,
                     "tol": "exact"})
    emit({"phase": "kernels.transpose.cases", "ok": True,
          "kernel": "transpose", "cases": rows})
    return rows


def largest_tiled(key: str) -> int:
    """n of the calibration's largest tiled case of a class (t = 3)."""
    return 2 ** (mkernels._P[CALIB_SCALE][key] + 3)


def phase_matmul_main_shape(gen):
    """matmul at the calibration's largest mm_tiled case: the paper's 16³
    tile in f32 (the main path's), the 128 tile in f32, and bf16 on the
    tensor cores, each against its bound, the plain version and
    ``torch.matmul`` on the same inputs."""
    n, g = largest_tiled("mm"), mkernels.GSIZE
    a32 = mkernels._rand(gen, (n, n), DEV)
    b32 = mkernels._rand(gen, (n, n), DEV)
    rows = []
    for (label, a, b, blk) in (
            ("paper16 f32", a32, b32, g), ("fma128 f32", a32, b32, 128),
            ("wgmma bf16", a32.bfloat16(), b32.bfloat16(), 128)):
        t = mm.tile_for(a, b, blk, blk, blk)
        o = kops.matmul(a, b, block_m=blk, block_n=blk, block_k=blk)
        torch.cuda.synchronize()
        atol, rtol = MM_TOL[a.dtype]
        err = compare(o, mm.matmul_reference(a, b), atol, rtol)
        del o

        def kernel():
            kops.matmul(a, b, block_m=blk, block_n=blk, block_k=blk)

        def plain():
            mm.matmul_reference(a, b)

        def library():  # the yardstick, timed here only (no TF32 for f32)
            torch.matmul(a, b)

        reps = 5 if t.variant == "paper16" else 20
        ms_a = time_ms(kernel, 1, reps)
        plain_ms = time_ms(plain, 2, 10)
        library_ms = time_ms(library, 2, 20)
        ms_b = time_ms(kernel, 1, reps)
        flops = 2.0 * n ** 3
        nbytes = 3 * n * n * a.element_size()
        peak = PEAK_BF16_FLOPS if a.dtype == torch.bfloat16 \
            else PEAK_FP32_FLOPS
        t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
        ms = min(ms_a, ms_b)
        rows.append({
            "label": label,
            "shape": {"M": n, "K": n, "N": n,
                      "dtype": str(a.dtype).replace("torch.", ""),
                      "block": [blk, blk, blk]},
            "variant": t.variant, "tile": [t.bm, t.bn, t.bk],
            "stages": t.stages, "smem_bytes": t.smem,
            "max_abs_err": err, "atol": atol, "rtol": rtol,
            "ms": ms, "kernel_ms": ms, "kernel_ms_runs": [ms_a, ms_b],
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_call": "torch.matmul"
                            + (" (allow_tf32=False)"
                               if a.dtype == torch.float32 else ""),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops_ms": t_ops * 1e3, "bytes_ms": t_bytes * 1e3,
            "flops": flops, "bytes": nbytes,
            "achieved_tflops": flops / (ms * 1e-3) / 1e12,
            "library_tflops": flops / (library_ms * 1e-3) / 1e12,
        })
    return rows


def tr_ladder() -> list:
    """n of the calibration's four tiled transpose cases."""
    p = mkernels._P[CALIB_SCALE]["transpose"]
    return [2 ** (p + t) for t in range(4)]


def graph_ms(fn, calls: int) -> float:
    """Device milliseconds a call of ``fn``: ``calls`` calls captured in one
    CUDA graph and replayed, so the host's work per call is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = time_ms(graph.replay, 1, 5) / calls
    del graph
    return ms


def graph_median_ms(fn, calls: int, reps: int) -> float:
    """Median device milliseconds a call of ``fn``: ``calls`` calls captured
    in one CUDA graph, each of ``reps`` replays timed by CUDA events around
    it.  The replay enqueues the calls in one host call, so a slow host
    adds nothing.  The capture calls ``fn`` (and its wrapper counts a
    launch) ``calls`` times, and once more on a side stream before it;
    the replays launch the captured kernels without calling the
    wrappers, so they count nothing."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return float(np.median(times))


def host_us(fn, calls: int) -> float:
    """Host microseconds a call of ``fn`` takes to return: its work on the
    host and the launch queued, not waited for."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def tr_row(label, x, variant, reps, main_path):
    """One timed transpose at the 16 tile: ``variant`` on ``x`` through the
    entry point that names it (the same for every variant), exact against
    x.t(): CUDA events around back-to-back calls, the device's own time (a
    CUDA graph of the calls) and the host's per call, beside the empty
    kernel over the same grid.  With ``main_path`` (the variant
    ``pick_variant`` names) also the main path's own call
    (``kops.transpose``), ``pick_variant`` alone, the plain version and
    ``x.t().contiguous()``."""
    g = mkernels.GSIZE
    n_m, n_n = x.shape
    o = tr.transpose(x, block=g, variant=variant)
    torch.cuda.synchronize()
    if not torch.equal(o, tr.transpose_reference(x)):
        raise AssertionError(f"transpose {label}: not x.t()")
    del o

    def kernel():
        tr.transpose(x, block=g, variant=variant)

    def floor():
        tr.launch_empty(n_m, n_n, block=g, dtype=x.dtype, variant=variant)

    ms_a = time_ms(kernel, 2, reps)
    floor_ms = time_ms(floor, 2, reps)
    row = {"device_ms": graph_ms(kernel, min(reps, 100)),
           "host_us": host_us(kernel, min(reps, 200)),
           "dispatch_floor_device_ms": graph_ms(floor, min(reps, 100)),
           "plain_ms": None, "library_ms": None, "library_call": None}
    if main_path:
        if tr.pick_variant(x, g) != variant:
            raise AssertionError(f"transpose {label}: the main path picks "
                                 f"{tr.pick_variant(x, g)}, not {variant}")

        def main_call():
            kops.transpose(x, block=g)
        calls = 20000
        t0 = time.perf_counter()
        for _ in range(calls):
            tr.pick_variant(x, g)
        pick_us = (time.perf_counter() - t0) / calls * 1e6
        row.update({
            "main_path_ms": time_ms(main_call, 2, reps),
            "main_path_host_us": host_us(main_call, min(reps, 200)),
            "pick_variant_us": pick_us,
            "plain_ms": time_ms(lambda: tr.transpose_reference(x), 2, reps),
            "library_ms": time_ms(lambda: x.t().contiguous(), 2, reps),
            "library_call": "x.t().contiguous()"})
    ms_b = time_ms(kernel, 2, reps)
    nbytes = 2 * x.numel() * x.element_size()
    bound = nbytes / PEAK_HBM_BYTES * 1e3
    ms = min(ms_a, ms_b)
    t = tr.tile(g, x.dtype, variant)
    return {
        "label": label,
        "shape": {"M": n_m, "N": n_n,
                  "dtype": str(x.dtype).replace("torch.", ""), "block": g},
        "variant": variant, "tile": t.edge, "threads": t.threads,
        "smem_bytes": t.smem, "max_abs_err": 0.0, "tol": "exact",
        "ms": ms, "kernel_ms": ms, "kernel_ms_runs": [ms_a, ms_b], **row,
        "dispatch_floor_ms": floor_ms,
        "dispatch_floor_note": f"an empty kernel over the same grid "
                               f"({t.threads} threads a block)",
        "bound_ms": bound, "bound_by": "bytes", "bytes": nbytes,
        "share_of_bound": bound / ms,
        "achieved_tb_per_s": nbytes / (ms * 1e-3) / 1e12,
    }


def phase_transpose_main_shape(gen):
    """transpose at the 16 tile at the calibration's four sizes (n x n f32):
    the variant the calibration runs (vec16) and the one it replaced
    (scalar at the 16 tile) on the same inputs; at the largest size also
    vec16 in bf16."""
    rows = []
    ladder = tr_ladder()
    for n in reversed(ladder):   # the largest (the kernels line's) first
        x = mkernels._rand(gen, (n, n), DEV)
        reps = min(500, 20 * (ladder[-1] // n) ** 2)
        rows.append(tr_row(f"vec16 f32 n{n}", x, "vec16", reps, True))
        rows.append(tr_row(f"scalar16 f32 n{n}", x, "scalar", reps, False))
        if n == ladder[-1]:
            xb = x.bfloat16()
            del x
            rows.append(tr_row(f"vec16 bf16 n{n}", xb, "vec16", reps, True))
            del xb
        torch.cuda.empty_cache()
    return rows


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
    """The held-out step of Table 1 (``paper_table1.heldout``): the model
    loaded back by name predicts the 16 test cases, which are timed under
    the same protocol; then the Table 1 record and the model's file under
    ``EXPERIMENTS_OUT``."""
    loaded = registry.load_model(CALIB_DEVICE, out_dir)
    if loaded.keys != res.model.keys \
            or not np.array_equal(loaded.weights, res.model.weights):
        raise AssertionError("the registered model differs from the fitted")
    records = []
    with counted_timing(records):
        got, pvs = paper_table1.heldout(loaded, CALIB_SCALE, DEV,
                                        launch_s=res.launch_overhead_s)
    if len(records) != len(got):
        raise AssertionError(f"{len(records)} timings of {len(got)} cases")
    rows = []
    for r, pv, rec in zip(got, pvs, records):
        pred = loaded.predict(pv)
        if pred != res.model.predict(pv) or not math.isfinite(pred) or \
                r["predicted_ms"] != pred * 1e3:
            raise AssertionError(f"{r['kernel']}: prediction {pred!r} not "
                                 "bit-identical to the fitted model's")
        count = check_counts(r["kernel"], rec)
        rows.append({"case": r["kernel"], "class": r["class"],
                     "actual_s": r["actual_ms"] / 1e3, "predicted_s": pred,
                     "rel_err": r["rel_err"], "calls": count["calls"],
                     "launches": count["launches"]})
    classes = sorted({r["class"] for r in rows})
    per_class = {k: geomean(r["rel_err"] for r in rows if r["class"] == k)
                 for k in classes}
    emit({"phase": "heldout", "ok": True, "device": CALIB_DEVICE,
          "cases": rows, "geomean_rel_err_by_class": per_class,
          "geomean_rel_err": geomean(r["rel_err"] for r in rows),
          "paper_geomeans": {"Titan X": 0.16, "C2070": 0.14, "K40": 0.06,
                             "R9 Fury": 0.42}})
    table = paper_table1.record(loaded, res.launch_overhead_s,
                                len(res.labels),
                                res.report["geomean_rel_err"], got)
    has_keys("table1", table, TABLE1_KEYS)
    path = paper_table1.write(table, loaded, CALIB_SCALE, EXPERIMENTS_OUT)
    emit({"phase": "table1", "ok": True, "device": table["device"],
          "n_measurement_kernels": table["n_measurement_kernels"],
          "fit_geomean_rel_err": table["fit_geomean_rel_err"],
          "per_class_geomean": table["per_class_geomean"],
          "overall_geomean_rel_err": table["overall_geomean_rel_err"],
          "paper_band": table["paper_band"],
          "launch_overhead_us": table["launch_overhead_us"],
          "model_file": os.path.relpath(path, ROOT)})
    return rows


def has_keys(name: str, rec: dict, keys) -> None:
    """A record holds every key of the reference's."""
    missing = [k for k in keys if k not in rec]
    if missing:
        raise AssertionError(f"{name}: the record lacks {missing}")


def phase_table2(reg_dir: str) -> dict:
    """``paper_table2`` on the model Table 1 wrote: the fitted weights
    beside the ``gpu-h100`` and v5e (a TPU's) seeds; the ten most salient
    by |weight| in the line."""
    with contextlib.redirect_stdout(io.StringIO()) as text:
        rec = paper_table2.table(CALIB_SCALE, DEV, EXPERIMENTS_OUT, reg_dir)
    has_keys("table2", rec, TABLE2_KEYS)
    fit = rec["fit"]
    if not fit or not all(math.isfinite(w) for w in fit.values()):
        raise AssertionError("table2: a fitted weight is not finite")
    if "h100 seed" not in text.getvalue():
        raise AssertionError("table2: no gpu-h100 seed column")
    top = sorted(fit, key=lambda k: -abs(fit[k]))[:10]
    line = {"phase": "table2", "ok": True, "device": rec["device"],
            "n_weights": len(fit),
            "top": [{"key": k, "fit": fit[k],
                     "gpu_h100_seed": rec["gpu_h100_seed"].get(k),
                     "tpu_v5e_seed": rec["tpu_v5e_seed"].get(k)}
                    for k in top]}
    emit(line)
    return line


def phase_validate(reg_dir: str) -> dict:
    """``predictor_validation`` at the ``gpu`` scale on the model Table 1
    wrote: every architecture's AdamW training step at full width (depth
    cut only as far as the card forces), extracted, predicted and timed.
    Each timed step launches its kernels twice a layer (remat ``full``:
    the forward and the backward's recompute), once a call of the
    timing.  -> the launch counts (set to 0 just before, read just
    after)."""
    name = paper_table1.model_name(DEV, CALIB_SCALE)
    if not os.path.exists(paper_table1.model_path(EXPERIMENTS_OUT, name,
                                                  CALIB_SCALE)):
        raise AssertionError("validate: Table 1 wrote no model")
    torch.cuda.empty_cache()
    records = []
    reset_launches()
    with counted_timing(records):
        res = predictor_validation.run(
            scale=CALIB_SCALE, device=DEV, out=EXPERIMENTS_OUT,
            registry=reg_dir, trace_workers=VALIDATE_TRACE_WORKERS,
            verbose=False)
    launched = read_launches()
    has_keys("validate", res, VALIDATION_KEYS)
    ok = [r for r in res["rows"] if r["status"] == "ok"]
    if len(records) != len(ok):
        raise AssertionError(f"validate: {len(records)} timings of "
                             f"{len(ok)} steps")
    want = {k: 0 for k in launched}
    for r, rec in zip(ok, records):
        has_keys(f"validate {r['arch']}", r, VALIDATION_ROW_KEYS)
        if not (math.isfinite(r["predicted_ms"]) and r["predicted_ms"] > 0):
            raise AssertionError(f"validate {r['arch']}: prediction "
                                 f"{r['predicted_ms']!r}")
        cfg = get_arch(r["arch"])
        cfg = dataclasses.replace(cfg, n_layers=r["layers_run"]) \
            if CALIB_SCALE == "gpu" else cfg.reduced()
        per = train_launches_per_step(cfg, res["S"])
        r["calls"] = rec["calls"]
        r["launches"] = rec["launches"]
        if rec["launches"] != {k: rec["calls"] * per[k] for k in per}:
            raise AssertionError(f"validate {r['arch']}: launches "
                                 f"{rec['launches']}, {rec['calls']} calls "
                                 f"of {per}")
        for k in want:
            want[k] += rec["launches"][k]
    if launched != want:
        raise AssertionError(f"validate: launches {launched}, expected "
                             f"{want}")
    emit({"phase": "validate", "ok": True, "device": res["device"],
          "B": res["B"], "S": res["S"],
          "geomean_rel_err": res["geomean_rel_err"],
          "geomean_rel_err_calibrated": res["geomean_rel_err_calibrated"],
          "calibration_factor": res["calibration_factor"],
          "rows": res["rows"], "launches": launched})
    return launched


def phase_roofline() -> dict:
    """``roofline`` on the dry run's record of the gspmd phase (the 16 x 16
    llama3.2-3b ``train_4k`` cell) at the H100's rates."""
    path = os.path.join(EXPERIMENTS_OUT, "dryrun_torch.json")
    with contextlib.redirect_stdout(io.StringIO()):
        rows = roofline.main([path, "--mesh", "16x16", "--out",
                              EXPERIMENTS_OUT])
    if len(rows) != 1:
        raise AssertionError(f"roofline: {len(rows)} rows")
    (row,) = rows
    has_keys("roofline", row, ROOFLINE_KEYS)
    terms = [row[k] for k in ("compute_s", "memory_s", "collective_s")]
    if not all(math.isfinite(t) and t > 0 for t in terms):
        raise AssertionError(f"roofline: terms {terms}")
    if not ROOFLINE_USEFUL[0] < row["useful_ratio"] < ROOFLINE_USEFUL[1]:
        raise AssertionError(f"roofline: useful_ratio {row['useful_ratio']}")
    line = {"phase": "roofline", "ok": True, "rates": {
        "peak_bf16": roofline.PEAK, "hbm": roofline.HBM,
        "link": roofline.LINK}, **row}
    emit(line)
    return line


def phase_kernel_roofline() -> dict:
    """``kernel_roofline`` on ``KROOF_ARGS`` in a process of its own (its
    fake world of 256 ranks is that process's default group)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m",
                        "repro_torch.benchmarks.kernel_roofline",
                        *KROOF_ARGS, "--out", EXPERIMENTS_OUT], env=env,
                       capture_output=True, text=True, timeout=KROOF_TIMEOUT)
    seconds = time.perf_counter() - t0
    if p.returncode != 0:
        raise AssertionError(f"kernel_roofline exited {p.returncode}:\n"
                             f"{p.stdout[-4000:]}\n{p.stderr[-4000:]}")
    arch, shape = KROOF_ARGS[1], KROOF_ARGS[3]
    with open(os.path.join(EXPERIMENTS_OUT, f"torch_kernel_roofline_{arch}_"
                           f"{shape}.json")) as f:
        rec = json.load(f)
    has_keys("kernel_roofline", rec, KROOF_KEYS)
    terms = [*rec["xla_terms_s"].values(), *rec["kernel_terms_s"].values()]
    if not all(math.isfinite(t) and t >= 0 for t in terms) or \
            rec["attention_attributable"]["flops"] <= 0 or \
            rec["kernel_attention"]["flops"] <= 0:
        raise AssertionError(f"kernel_roofline: {rec}")
    line = {"phase": "kernel_roofline", "ok": True, "args": KROOF_ARGS,
            "seconds": seconds, **rec}
    emit(line)
    return line


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
    64 steps of ~8 ops; conv: 49 taps) at both ends of the ladder, and of
    the smallest ``mm_tiled`` case (one launch of the 16³ kernel, timed by
    events: the profiler recorded no device time for it)."""
    P, Q = mkernels._P[CALIB_SCALE], tkernels._P[CALIB_SCALE]
    gen = mkernels._generator(seed, DEV)
    mm_small = mkernels._mm_cases(True, P["mm"], gen, DEV)[0]
    arith = [c for c in mkernels._arith_cases(P["arith"], DEV)
             if c.meta["kind"] == "exp"]
    conv = tkernels._conv_cases(Q["conv"], mkernels._generator(seed, DEV),
                                DEV)
    out = {}
    with torch.no_grad():
        for c in (arith[0], arith[-1], conv[0], conv[-1]):
            out[c.name] = _profile(c.jitted(), 3)
        out[mm_small.name] = _idle_by_events(mm_small.jitted(), 30)
    emit({"phase": "calibrate.profile", "ok": True, "cases": out})


def _idle_by_events(fn, calls: int) -> dict:
    """Device idle share of a one-kernel call as the calibration times it
    (the call, then a synchronise): its device time from CUDA events over
    back-to-back calls, against the median host time of a synchronised
    call."""
    device_ms = time_ms(fn, 3, 50)
    wall = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    wall_ms = float(np.median(wall))
    return {"wall_ms": wall_ms, "device_busy_ms": device_ms,
            "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
            "timed_by": "CUDA events (device), host clock (wall)"}


# ---------------------------------------------------------------------------
# the main paths

KERNELS = {"flash_attention": fa.flash_attention, "ssd_scan": ssd.ssd_scan,
           "matmul": mm.matmul, "transpose": tr.transpose,
           "ssd_scan_backward": ssd.ssd_scan_backward}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def launches_per_step(cfg) -> dict:
    """The kernel launches one prefill step of ``cfg`` must make: one
    ``flash_attention`` a layer for the attention families (dense, moe, vlm,
    audio); one ``ssd_scan`` a layer, and one ``flash_attention`` a site of
    the shared block, for ssm and hybrid; no ``ssd_scan_backward``."""
    counts = {"flash_attention": 0, "ssd_scan": 0, "matmul": 0,
              "transpose": 0, "ssd_scan_backward": 0}
    if cfg.family == "hybrid":
        counts.update(flash_attention=cfg.n_layers // cfg.hybrid.attn_every,
                      ssd_scan=cfg.n_layers)
    elif cfg.family == "ssm":
        counts["ssd_scan"] = cfg.n_layers
    else:
        counts["flash_attention"] = cfg.n_layers
    return counts


# ---------------------------------------------------------------------------
# what each main path measured, for the predict phase

#: one entry a measured path: its config, workload, plan, measured seconds
#: and, where --profile ran, its device-idle share
PATHS = []
#: the plan the trainer runs under (``Trainer``'s default; remat from the
#: config), and the one-device mesh every path runs on
TRAINER_PLAN = Plan(dp_axes=())
MESH1 = {"data": 1}
#: predictions of one path must agree across the three entry points to this
PREDICT_RTOL = 1e-9


def record_path(cfg, kind: str, spec: WorkloadSpec, seconds: float,
                timed_by: str, plan: Plan = None, **extra) -> None:
    PATHS.append({"path": f"{cfg.name}:{kind}", "cfg": cfg, "spec": spec,
                  "plan": plan or Plan(dp_axes=()), "measured_s": seconds,
                  "timed_by": timed_by, "device_idle_share": None, **extra})


def record_idle(cfg, kind: str, prof: dict) -> None:
    """The idle share a --profile trace measured, on the path's entry."""
    for p in PATHS:
        if p["path"] == f"{cfg.name}:{kind}":
            p["device_idle_share"] = prof.get("device_idle_share")


def _seconds(pred) -> dict:
    return {"seconds": pred.seconds, "terms": pred.terms, "mfu": pred.mfu}


#: the kernel registries every path is predicted under: the reference's
#: Pallas blocks, then the CUDA kernels the card launches
PREDICT_KERNELS = (("pallas", kernelmodel.PALLAS_KERNELS),
                   ("cuda", kernelmodel.KERNELS))


def phase_predict(out_dir: str, cache_dir: str):
    """The step predictor on the card's own numbers: for every path
    measured above and each registry of ``PREDICT_KERNELS`` (one
    ``predict`` line each), ``predict_step`` under the ``gpu-h100`` model
    fitted in this run (loaded back by name) and under the analytic
    ``gpu-h100`` seed, beside the measured seconds.  ``unpriced``: each
    property with a nonzero count the fitted model has no weight for (its
    prediction skips it), with its seconds under the seed.  Fails where a
    prediction is not finite and above 0, or where ``predict_plans`` or
    ``StragglerMonitor.from_model`` disagree with ``predict_step`` beyond
    ``PREDICT_RTOL``."""
    fitted = registry.load_model(CALIB_DEVICE, out_dir)
    if fitted.meta.get("source") != "calibrated":
        raise AssertionError(f"{CALIB_DEVICE} loaded from the registry is "
                             f"{fitted.meta.get('source')!r}, not the fit")
    seed = seeds.ANALYTIC_SEEDS[CALIB_DEVICE]()
    models = {"fitted": fitted, "seed": seed}
    seed_w = dict(zip(seed.keys, (float(w) for w in seed.weights)))
    fitted_keys = set(fitted.keys)
    budget = torch.cuda.get_device_properties(0).total_memory
    cold_s = 0.0
    for kname, kernels in PREDICT_KERNELS:
        for p in PATHS:
            cold_s += predict_path(p, kname, kernels, models, seed_w,
                                   fitted_keys, budget)
    emit({"phase": "predict.summary", "ok": True, "paths": len(PATHS),
          "kernels": [k for k, _ in PREDICT_KERNELS],
          "fitted_meta": {k: fitted.meta.get(k) for k in
                          ("source", "fit_geomean_rel_err")},
          "fitted_keys": sorted(fitted_keys),
          "card_memory_bytes": budget,
          "step_programs_cold_build_s": cold_s,
          "compile_cache_dir_files": len(os.listdir(cache_dir)),
          "compile_cache": exprops.disk_cache_report()})


def predict_path(p: dict, kname: str, kernels, models: dict, seed_w: dict,
                 fitted_keys: set, budget: float) -> float:
    """One ``predict`` line: path ``p`` under the registry ``kernels``;
    returns the seconds the first ``predict_plans`` took (it builds the
    programs)."""
    cfg, spec, plan = p["cfg"], p["spec"], p["plan"]
    t0 = time.perf_counter()
    plans = {n: float(predictor.predict_plans(cfg, spec, [plan], MESH1, m,
                                              kernels=kernels)[0])
             for n, m in models.items()}
    build_s = time.perf_counter() - t0   # the first builds its programs
    t0 = time.perf_counter()
    preds = {n: predictor.predict_step(cfg, spec, plan, MESH1, m,
                                       kernels=kernels)
             for n, m in models.items()}
    step_s = time.perf_counter() - t0
    monitor = StragglerMonitor.from_model(cfg, spec, plan, MESH1, n_hosts=1,
                                          model=models["fitted"],
                                          kernels=kernels)
    for n, pred in preds.items():
        if not (math.isfinite(pred.seconds) and pred.seconds > 0):
            raise AssertionError(f"{p['path']} ({kname}): {n} predicts "
                                 f"{pred.seconds!r} s")
        if abs(plans[n] - pred.seconds) > PREDICT_RTOL * pred.seconds:
            raise AssertionError(f"{p['path']} ({kname}): predict_plans "
                                 f"{plans[n]!r} vs predict_step "
                                 f"{pred.seconds!r} ({n})")
    if abs(monitor.predicted_step_s - plans["fitted"]) \
            > PREDICT_RTOL * plans["fitted"]:
        raise AssertionError(f"{p['path']} ({kname}): StragglerMonitor."
                             f"from_model {monitor.predicted_step_s!r} vs "
                             f"predict_plans {plans['fitted']!r}")
    pv = predictor.plan_property_vector(cfg, spec, plan, MESH1,
                                        kernels=kernels)
    unpriced = {k: {"count": v, "seed_s": v * seed_w[k]
                    if k in seed_w else None}
                for k, v in sorted(pv.items())
                if v and k not in fitted_keys}
    m = p["measured_s"]
    emit({"phase": "predict", "ok": True, "path": p["path"],
          "kernels": kname,
          "kernel_blocks": kernelmodel.step_kernel_blocks(cfg, spec, kernels),
          "n_layers": cfg.n_layers, "dtype": cfg.compute_dtype,
          "workload": dataclasses.asdict(spec),
          "remat": plan.remat_policy or cfg.remat_policy,
          "measured_s": m, "timed_by": p["timed_by"],
          "fitted": _seconds(preds["fitted"]),
          "seed": _seconds(preds["seed"]),
          "fitted_over_measured": preds["fitted"].seconds / m,
          "seed_over_measured": preds["seed"].seconds / m,
          "predict_plans_s": plans,
          "straggler_from_model_s": monitor.predicted_step_s,
          "unpriced": unpriced,
          "unpriced_seed_s": sum(u["seed_s"] or 0.0
                                 for u in unpriced.values()),
          "device_idle_share": p["device_idle_share"],
          "estimated_peak_bytes": predictor.estimate_peak_bytes(
              cfg, spec, plan, MESH1),
          "feasible_on_this_card": predictor.feasible(
              cfg, spec, plan, MESH1, budget=budget),
          "measured_peak_memory_bytes": p.get("peak_memory_bytes"),
          "first_predict_plans_s": build_s,
          "predict_step_s": step_s})
    return build_s


# ---------------------------------------------------------------------------
# the autotuner on the card: every candidate of each kernel's grid launched,
# held against the plain version and timed beside its predicted seconds

#: timed replays per candidate (the median is kept) and calls captured in
#: its CUDA graph; fewer for the slow ``paper16`` candidates
AUTOTUNE_TIMING = (10, 5)
AUTOTUNE_TIMING_SLOW = (3, 2)
#: the row also timed by back-to-back host calls (CUDA events around them),
#: to show what the host adds to a fast candidate
AUTOTUNE_HOST_TIMED = f"{SSM} ssd {PREFILL_TOKENS[0]}x{PREFILL_TOKENS[1]} " \
    "bfloat16"
#: a pick slower than this many times the fastest candidate fails the phase
#: (far above the noise of the medians; PERF.md names the picks above 1.10)
PICK_OVER_FASTEST_MAX = 1.25


def autotune_cases() -> list:
    """(label, kernel, make, call, plain, shape, tol) per case: the main
    paths' kernels at their shapes (PERF.md §6: attention of llama, zamba2,
    mixtral, qwen2-vl, musicgen; the SSD scan of zamba2, mamba2 and
    zamba2's training), the f32 attention (llama, musicgen) and SSD scan
    (zamba2, mamba2) of the f32 comparison steps, and the calibration's
    largest tiled matmul and transpose in f32 and bf16, each made when its
    case runs."""
    B, S = PREFILL_TOKENS
    TB, TS = TRAIN_TOKENS
    gen = torch.Generator(DEV).manual_seed(1)
    cases = []

    def attention(name, dtype):
        cfg = get_arch(name)
        w = cfg.sliding_window

        def make():
            q, k, v = fa_inputs(B, cfg.n_heads, cfg.n_kv_heads, S, S,
                                cfg.head_dim_, dtype, gen)
            return {"q": q, "k": k, "v": v}
        return (f"{name} attention {str(dtype)[6:]}", "flash_attention",
                make,
                lambda t, blocks: kops.flash_attention(
                    t["q"], t["k"], t["v"], causal=True, window=w,
                    block_sizes=blocks),
                lambda t, blocks: fa.attention_reference(
                    t["q"], t["k"], t["v"], causal=True, window=w),
                lambda t: kops.flash_attention_shape(t["q"], t["k"],
                                                     causal=True, window=w),
                (TOL[dtype], TOL[dtype]))

    def ssd_case(name, b, s_len, dtype=torch.bfloat16):
        cfg = get_arch(name)
        sc = cfg.ssm

        def make():
            x, dt, _, Bm, Cm = ssd_inputs(b, cfg.ssm_heads, sc.n_groups,
                                          s_len, sc.head_dim, sc.d_state,
                                          dtype, gen)
            A = -torch.linspace(1.0, 16.0, cfg.ssm_heads, device=DEV)
            return {"x": x, "dt": dt, "A": A, "B": Bm, "C": Cm}
        return (f"{name} ssd {b}x{s_len} {str(dtype)[6:]}", "ssd_scan", make,
                lambda t, blocks: kops.ssd_scan(
                    t["x"], t["dt"], t["A"], t["B"], t["C"],
                    block_sizes=blocks)[0],
                lambda t, blocks: ssd.ssd_scan_reference(
                    t["x"], t["dt"], t["A"], t["B"], t["C"],
                    chunk=blocks["chunk"])[0],
                lambda t: kops.ssd_scan_shape(t["x"], t["B"], t["C"]),
                (SSD_TOL[dtype], SSD_TOL[dtype]))

    def matmul_case(dtype):
        n = largest_tiled("mm")

        def make():
            return {"a": mkernels._rand(gen, (n, n), DEV).to(dtype),
                    "b": mkernels._rand(gen, (n, n), DEV).to(dtype)}
        return (f"matmul {n}^3 {str(dtype)[6:]}", "matmul", make,
                lambda t, blocks: kops.matmul(t["a"], t["b"],
                                              block_sizes=blocks),
                lambda t, blocks: mm.matmul_reference(t["a"], t["b"]),
                lambda t: kops.matmul_shape(t["a"], t["b"]), MM_TOL[dtype])

    def transpose_case(dtype):
        n = tr_ladder()[-1]

        def make():
            return {"x": torch.randn((n, n), device=DEV,
                                     generator=gen).to(dtype)}
        return (f"transpose {n}^2 {str(dtype)[6:]}", "transpose", make,
                lambda t, blocks: kops.transpose(t["x"], block_sizes=blocks),
                lambda t, blocks: tr.transpose_reference(t["x"]),
                lambda t: kops.transpose_shape(t["x"]), (0.0, 0.0))

    for name in (ARCH, HYBRID, MOE, VLM, AUDIO):
        cases.append(attention(name, torch.bfloat16))
    for name in (ARCH, AUDIO):
        cases.append(attention(name, torch.float32))
    for name, b, s_len in ((HYBRID, B, S), (SSM, B, S), (HYBRID, TB, TS)):
        cases.append(ssd_case(name, b, s_len))
    for name in (HYBRID, SSM):   # the f32 comparison steps': FP32 kernel
        cases.append(ssd_case(name, B, S, torch.float32))
    for dtype in (torch.float32, torch.bfloat16):
        cases.append(matmul_case(dtype))
        cases.append(transpose_case(dtype))
    return cases


def launched_tile(kernel: str, t: dict, shape: dict, blocks: dict) -> dict:
    """What the C query reports for the launch ``blocks`` makes, beside the
    Python mirrors the autotuner reads (its tile and footprint): raises
    where they differ."""
    km = kernelmodel.get(kernel)
    mirror = {"variant": km.variant(shape, blocks),
              "smem": km.footprint(shape, blocks)}
    if kernel == "matmul":
        c = mm.tile_for(t["a"], t["b"], blocks["block_m"], blocks["block_n"],
                        blocks["block_k"])
        got = {"variant": c.variant, "smem": c.smem,
               "tile": [c.bm, c.bn, c.bk]}
        mirror["tile"] = [blocks["block_m"], blocks["block_n"],
                          blocks["block_k"]]
        py = kernelmodel._mm_tile(shape, blocks)
        if py != c:
            raise AssertionError(f"matmul tile_rule {py} != matmul_tile {c}")
    elif kernel == "flash_attention":
        dh = shape["dh"]
        if shape["bits"] == 16:
            bq, bk, _, smem = fa.tile(dh)
            if fa.tile(dh) != fa.tile_rule(dh):
                raise AssertionError(f"tile_rule({dh}) {fa.tile_rule(dh)} != "
                                     f"flash_attention_tile {fa.tile(dh)}")
        else:
            bq, bk = fa.pick_tiles(blocks["block_q"], blocks["block_k"], dh)
            smem = fa.f32_tile(bq, bk, dh)
        got = {"variant": "wgmma" if shape["bits"] == 16 else "fma",
               "smem": smem, "tile": [bq, bk]}
        mirror["tile"] = [blocks["block_q"], blocks["block_k"]]
    elif kernel == "ssd_scan":
        c = ssd.tile_for(t["x"], t["B"], t["C"], blocks["chunk"])
        py = ssd.tile_rule(shape["P"], shape["N"],
                           min(blocks["chunk"], shape["L"]), c.variant)
        if py != c:
            raise AssertionError(f"ssd tile_rule {py} != ssd_scan_tile {c}")
        got = {"variant": c.variant, "smem": c.smem,
               "tile": [blocks["chunk"], c.p_block]}
        mirror["tile"] = [blocks["chunk"], blocks["p_block"]]
    else:
        c = tr.tile_for(t["x"], blocks["block"])
        py = tr.tile_rule(blocks["block"], t["x"].dtype, c.variant)
        if py != c:
            raise AssertionError(f"transpose tile_rule {py} != "
                                 f"transpose_tile {c}")
        got = {"variant": c.variant, "smem": c.smem, "tile": [c.edge]}
        mirror["tile"] = [blocks["block"]]
    if got != mirror:
        raise AssertionError(f"{kernel} at {blocks}: the autotuner's mirror "
                             f"{mirror} != the C query {got}")
    return got


#: mangled entry functions of each source, with their ``ptxas -v``
#: registers, read from the build phase's logs
_PTXAS: dict = {}


def ptxas_of(source: str) -> list:
    if source not in _PTXAS:
        path = _build.build_dir() / f"{source}.nvcc.log"
        _PTXAS[source] = ptxas_entries(path.read_text())
    return _PTXAS[source]


def instance_pattern(kernel: str, shape: dict, blocks: dict,
                     variant: str) -> str:
    """A regular expression for the mangled entry function of the kernel
    instance the launch of ``blocks`` runs (its template arguments)."""
    if kernel == "flash_attention":
        dh = shape["dh"]
        if variant == "wgmma":
            return rf"fa_wgmma_kernelILi{(dh + 15) // 16 * 16}E"
        return (rf"fa_fwd_kernelILi{blocks['block_q']}ELi{blocks['block_k']}"
                rf"ELi{fa.padded_head_dim(dh)}E")
    if kernel == "ssd_scan":
        n = shape["N"]
        if variant == "wgmma":
            rows = ssd.wgmma_rows(min(blocks["chunk"], shape["L"]))
            return (rf"ssd_wgmma_kernelILi{rows}"
                    rf"ELi{64 if n <= 64 else 128}E")
        return rf"ssd_fwd_kernelILi{ssd._padded_state(n)}ELi{blocks['p_block']}E"
    if kernel == "matmul":
        t = "13__nv_bfloat16" if shape["bits"] == 16 else "f"
        va, vb = (int(v) for v in kernelmodel._mm_layout(shape))
        if variant == "wgmma":
            return r"mm_wgmma_kernelILi2E"
        if variant == "paper16":
            return rf"mm16_kernelI{t}Lb{va}E"
        return rf"mm128_kernelI{t}Li{blocks['block_k']}ELi\d+ELb{va}ELb{vb}E"
    t = "t" if shape["bits"] == 16 else "j"
    if variant == "vec16":
        return rf"transpose_vec_kernelI{t}Li{128 // shape['bits']}E"
    return rf"transpose_kernelI{t}Li{blocks['block']}E"


def card_residency(kernel: str, shape: dict, blocks: dict, variant: str,
                   smem: float) -> dict:
    """The autotuner's residency mirror of one candidate held to the card:
    the registers its kernel module mirrors against this build's ``ptxas
    -v`` report, and ``blocks["resident"]`` against the CUDA occupancy
    calculator for that instance at the block's threads and dynamic shared
    memory.  Raises where they differ."""
    source = kernel
    if kernel == "flash_attention":
        threads, regs = fa.block_resources(shape["bits"], blocks["block_q"],
                                           blocks["block_k"], shape["dh"])
    elif kernel == "ssd_scan":
        threads, regs = ssd.block_resources(
            variant, min(blocks["chunk"], shape["L"]), shape["N"],
            blocks["p_block"])
    elif kernel == "matmul":
        va, vb = kernelmodel._mm_layout(shape)
        threads, regs = mm.block_resources(variant, bf16=shape["bits"] == 16,
                                           va=va, vb=vb)
    else:
        dtype = torch.bfloat16 if shape["bits"] == 16 else torch.float32
        threads = tr.tile_rule(blocks["block"], dtype, variant).threads
        regs = tr.REGISTERS[(variant, dtype)]
    pat = re.compile(instance_pattern(kernel, shape, blocks, variant))
    hits = [e for e in ptxas_of(source) if pat.search(e["function"])]
    if len(hits) != 1:
        raise AssertionError(f"{kernel} at {blocks}: {len(hits)} instances "
                             f"match {pat.pattern}")
    entry = hits[0]
    static = kernel == "transpose" or variant == "paper16"
    card = _build.blocks_per_sm(source, entry["function"], threads,
                                  0 if static else int(smem))
    mirror = kernelmodel.resident_blocks(threads, regs, smem)
    row = {"threads": threads, "registers": regs,
           "ptxas_registers": entry["registers"], "resident": mirror,
           "occupancy_resident": card}
    if regs != entry["registers"] or mirror != card \
            or blocks["resident"] != mirror:
        raise AssertionError(f"{kernel} at {blocks}: the residency mirror "
                             f"{row} differs from the card")
    return row


def spearman(a, b):
    """Spearman's rank correlation of two sequences (average ranks for
    ties); None below two points or where either is constant."""
    def ranks(x):
        x = np.asarray(x, dtype=np.float64)
        order = np.argsort(x, kind="stable")
        r = np.empty(len(x))
        r[order] = np.arange(len(x), dtype=np.float64)
        for v in np.unique(x):  # ties share their mean rank
            r[x == v] = r[x == v].mean()
        return r
    if len(a) < 2:
        return None
    ra, rb = ranks(a), ranks(b)
    if ra.std() == 0 or rb.std() == 0:
        return None
    return float(np.corrcoef(ra, rb)[0, 1])


def sweep_speedup() -> dict:
    """The compiled scorer against the interpreted one on the reference's
    64-point matmul grid (its ``tests/test_autotune.py`` timing test), best
    of 3 after a warm call: host time of the card's machine."""
    from repro_torch.kernels import autotune
    km = kernelmodel.PALLAS_KERNELS["matmul"]
    shape = {"M": 1024, "N": 512, "K": 2048, "bits": 16}
    cands = autotune.candidate_configs(km, shape)
    fast = autotune.score_configs(km, shape, cands)
    slow = autotune.score_configs_interpreted(km, shape, cands)
    if not np.allclose(fast, slow, rtol=1e-12, atol=0.0):
        raise AssertionError("compiled and interpreted scores differ")

    def best_of(fn, n=3):
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            out.append(time.perf_counter() - t0)
        return min(out)
    t_fast = best_of(lambda: autotune.score_configs(km, shape, cands))
    t_slow = best_of(lambda: autotune.score_configs_interpreted(
        km, shape, cands))
    return {"points": len(cands), "compiled_s": t_fast,
            "interpreted_s": t_slow, "speedup": t_slow / t_fast}


#: the FP32 SSD kernel (P 64, L 2048, f32) at chunks 32 and 64 over grids of
#: one block an SM (Bz 4 x H 32: 128 blocks), two (H 66: 264, one full wave)
#: and zamba2's 320 (a full wave and a tail), at the states of zamba2 (N 64)
#: and mamba2 (N 128): what a chunk step costs beside the seed's price
SSD_STEP_GRIDS = [(64, 32), (64, 66), (64, 80), (128, 32), (128, 66),
                   (128, 80)]


def ssd_chunk_steps() -> dict:
    """Device ms of the FP32 SSD kernel at chunks 32 and 64 over the grids
    of ``SSD_STEP_GRIDS``, beside the analytic seed's prediction, and the
    time a wait on device memory (``ssd_scan.fma_memory_waits_per_chunk``)
    costs a wave beyond a plain barrier: the measured difference of the two
    chunks less the seed's, over chunk 32's extra waits, plus what the
    seed prices those waits at beyond a plain barrier (beside it,
    ``priced_us_per_step``)."""
    from repro_torch.kernels import autotune
    seed = seeds.ANALYTIC_SEEDS[CALIB_DEVICE]()
    seed_w = dict(zip(seed.keys, (float(w) for w in seed.weights)))
    gen = torch.Generator(DEV).manual_seed(2)
    Bz, L, P = 4, 2048, 64
    out = []
    for N, H in SSD_STEP_GRIDS:
        x, dt, _, Bm, Cm = ssd_inputs(Bz, H, 1, L, P, N, torch.float32, gen)
        A = -torch.linspace(1.0, 16.0, H, device=DEV)
        shape = kops.ssd_scan_shape(x, Bm, Cm)
        cands = {c["chunk"]: c for c in
                 autotune.candidate_configs("ssd_scan", shape)}
        row = {"N": N, "H": H, "blocks": Bz * H}
        for chunk in (32, 64):
            blocks = cands[chunk]

            def call():
                return kops.ssd_scan(x, dt, A, Bm, Cm, block_sizes=blocks)
            call()
            row[f"ms_{chunk}"] = graph_median_ms(call, 5, 10)
            row[f"seed_ms_{chunk}"] = 1e3 * float(autotune.score_configs(
                "ssd_scan", shape, [blocks], seed)[0])
        waves = -(-Bz * H // (kernelmodel.SMS * min(
            cands[32]["resident"], -(-Bz * H // kernelmodel.SMS))))
        extra = waves * (ssd.fma_memory_waits_per_chunk(32) * L // 32
                         - ssd.fma_memory_waits_per_chunk(64) * L // 64)
        # the seed's price of the extra waits as the barriers they are
        # counted as beyond a plain one
        priced = (kernelmodel.MEMORY_WAIT_BARRIERS - 1) \
            * seed_w[props.BARRIER]
        row["waves"] = waves
        row["us_per_extra_step"] = 1e3 * (
            (row["ms_32"] - row["ms_64"])
            - (row["seed_ms_32"] - row["seed_ms_64"])) / extra \
            + 1e6 * priced
        row["priced_us_per_step"] = 1e6 * priced
        out.append(row)
        del x, dt, Bm, Cm
    line = {"phase": "autotune.ssd_chunk_steps", "ok": True, "rows": out,
            "memory_wait_barriers": kernelmodel.MEMORY_WAIT_BARRIERS}
    emit(line)
    return line


def phase_autotune(reg_dir=None):
    """Every candidate of every kernel's grid at the shapes of
    ``autotune_cases``: launched (its tile and shared memory as the C query
    reports them equal to the autotuner's mirrors), held against the plain
    version, timed on the device (``graph_median_ms``: the median of
    ``AUTOTUNE_TIMING`` replays of a CUDA graph of its calls), beside its
    predicted seconds under the analytic ``gpu-h100`` seed and, with
    ``reg_dir``, under the model fitted in this run, with the keys the fit
    leaves unpriced (their seconds under the seed).  Spearman's rank
    correlation of predicted and measured, the tile ``"auto"`` picks on the
    card (``ops.default_model``) and its time against the fastest.  Fails
    where a candidate disagrees with its plain version, a mirror with its C
    query or with the card (``card_residency``: registers against the
    build's ``ptxas``, blocks an SM holds against the CUDA occupancy calculator), the bf16 SSD
    pick on a main path is not a tensor-core chunk, or a pick is more than
    ``PICK_OVER_FASTEST_MAX`` times the fastest candidate."""
    from repro_torch.core.symcount import evaluate_vector
    from repro_torch.kernels import autotune
    seed = seeds.ANALYTIC_SEEDS[CALIB_DEVICE]()
    models = {"seed": seed}
    if reg_dir is not None:
        models["fitted"] = registry.load_model(CALIB_DEVICE, reg_dir)
    seed_w = dict(zip(seed.keys, (float(w) for w in seed.weights)))
    default = registry.resolve_model(kops.CARD_MODEL)
    rows = []
    for (label, kernel, make, call, plain, shape_of, tol) in autotune_cases():
        t = make()
        shape = shape_of(t)
        km = kernelmodel.get(kernel)
        cands = autotune.candidate_configs(kernel, shape)
        measured, launched, errs, resid, host_timed = [], [], [], [], []
        ref = None   # the plain version's result; the SSD's per chunk
        for blocks in cands:
            launched.append(launched_tile(kernel, t, shape, blocks))
            resid.append(card_residency(kernel, shape, blocks,
                                        launched[-1]["variant"],
                                        launched[-1]["smem"]))
            o = call(t, blocks)
            torch.cuda.synchronize()
            if ref is None or kernel == "ssd_scan":
                ref = None   # the last one freed before the next is made
                ref = plain(t, blocks)
            if tol == (0.0, 0.0):
                if not torch.equal(o, ref):
                    raise AssertionError(f"{label} at {blocks}: not exact")
                errs.append(0.0)
            else:
                errs.append(compare(o, ref, *tol))
            del o
            reps, calls = AUTOTUNE_TIMING_SLOW \
                if launched[-1]["variant"] == "paper16" else AUTOTUNE_TIMING
            measured.append(graph_median_ms(lambda: call(t, blocks), calls,
                                            reps))
            if label == AUTOTUNE_HOST_TIMED:
                host_timed.append(float(np.median(
                    [time_ms(lambda: call(t, blocks), 0, calls)
                     for _ in range(reps)])))
        preds = {n: [float(x) for x in
                     autotune.score_configs(kernel, shape, cands, m)]
                 for n, m in models.items()}
        unpriced = None
        if "fitted" in models:
            keys = set(models["fitted"].keys)
            unpriced = []
            for blocks in cands:
                pv = evaluate_vector(
                    km.vector(shape, blocks, km.variant(shape, blocks)), {})
                unpriced.append({k: v * seed_w.get(k, 0.0)
                                 for k, v in sorted(pv.items())
                                 if v and k not in keys})
        pick = autotune.best_block_sizes(kernel, shape, kops.CARD_MODEL)
        i_pick = cands.index(pick)
        i_fast = int(np.argmin(measured))
        if kernel == "ssd_scan" and shape["bits"] == 16 \
                and launched[i_pick]["variant"] != "wgmma":
            raise AssertionError(f"{label}: \"auto\" picks {pick}, served "
                                 f"by {launched[i_pick]['variant']}")
        if measured[i_pick] > PICK_OVER_FASTEST_MAX * measured[i_fast]:
            raise AssertionError(
                f"{label}: \"auto\" picks {pick} at {measured[i_pick]} ms, "
                f"{measured[i_pick] / measured[i_fast]:.3f}x the fastest "
                f"{cands[i_fast]} (limit {PICK_OVER_FASTEST_MAX})")
        row = {"label": label, "kernel": kernel, "shape": shape,
               "candidates": [{"blocks": c, **lt, "ms": ms,
                               "residency": rs, "max_abs_err": e,
                               **{f"{n}_s": p[i] for n, p in preds.items()},
                               **({"unpriced_seed_s": unpriced[i]}
                                  if unpriced is not None else {})}
                              for i, (c, lt, ms, rs, e) in enumerate(
                                  zip(cands, launched, measured, resid,
                                      errs))],
               "spearman": {n: spearman(p, measured)
                            for n, p in preds.items()},
               "pick": pick, "pick_model": default.meta.get("source"),
               "pick_ms": measured[i_pick],
               "picks_by_model": {n: cands[int(np.argmin(p))]
                                  for n, p in preds.items()},
               "fastest": cands[i_fast], "fastest_ms": measured[i_fast],
               "pick_over_fastest": measured[i_pick] / measured[i_fast],
               **({"host_timed_ms": host_timed,
                   "host_timed_pick_over_fastest":
                       host_timed[i_pick] / min(host_timed)}
                  if host_timed else {}),
               "timing": "median of CUDA-graph replays",
               "mirrors_equal_c_queries": True,
               "residency_equals_the_occupancy_query": True,
               "max_abs_err": max(errs), "tol": list(tol)}
        emit({"phase": "autotune", "ok": True, **row})
        rows.append(row)
        del t, ref
        torch.cuda.empty_cache()
    ssd_chunk_steps()
    speed = sweep_speedup()
    emit({"phase": "autotune.summary", "ok": True, "shapes": len(rows),
          "candidates": sum(len(r["candidates"]) for r in rows),
          "models": sorted(models), "pick_model": default.meta.get("source"),
          "picks_within_10pct_of_fastest": sum(
              r["pick_over_fastest"] <= 1.1 for r in rows),
          "worst_pick_over_fastest": max(r["pick_over_fastest"]
                                         for r in rows),
          "sweep_64_points": speed})
    return rows


# ---------------------------------------------------------------------------
# model-scored serving, the explanation of a prediction, the plan search

#: the admission phase: one llama3.2-3b server of 4 slots x 512 rows, 8
#: requests all at t = 0 in an order adversarial to FIFO (the reference's
#: tests/test_workload.py: long prompts first), 16 new tokens each (no
#: early stop: the 480 prompt tokens and 32 decode iterations fill the 512
#: rows exactly, whichever policy admits)
ADMISSION = dict(slots=4, max_len=512, prompts=[256, 128] + [16] * 6,
                 max_new=16)


def serve_timed(cfg, model, policy: str, seed: int, scorer=None) -> dict:
    """Serve ``ADMISSION``'s requests under ``policy`` with a tracer on:
    each request's latency (its completion on the host clock, all arriving
    at t = 0), the makespan, the admission order, and the spans' measured
    seconds beside the scorer's ``predicted_s`` (a FIFO server builds no
    scorer: ``scorer`` is given it for the spans, its picks stay FIFO)."""
    a = ADMISSION
    server = DecodeServer(cfg, model, slots=a["slots"], max_len=a["max_len"],
                          seed=seed, eos_id=-1, admission=policy, device=DEV)
    if server.scorer is None:
        server.scorer = scorer
    rng = np.random.default_rng(seed)
    for rid, plen in enumerate(a["prompts"]):
        prompt = rng.integers(2, cfg.vocab_size, size=plen).astype(np.int32)
        server.submit(Request(rid=rid, prompt=prompt, max_new=a["max_new"]))
    tracer = _obs_trace.Tracer()
    prev = _obs_trace.get_tracer()
    _obs_trace.set_tracer(tracer)
    latency, order = {}, []
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while server.queue or any(server.active):
            queued = {r.rid for r in server.queue}
            server._refill()
            order += [r.rid for r in server.active
                      if r is not None and r.rid in queued]
            before = [r for r in server.active if r]
            server.step()
            now = time.perf_counter() - t0
            latency.update({r.rid: now for r in before if r.done})
    finally:
        _obs_trace.set_tracer(prev)
    if sorted(latency) != list(range(len(a["prompts"]))):
        raise AssertionError(f"{policy}: {len(latency)} of "
                             f"{len(a['prompts'])} requests completed")
    if not bool(torch.isfinite(server.last_logits).all()):
        raise AssertionError(f"{policy}: decode logits are not finite")
    lat = np.asarray([latency[r] for r in sorted(latency)])
    spans = {n: [(sp.duration_s, sp.predicted_s, sp.args)
                 for sp in tracer.spans if sp.name == n]
             for n in ("prefill", "decode_step")}
    return {"policy": policy, "order": order,
            "mean_latency_s": float(lat.mean()),
            "max_latency_s": float(lat.max()), "makespan_s": float(lat.max()),
            "spans": spans, "decode_calls": int(server.state["pos"]),
            "scorer": server.scorer}


def phase_admission(seed: int) -> dict:
    """``DecodeServer`` under ``admission="fifo"`` and then ``"model"`` on
    ``ADMISSION``'s requests (llama3.2-3b, full width and depth, bf16),
    measured, beside ``simulate_serving``'s prediction of each under the
    model server's scorer (``gpu-h100``, as on every CUDA server), and the
    scorer's prefill and decode-iteration seconds beside the measured
    spans.  The server feeds a prompt through the decode step token by
    token (the reference's server); the simulation prices it as one
    prefill (the reference's replay).  Fails where a request does not
    complete, the logits are not finite, the measured model order is not
    the one the simulation predicts, or a prediction is not finite and
    above 0."""
    cfg = get_arch(ARCH)
    model = transformer.init_params(cfg, device=DEV, seed=seed)
    a = ADMISSION
    scorer = AdmissionScorer(cfg, slots=a["slots"], max_len=a["max_len"],
                             model=kops.CARD_MODEL)
    runs = {p: serve_timed(cfg, model, p, seed, scorer)
            for p in ("fifo", "model")}
    if runs["model"]["scorer"].model.device != scorer.model.device:
        raise AssertionError(f"the CUDA server scores through "
                             f"{runs['model']['scorer'].model.device}")
    sims = {p: simulate_serving(cfg, a["prompts"], a["max_new"],
                                slots=a["slots"], max_len=a["max_len"],
                                policy=p, scorer=scorer)
            for p in ("fifo", "model")}
    if runs["model"]["order"] != sims["model"]["order"]:
        raise AssertionError(f"model admission order {runs['model']['order']}"
                             f" != the simulation's {sims['model']['order']}")
    out = {"phase": "admission", "ok": True, "arch": cfg.name,
           "slots": a["slots"], "max_len": a["max_len"],
           "prompts": a["prompts"], "max_new": a["max_new"],
           "cost_model": scorer.model.device,
           "cost_model_source": scorer.model.meta.get("source")}
    for p in ("fifo", "model"):
        r, sim = runs[p], sims[p]
        pre = r["spans"]["prefill"]
        dec = r["spans"]["decode_step"]
        for dur, pred, _ in pre + dec:
            if not (pred is not None and math.isfinite(pred) and pred > 0):
                raise AssertionError(f"{p}: a span predicts {pred!r} s")
        out[p] = {
            "measured": {k: r[k] for k in ("order", "mean_latency_s",
                                           "max_latency_s", "makespan_s",
                                           "decode_calls")},
            "simulated": {k: sim[k] for k in ("order", "mean_latency_s",
                                              "max_latency_s",
                                              "makespan_s")},
            "prefill_spans": [{"plen": args["plen"], "measured_s": dur,
                               "predicted_s": pred}
                              for dur, pred, args in pre],
            "decode_iteration_median_s": float(np.median(
                [d for d, _, _ in dec])),
            "decode_iteration_predicted_median_s": float(np.median(
                [q for _, q, _ in dec])),
            "decode_iterations": len(dec)}
    out["model_over_fifo_mean_latency"] = {
        "measured": runs["model"]["mean_latency_s"]
        / runs["fifo"]["mean_latency_s"],
        "simulated": sims["model"]["mean_latency_s"]
        / sims["fifo"]["mean_latency_s"]}
    emit(out)
    return out


#: score_explain's rows must sum to the fused score to this
EXPLAIN_RTOL = 1e-9


def phase_explain(reg_dir: str) -> dict:
    """``score_explain`` of llama3.2-3b's bf16 prefill step (the main
    path's 4 x 2048 on one card) under the ``gpu-h100`` model fitted in
    this run, on the card's kernels: the total, the terms by group and
    source, the top terms.  Fails unless the rows sum to the fused
    ``PlanSpace.scores`` cell within ``EXPLAIN_RTOL``."""
    cfg = get_arch(ARCH)
    B, S = PREFILL_TOKENS
    spec = WorkloadSpec(phase="prefill", global_batch=B, seq_len=S)
    fitted = registry.load_model(CALIB_DEVICE, reg_dir)
    exp = score_explain(cfg, spec, TRAINER_PLAN, MESH1, model=fitted)
    fused = float(planspace.PlanSpace.from_product(
        cfg, spec, [TRAINER_PLAN], [MESH1]).scores(fitted)[0])
    rows_sum = sum(r.seconds for r in exp.rows)
    for name, v in (("rows", rows_sum), ("total", exp.total_seconds)):
        if not abs(v - fused) <= EXPLAIN_RTOL * abs(fused):
            raise AssertionError(f"score_explain {name} {v!r} != the fused "
                                 f"score {fused!r}")
    out = {"phase": "explain", "ok": True, "path": f"{cfg.name}:prefill",
           "model": fitted.device, "source": fitted.meta.get("source"),
           "kernel_blocks": kernelmodel.step_kernel_blocks(cfg, spec),
           "total_s": exp.total_seconds, "fused_s": fused,
           "rows_sum_s": rows_sum,
           "rows_sum_rel_err": abs(rows_sum - fused) / abs(fused),
           "by_group_s": exp.by_group(), "by_source_s": exp.by_source(),
           "top_terms": [{"term": r.term, "seconds": r.seconds,
                          "share": r.share, "group": r.group,
                          "source": r.source,
                          "properties": list(r.properties)}
                         for r in exp.top(8)]}
    emit(out)
    return out


def phase_autoshard() -> dict:
    """One plan search on the host (``launch/autoshard.search``): glm4-9b
    train_4k over every factorization of 256 devices under ``gpu-h100``
    (the registry's: its datasheet seed here), the top 3 with their
    co-tuned kernel tiles."""
    t0 = time.perf_counter()
    ranked = autoshard.search("glm4-9b", "train_4k", model=kops.CARD_MODEL,
                              top_k=3, n_devices=256, tune_kernels=True)
    wall = time.perf_counter() - t0
    if not ranked or not all(math.isfinite(s) and s > 0
                             for s, *_ in ranked):
        raise AssertionError(f"autoshard ranked {ranked!r}")
    out = {"phase": "autoshard", "ok": True, "arch": "glm4-9b",
           "shape": "train_4k", "devices": 256, "model": kops.CARD_MODEL,
           "search_s": wall,
           "top": [{"predicted_s": s, "mesh": m,
                    "plan": {k: v for k, v in dataclasses.asdict(p).items()
                             if v not in (None, ())},
                    "kernel_blocks": blocks}
                   for s, p, m, blocks in ranked]}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# the planner's engine benchmarks and the examples

#: the engine benchmarks, each ``python -m repro_torch.benchmarks.<name>`` at
#: its defaults (10k cells, a 1M-cell stream; ``gpu-h100`` on the card's
#: kernels) in a process of its own, so that its host seconds and peak RSS
#: are its own, not those of a process holding full-width models
ENGINES = ("search_bench", "fused_bench", "fleet_bench")
ENGINE_TIMEOUT = 600
#: the reference's bars: (record, key path, bar, "min" | "max"); a missed
#: bar is reported (the script prints the reference's WARNING), not fatal
ENGINE_BARS = {
    "search_over_loop": ("search_bench", ("speedup",), 20.0, "min"),
    "fused_over_columns": ("fused_bench", ("speedup",), 5.0, "min"),
    "fused_over_loop": ("fused_bench", ("loop_speedup",), 100.0, "min"),
    "obs_overhead": ("fused_bench", ("obs", "overhead"), 1.02, "max"),
    "fleet_over_single": ("fleet_bench", ("warm_over_single_ratio",), 10.0,
                          "max"),
    "cache_reuse": ("fleet_bench", ("cache_reuse",), 0.5, "min"),
}
#: train_smollm's runs: the ~100M config until its loss falls, then resumed
#: from its directory for as many steps again; the whole smollm-360m
EXAMPLE_TOKENS = ["--batch", "4", "--seq", "256"]
EXAMPLE_STEPS = 60
EXAMPLE_FULL_STEPS = 100
#: ``measure.time_kernel``'s calls of a case in the quickstart: the warm-up,
#: the inner-repeat probe and 10 runs
QUICKSTART_CALLS = 12


def run_module(module: str, args: list, cwd: str, timeout: float):
    """``python -m module *args`` from ``cwd``; a non-zero exit fails."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", module, *args], env=env,
                       cwd=cwd, capture_output=True, text=True,
                       timeout=timeout)
    if p.returncode != 0:
        raise AssertionError(f"{module} exited {p.returncode}:\n"
                             f"{p.stdout[-4000:]}\n{p.stderr[-4000:]}")
    return p.stdout, time.perf_counter() - t0


def phase_engines() -> dict:
    """The three engine benchmarks, then the dispatcher's ``--only
    search_bench``, each in a process of its own writing into a temporary
    directory; their records read back, each ratio beside its bar."""
    recs, seconds, warnings = {}, {}, []
    with tempfile.TemporaryDirectory(prefix="engines-") as d:
        for name in ENGINES:
            out = os.path.join(d, f"{name}.json")
            text, seconds[name] = run_module(
                f"repro_torch.benchmarks.{name}", ["--out", out], d,
                ENGINE_TIMEOUT)
            warnings += [l for l in text.splitlines()
                         if l.startswith("WARNING")]
            with open(out) as f:
                recs[name] = json.load(f)
        _, seconds["run"] = run_module(
            "repro_torch.benchmarks.run", ["--only", "search_bench"], d,
            ENGINE_TIMEOUT)
        with open(os.path.join(d, "BENCH_torch_search.json")) as f:
            via_run = json.load(f)
    search, fused, fleet = (recs[n] for n in ENGINES)
    if search["cells"] < 10000 or fused["stream"]["cells"] < 1_000_000 \
            or {search["model"], fused["model"], via_run["model"]} \
            != {kops.CARD_MODEL}:
        raise AssertionError(f"engines: {search} {fused} {via_run}")
    bars = {}
    for key, (name, path, bar, kind) in ENGINE_BARS.items():
        v = recs[name]
        for k in path:
            v = v[k]
        bars[key] = {"value": v, "bar": bar, "kind": kind,
                     "met": v >= bar if kind == "min" else v <= bar}
    line = {"phase": "engines", "ok": True, "model": search["model"],
            "bars": bars, "bars_met": all(b["met"] for b in bars.values()),
            "warnings": warnings, "process_seconds": seconds,
            "search": {k: search[k] for k in (
                "cells", "loop_s", "batched_s", "us_per_cell", "speedup")},
            "fused": {k: fused[k] for k in (
                "cells", "fused_s", "columns_s", "loop_s", "speedup",
                "loop_speedup", "hbm_budget")},
            "obs": fused["obs"], "stream": fused["stream"],
            "fleet": {k: fleet[k] for k in (
                "cold_allocate_s", "warm_replan_s", "single_warm_replan_s",
                "warm_over_single_ratio", "cache_reuse")},
            "run_search_bench": {k: via_run[k] for k in (
                "cells", "speedup")}}
    emit(line)
    return line


def example_launches(**counts) -> dict:
    return {"flash_attention": 0, "ssd_scan": 0, "matmul": 0,
            "transpose": 0, "ssd_scan_backward": 0, **counts}


def run_example(name: str, fn, argv: list, expect) -> tuple:
    """One example's ``main(argv)`` on the card, its printout captured, the
    launch counts set to 0 just before it and read just after; ``expect``
    maps its result to the launches it must have made."""
    buf = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            res = fn(argv)
    except BaseException:
        print(buf.getvalue()[-6000:], file=sys.stderr, flush=True)
        raise
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = read_launches()
    want = expect(res)
    if launched != want:
        raise AssertionError(f"{name}: launches {launched}, expected {want}")
    return res, buf.getvalue(), {"seconds": seconds, "launches": launched}


def phase_examples() -> dict:
    """Every example of ``repro_torch.examples`` through its ``main`` on the
    card, each with its own assertions and the launches it must make."""
    from repro_torch.examples import (autoshard_search, fault_tolerance,
                                      fleet_churn, kernel_autotune,
                                      quickstart, serve_decode, train_smollm)
    runs, total = {}, example_launches()
    tiny = [c.name for c in mkernels.measurement_cases("tiny", device="cpu")]
    qs_mm = sum(n.startswith("mm_tiled_") for n in tiny)
    qs_tr = sum(n.startswith("transpose_tiled_") for n in tiny)
    hundred, full = (train_smollm.hundred_m_config(),
                     get_arch("smollm-360m"))

    def attention(cfg, steps):
        per = 1 if cfg.remat_policy == "none" else 2
        return example_launches(flash_attention=per * cfg.n_layers * steps)

    with tempfile.TemporaryDirectory(prefix="examples-") as d:
        plans = [
            ("quickstart", quickstart.main, [],
             lambda r: example_launches(matmul=QUICKSTART_CALLS * qs_mm,
                                        transpose=QUICKSTART_CALLS * qs_tr)),
            ("kernel_autotune", kernel_autotune.main, [],
             lambda r: example_launches(matmul=1)),
            ("serve_decode", serve_decode.main, [],
             lambda r: example_launches()),
            ("train_smollm", train_smollm.main,
             EXAMPLE_TOKENS + ["--steps", str(EXAMPLE_STEPS),
                               "--ckpt", os.path.join(d, "smollm")],
             lambda r: attention(hundred, EXAMPLE_STEPS)),
            ("train_smollm.resume", train_smollm.main,
             EXAMPLE_TOKENS + ["--steps", str(2 * EXAMPLE_STEPS), "--resume",
                               "--ckpt", os.path.join(d, "smollm")],
             lambda r: attention(hundred, EXAMPLE_STEPS)),
            ("train_smollm.full", train_smollm.main,
             EXAMPLE_TOKENS + ["--full", "--steps", str(EXAMPLE_FULL_STEPS),
                               "--ckpt", os.path.join(d, "smollm-full")],
             lambda r: attention(full, EXAMPLE_FULL_STEPS)),
            ("fault_tolerance", fault_tolerance.main,
             ["--ckpt", os.path.join(d, "ft"),
              "--chaos-ckpt", os.path.join(d, "ft-chaos")],
             lambda r: attention(fault_tolerance.tiny_cfg(), r["steps_run"])),
            ("fleet_churn", fleet_churn.main, [],
             lambda r: example_launches()),
            ("autoshard_search", autoshard_search.main, [],
             lambda r: example_launches()),
        ]
        for name, fn, argv, expect in plans:
            torch.cuda.empty_cache()
            res, text, run = run_example(name, fn, argv, expect)
            for k, n in run["launches"].items():
                total[k] += n
            runs[name] = {**run, **example_figures(name, res, text)}
    emit({"phase": "examples", "ok": True, "launches": total,
          "examples": runs})
    return total


#: the port's documents; their fenced blocks follow one convention, read by
#: ``doc_blocks``: a ``bash`` block whose first line is ``# card``, ``# CPU``
#: or ``# card, CPU`` is a command in that form, run as written; the
#: commands of a form under one heading are a chain, run in order in one
#: directory of their own; the ``text`` block right after a ``bash`` or
#: ``python`` block is what it prints (for a command, lines it must print,
#: ``…`` standing for any text within a line)
DOCS_DIR = os.path.join(ROOT, "docs", "torch")
DOC_TIMEOUT = 600
_FENCE = re.compile(r"^```(\S*)\s*$")


def doc_blocks(path: str) -> list:
    """The fenced blocks of a document in order: ``lang``, ``code``, ``line``
    (1-based, the opening fence), ``section`` (the heading above it),
    ``tags`` (a ``bash`` block's forms) and ``expect`` (the ``text`` block
    right after it, or None)."""
    blocks, cur, gap, section = [], None, 0, ""
    with open(path) as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines, 1):
        m = _FENCE.match(line)
        if cur is None:
            if m:
                cur = {"lang": m.group(1), "line": i, "body": [],
                       "after_gap": gap, "section": section}
            elif line.strip():
                gap += 1
                if re.match(r"#{1,6} ", line):
                    section = line.lstrip("#").strip()
            continue
        if m and not m.group(1):
            code = "\n".join(cur.pop("body"))
            head = code.splitlines()[0] if code else ""
            tags = set()
            if cur["lang"] == "bash" and head.startswith("#"):
                tags = {w.strip() for w in head[1:].split(",")} \
                    & {"card", "CPU"}
            blocks.append({**cur, "code": code, "tags": tags,
                           "expect": None})
            cur, gap = None, 0
        else:
            cur["body"].append(line)
    for prev, b in zip(blocks, blocks[1:]):
        if b["lang"] == "text" and b["after_gap"] == 0 \
                and prev["lang"] in ("bash", "python"):
            prev["expect"] = b["code"]
    return [b for b in blocks if b["lang"] != "text"]


def unmet_lines(text: str, expect) -> list:
    """The promised lines that no line of ``text`` matches: each promised
    line's pieces between ``…`` must appear in order within one line."""
    lines = text.splitlines()

    def found(pattern: str) -> bool:
        pieces = [p.strip() for p in pattern.split("…") if p.strip()]
        for line in lines:
            at = 0
            for p in pieces:
                at = line.find(p, at)
                if at < 0:
                    break
                at += len(p)
            else:
                return True
        return False

    return [p for p in (expect or "").splitlines()
            if p.strip() and not found(p)]


def doc_env(workdir: str) -> dict:
    """The environment a document's commands run in: the checkout's ``src``
    on the path, ``python`` this interpreter, the default registry
    (``experiments/registry`` under ``workdir``) and a compile cache of the
    directory's own."""
    shim = os.path.join(workdir, ".bin")
    os.makedirs(shim, exist_ok=True)
    exe = os.path.join(shim, "python")
    if not os.path.exists(exe):
        with open(exe, "w") as f:
            f.write(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
        os.chmod(exe, 0o755)
    env = {k: v for k, v in os.environ.items()
           if k not in ("REPRO_MODEL_REGISTRY", "PYTHONPATH")}
    env.update(PYTHONPATH=os.path.join(ROOT, "src"),
               PATH=shim + os.pathsep + env.get("PATH", ""),
               REPRO_COMPILE_CACHE=os.path.join(workdir, ".exprops"))
    return env


def doc_chains(path: str, form: str) -> list:
    """The command blocks of ``path`` in ``form`` ("card" or "CPU"), one
    list a heading, in order."""
    chains = {}
    for b in doc_blocks(path):
        if form in b["tags"]:
            chains.setdefault(b["section"], []).append(b)
    return list(chains.values())


def run_doc_chain(path: str, blocks: list, workdir: str,
                  timeout: float = DOC_TIMEOUT) -> list:
    """The commands of one chain in order in ``workdir``: one row each with
    its exit code, output, seconds, the promised lines it missed, and, for a
    ``corrupt_registry`` run that names no ``--model``, whether the
    registry's ``gpu-h100`` file kept its bytes."""
    env = doc_env(workdir)
    reg = os.path.join(workdir, "experiments", "registry", "gpu-h100.json")
    rows = []
    for b in blocks:
        guard = "corrupt_registry" in b["code"] and "--model" not in b["code"]
        before = None
        if guard and os.path.exists(reg):
            with open(reg, "rb") as f:
                before = f.read()
        t0 = time.perf_counter()
        p = subprocess.run(["bash", "-c", "set -e\n" + b["code"]], cwd=workdir,
                           env=env, capture_output=True, text=True,
                           timeout=timeout)
        row = {"doc": os.path.basename(path), "line": b["line"],
               "rc": p.returncode,
               "seconds": round(time.perf_counter() - t0, 3),
               "out": p.stdout + p.stderr,
               "missing": unmet_lines(p.stdout + p.stderr, b["expect"])}
        if guard:
            after = None
            if os.path.exists(reg):
                with open(reg, "rb") as f:
                    after = f.read()
            row["registry_kept"] = before is not None and after == before
        rows.append(row)
    return rows


def run_doc_forms(path: str, form: str, workdir: str,
                  timeout: float = DOC_TIMEOUT) -> list:
    """Every chain of ``path`` in ``form``, one after another, each in a
    directory of its own under ``workdir``."""
    rows = []
    for i, blocks in enumerate(doc_chains(path, form)):
        d = os.path.join(workdir, f"chain{i}")
        os.makedirs(d)
        rows += run_doc_chain(path, blocks, d, timeout)
    return rows


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs
               if not os.path.islink(os.path.join(r, f)))


def card_chain(chain: tuple) -> tuple:
    """One chain's card forms in a temporary directory of its own; also the
    bytes its commands left there."""
    path, blocks = chain
    with tempfile.TemporaryDirectory(prefix="docs-") as d:
        rows = run_doc_chain(path, blocks, d)
        return rows, dir_bytes(d)


def docs_line() -> dict:
    """Every card form of every command of ``docs/torch/*.md`` on the card:
    each chain's commands in order in a temporary directory of its own (its
    own registry, checkpoints and compile cache), every chain side by side.
    Each command exits 0 and prints the lines its document promises,
    and the ``corrupt_registry`` run without ``--model`` leaves the
    registry's ``gpu-h100`` file byte for byte.  Returns the phase's line
    (the caller emits it: it may run beside another phase)."""
    t0 = time.perf_counter()
    chains = [(p, blocks)
              for p in sorted(glob.glob(os.path.join(DOCS_DIR, "*.md")))
              for blocks in doc_chains(p, "card")]
    with concurrent.futures.ThreadPoolExecutor(len(chains)) as pool:
        done = list(pool.map(card_chain, chains))
    rows = [r for chain_rows, _ in done for r in chain_rows]
    bad = [r for r in rows if r["rc"] != 0 or r["missing"]
           or r.get("registry_kept") is False]
    if bad:
        r = bad[0]
        raise AssertionError(
            f"{r['doc']}:{r['line']} exited {r['rc']}, missed "
            f"{r['missing']}, registry kept {r.get('registry_kept')}:\n"
            f"{r['out'][-6000:]}")
    kept = [r["registry_kept"] for r in rows if "registry_kept" in r]
    if len(rows) < 5 or kept != [True]:
        raise AssertionError(f"docs: {len(rows)} card commands, "
                             f"registry kept {kept}")
    return {"phase": "docs", "ok": True, "commands": [
        {k: r[k] for k in ("doc", "line", "seconds")} for r in rows],
        "registry_kept": kept[0], "seconds": round(time.perf_counter() - t0, 3),
        "bytes_left": [{"doc": os.path.basename(p), "line": blocks[0]["line"],
                        "bytes": b}
                       for (p, blocks), (_, b) in zip(chains, done)]}


def phase_docs() -> dict:
    line = docs_line()
    emit(line)
    return line


def example_figures(name: str, res: dict, text: str) -> dict:
    """The figures of one example's result that the examples line keeps,
    and the checks the example's own assertions leave to its caller."""
    if name == "quickstart":
        if not (math.isfinite(res["predicted_s"]) and res["predicted_s"] > 0
                and len(res["breakdown"]) == 5):
            raise AssertionError(f"quickstart: {res}")
        return {k: res[k] for k in ("cases", "fit_geomean_rel_err",
                                    "predicted_s", "actual_s", "rel_err")}
    if name == "kernel_autotune":
        return {"winners": {s["kernel"]: {m: w["blocks"]
                                          for m, w in s["winners"].items()}
                            for s in res["sweeps"]},
                "compiled_over_interpreted": {s["kernel"]: s["speedup"]
                                              for s in res["sweeps"]},
                "auto": res["auto"]}
    if name == "serve_decode":
        admits = [l for l in text.splitlines() if l.startswith("[admit]")]
        if res["requests"] != 10 or len(admits) != 10 or \
                not all("policy=model" in l for l in admits):
            raise AssertionError(f"serve_decode: {res['requests']} requests, "
                                 f"{len(admits)} [admit] lines")
        return {k: res[k] for k in ("requests", "tokens", "tok_per_s",
                                    "predicted_s", "predicted_half_s",
                                    "simulated_mean_latency_s", "order")}
    if name.startswith("train_smollm"):
        if name == "train_smollm.resume" and res["start"] != EXAMPLE_STEPS:
            raise AssertionError(f"resumed at {res['start']}")
        return {k: res[k] for k in ("arch", "params", "start", "end",
                                    "first_loss", "last_loss")} | {
            "median_step_s": float(np.median(res["step_s"][1:]))}
    if name == "fault_tolerance":
        return {k: res[k] for k in ("replay_max_rel_diff", "survivors",
                                    "recoveries", "mttr_s", "steps_run")}
    if name == "fleet_churn":
        return {"actions": res["actions"], "events": res["events"]}
    return {"elastic": res["elastic"],
            "balance": [(b["arch"], b["pool"], b["finish_s"])
                        for b in res["balance"]],
            "top": {k: v[0] for k, v in res["search"].items()}}


def rel_frobenius(a, b) -> float:
    num = den = 0.0
    for i in range(a.shape[0]):  # row by row: the f32 copies stay small
        x, y = a[i].float(), b[i].float()
        num += float(((x - y) ** 2).sum())
        den += float((y ** 2).sum())
    return math.sqrt(num / den)


def main_batch(cfg, B: int, S: int, seed: int) -> dict:
    """A main path's prefill batch on the card, from ``seed``: tokens (B, S),
    (B, S, codebooks) for the audio family; for the vision-language family
    vision embeddings over the first ``vision_tokens`` positions (seeded
    N(0, INIT_SCALE²), the token embeddings' scale) and a loss mask that
    leaves them out, as ``tests/test_smoke_archs.py`` builds them."""
    rng = np.random.default_rng(seed)
    shape = (B, S, cfg.n_input_codebooks) if cfg.n_input_codebooks > 1 \
        else (B, S)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, shape)).to(DEV)}
    if cfg.vision_tokens:
        ve = 0.02 * rng.standard_normal((B, cfg.vision_tokens, cfg.d_model),
                                        dtype=np.float32)
        batch["vision_embeds"] = torch.from_numpy(ve).to(
            device=DEV, dtype=getattr(torch, cfg.compute_dtype))
        mask = torch.ones((B, S), device=DEV)
        mask[:, :cfg.vision_tokens] = 0.0
        batch["loss_mask"] = mask
    return batch


def logits_shape(cfg, B: int, S: int) -> tuple:
    return (B, S, cfg.n_output_heads, cfg.vocab_size) \
        if cfg.n_output_heads > 1 else (B, S, cfg.vocab_size)


@contextlib.contextmanager
def recorded_routing(log: list):
    """Appends every MoE layer's routing — (experts, kept, slots) of each
    pick, (G, t, K) — to ``log`` while the block runs (the routing
    recomputed from the layer's own input and router; plain tensor code, no
    kernel)."""
    orig = moe.moe_apply

    def recording(p, x, cfg):
        r = moe.routing(p, x, cfg)
        log.append((r.experts, r.keep, r.slots))
        return orig(p, x, cfg)

    moe.moe_apply = recording
    try:
        yield log
    finally:
        moe.moe_apply = orig


@contextlib.contextmanager
def replayed_routing(log: list):
    """The MoE layers take their discrete decisions — each pick's expert,
    buffer slot and kept-or-dropped — from ``log`` (one entry a layer, in
    order, as ``recorded_routing`` writes it), and compute everything
    continuous (the router's probabilities, the gates, the experts'
    products) from their own input."""
    orig = moe.route
    entries = iter(log)

    def replay(router, xg, top_k, C):
        experts, keep, slots = next(entries)
        probs = torch.softmax(xg.float() @ router.float(), dim=-1)
        gates = torch.gather(probs, -1, experts) * keep
        return moe.Routing(probs, experts, gates, slots, keep)

    moe.route = replay
    try:
        yield
    finally:
        moe.route = orig


def routing_flips(a: list, b: list, B: int, S: int):
    """Two runs' routings, layer by layer -> (per layer: the share of picks
    whose expert differs, the share of picks whose kept assignment differs —
    kept in one run only, or kept in both to other experts — and each run's
    share of dropped picks; (B, S) bool: the tokens whose routing, expert
    and kept-or-dropped of every pick, agrees in every layer)."""
    rows = []
    agree = torch.ones(B * S, dtype=torch.bool, device=DEV)
    for (ea, ka, _), (eb, kb, _) in zip(a, b):
        kept = (ka != kb) | (ka & kb & (ea != eb))
        rows.append({"picks_differ": float((ea != eb).float().mean()),
                     "kept_differ": float(kept.float().mean()),
                     "dropped": [float((~ka).float().mean()),
                                 float((~kb).float().mean())]})
        agree &= ((ea == eb) & (ka == kb)).all(-1).reshape(-1)
    return rows, agree.reshape(B, S)


def masked_rel_frobenius(a, b, tokens) -> float:
    """``rel_frobenius`` over the tokens (B, S) marked True."""
    m = tokens.reshape(tokens.shape + (1,) * (a.ndim - 2))
    return rel_frobenius(torch.where(m, a, 0), torch.where(m, b, 0))


def prefill_step(cfg, B: int, S: int):
    """The prefill step of ``cfg`` for tokens (B, S), built as a user builds
    it: ``steps.make_step`` from the workload."""
    return steps.make_step(cfg, WorkloadSpec(phase="prefill", global_batch=B,
                                             seq_len=S))


def serve_step(cfg, slots: int, max_len: int, **kw):
    """The decode step of ``cfg`` for ``slots`` rows of ``max_len``-row
    caches, through ``steps.make_step``; ``kw`` goes to
    ``make_serve_step``."""
    return steps.make_step(cfg, WorkloadSpec(phase="decode",
                                             global_batch=slots,
                                             seq_len=max_len), **kw)


def phase_init(cfg, seed, B, S):
    t0 = time.perf_counter()
    model = transformer.init_params(cfg, device=DEV, seed=seed)
    n_params = transformer.param_count(model)
    if n_params != cfg.n_params():
        raise AssertionError(f"{n_params} parameters, config says "
                             f"{cfg.n_params()}")
    # warm-up at the counted steps' shape (library handles, GEMM choices,
    # allocator); not part of the counted run
    prefill_step(cfg, B, S)(model, main_batch(cfg, B, S, seed + 7))
    torch.cuda.synchronize()
    emit({"phase": "init", "ok": True, "arch": cfg.name,
          "family": cfg.family, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "dtype": cfg.param_dtype,
          "n_params": n_params,
          "seconds": round(time.perf_counter() - t0, 2)})
    return model


def phase_prefill(cfg, model, B, S, seed, n_steps):
    """The counted prefill steps of the main path; returns the batch, the
    logits and the step times."""
    batch = main_batch(cfg, B, S, seed)
    step = prefill_step(cfg, B, S)
    times = []
    logits = None
    for _ in range(n_steps):
        del logits
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = step(model, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    if tuple(logits.shape) != logits_shape(cfg, B, S):
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("prefill logits are not finite")
    return batch, logits, times


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
    occupied = []
    t0 = time.perf_counter()
    while server.queue or any(server.active):
        server._refill()
        before = [r for r in server.active if r]
        occupied.append(len(before))
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
    # the workload as the server had it: its slots and cache rows, the mean
    # occupancy, and the context its decode read each iteration (the whole
    # cache: decode attends every row, masked)
    rows = min(max_len, cfg.sliding_window) if cfg.sliding_window \
        else max_len
    active = int(round(float(np.mean(occupied))))
    record_path(cfg, "decode", WorkloadSpec(
        phase="decode", global_batch=slots, seq_len=max_len,
        active_slots=active,
        cache_tokens=None if cfg.family == "ssm" else float(slots * rows)),
        float(np.median(iters)) * 1e-3,
        f"median of {len(iters)} decode iterations (DecodeServer.step)",
        peak_memory_bytes=torch.cuda.max_memory_allocated())
    emit({"phase": "serve", "ok": True, "arch": cfg.name, "slots": slots,
          "max_len": max_len, "requests": n_req, "max_new": max_new,
          "prompt_tokens": int(sum(len(r.prompt) for r in done)),
          "new_tokens": toks, "decode_iterations": len(iters),
          "decode_calls_total": int(server.state["pos"]),
          "ms_per_iteration_median": float(np.median(iters)),
          "active_slots_mean": float(np.mean(occupied)),
          "ms_per_iteration_mean": float(np.mean(iters)),
          "wall_seconds": wall, "tokens_per_s": toks / wall,
          "tokens_per_s_decode_only": toks / (sum(iters) * 1e-3),
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})


def moe_routing_report(step, model, batch, logits, plain_logits):
    """For the MoE family: both paths once more with their routing
    recorded, the share of picks that route otherwise layer by layer, the
    tokens whose routing agrees in every layer and the logits' distance on
    them; then the plain path with the kernel path's routing replayed (its
    picks, slots and drops; its gates from its own probabilities) and its
    distance to the kernel path over every token.  -> (report, that
    distance)."""
    kern_r, plain_r = [], []
    with recorded_routing(kern_r):
        again = step(model, batch)
    rerun_equal = bool(torch.equal(again, logits))
    del again
    with recorded_routing(plain_r), flags.use_kernels(False):
        step(model, batch)
    with replayed_routing(kern_r), flags.use_kernels(False):
        replayed = step(model, batch)
    B, S = batch["tokens"].shape[:2]
    per_layer, agree = routing_flips(kern_r, plain_r, B, S)
    rel_replayed = rel_frobenius(logits, replayed)
    del replayed
    return {"per_layer": per_layer,
            "picks_differ_mean": float(np.mean(
                [r["picks_differ"] for r in per_layer])),
            "kept_differ_mean": float(np.mean(
                [r["kept_differ"] for r in per_layer])),
            "tokens_agreeing_in_every_layer": float(agree.float().mean()),
            "rel_frobenius_on_agreeing_tokens":
                masked_rel_frobenius(logits, plain_logits, agree),
            "rel_frobenius_routing_replayed": rel_replayed,
            "rerun_bit_equal": rerun_equal}, rel_replayed


def phase_prefill_compare(cfg, model, batch, logits, times, launched,
                          n_steps):
    """The counted run's logits against the plain path's (bf16), over
    every token.  For the MoE family routing is discontinuous: a token
    whose top-2 flips, or that a flip before it pushes past an expert's
    capacity, moves by O(1), and through attention every later token of its
    sequence moves too; with random weights the flips cascade with depth.
    So the bar is held on the plain path with the kernel path's routing
    replayed, and the free-running comparison and the share of picks that
    route otherwise are reported beside it (``moe_routing_report``)."""
    B, S = batch["tokens"].shape[:2]
    step = prefill_step(cfg, B, S)
    before = read_launches()
    with flags.use_kernels(False):
        plain_logits = step(model, batch)
    if read_launches() != before:
        raise AssertionError("the plain path launched a kernel")
    rel = rel_frobenius(logits, plain_logits)
    held, routing = rel, None
    if cfg.moe is not None:
        routing, held = moe_routing_report(step, model, batch, logits,
                                           plain_logits)
        routing["bar_held_on"] = "the plain path with the kernel path's " \
            "routing replayed, every token"
    ms = float(np.median(times))
    record_path(cfg, "prefill", WorkloadSpec(phase="prefill", global_batch=B,
                                             seq_len=S), ms * 1e-3,
                f"median of {n_steps} prefill steps (host clock, "
                "synchronised)")
    ok = held <= TOL_PREFILL_BF16
    emit({"phase": "prefill", "ok": ok,
          "arch": cfg.name, "tokens": [B, S],
          "logits": {"shape": list(logits.shape),
                     "dtype": str(logits.dtype).replace("torch.", ""),
                     "held": "whole tensor, finite"},
          "steps": n_steps, "ms_per_step": times,
          "ms_per_step_median": ms, "tokens_per_s": B * S / (ms * 1e-3),
          "launches": launched, "launches_per_step": launches_per_step(cfg),
          "rel_frobenius_vs_plain": rel, "held": held, "tol": TOL_PREFILL_BF16,
          "routing": routing})
    if not ok:
        raise AssertionError(f"prefill kernel vs plain (bf16): relative "
                             f"Frobenius error {held:.3e} > "
                             f"{TOL_PREFILL_BF16:g}")


def phase_prefill_compare_f32(cfg, model, batch, logits):
    """The same model and batch in f32: here the two paths must agree
    closely over every token, which shows that the bf16 figure is rounding.
    Casts ``model`` to f32 in place."""
    model.float()
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    batch = {k: v.float() if v.is_floating_point() else v
             for k, v in batch.items()}
    B, S = batch["tokens"].shape[:2]
    step32 = prefill_step(cfg32, B, S)
    before = read_launches()
    k_logits = step32(model, batch)
    after = read_launches()
    launched = {n: after[n] - before[n] for n in after}
    # a second call, timed, for the predict phase
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = step32(model, batch)
    torch.cuda.synchronize()
    f32_s = time.perf_counter() - t0
    del again
    record_path(cfg32, "prefill.f32", WorkloadSpec(
        phase="prefill", global_batch=B, seq_len=S), f32_s,
        "the second f32 prefill step (host clock, synchronised)")
    with flags.use_kernels(False):
        p_logits = step32(model, batch)
    rel32 = rel_frobenius(k_logits, p_logits)
    routing = None
    if cfg.moe is not None:
        routing, _ = moe_routing_report(step32, model, batch, k_logits,
                                        p_logits)
    emit({"phase": "prefill.f32", "ok": rel32 <= TOL_PREFILL_F32,
          "arch": cfg.name, "tokens": list(batch["tokens"].shape),
          "n_layers": cfg32.n_layers, "launches": launched,
          "rel_frobenius_vs_plain": rel32, "tol": TOL_PREFILL_F32,
          "held_on": "every token", "routing": routing,
          # how far bf16 itself moves the logits: the scale against which
          # the bf16 kernel-vs-plain figure is to be read
          "bf16_step_vs_f32_step_rel_frobenius":
              rel_frobenius(logits, k_logits),
          "ms_second_call": f32_s * 1e3})
    if launched != launches_per_step(cfg32) or not rel32 <= TOL_PREFILL_F32:
        raise AssertionError(f"prefill kernel vs plain (f32): relative "
                             f"Frobenius error {rel32:.3e} > "
                             f"{TOL_PREFILL_F32:g}, launches {launched}")


def decode_check_config(cfg, n_layers: int, T: int):
    """``cfg`` for the decode-equals-prefill check: f32, ``n_layers``
    layers, text only (decode takes no vision embeddings, as in the
    reference).  For the MoE, ``capacity_factor = E / K``: decode routes
    groups of B tokens with C = max(⌈K·B·cf/E⌉, 4), prefill groups of up to
    2048, so at the configured factor a token may be dropped on one path and
    kept on the other; at E / K no group can drop.  A sliding window longer
    than the T tokens masks nothing in the prefill and goes: with one the
    decode cache is a ring of ``window`` rows that decode attends whole,
    rows not yet written included, as the reference's does."""
    kw = dict(n_layers=n_layers, param_dtype="float32",
              compute_dtype="float32", vision_tokens=0)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k)
    if cfg.sliding_window is not None and T <= cfg.sliding_window:
        kw["sliding_window"] = None
    return dataclasses.replace(cfg, **kw)


def phase_decode_equals_prefill(cfg, seed, n_layers):
    """f32, full width, ``n_layers`` layers: a decode_step chain over 64
    tokens against forward on the same tokens; then one greedy
    ``make_serve_step`` from the chain's state, which must pick the argmax
    of each head's next logits."""
    B, T = 2, 64
    cfg2 = decode_check_config(cfg, n_layers, T)
    model = transformer.init_params(cfg2, device=DEV, seed=seed + 1)
    tokens = main_batch(cfg2, B, T, seed + 1)["tokens"]
    before = read_launches()
    with torch.no_grad():
        full, _ = transformer.forward(model, cfg2, {"tokens": tokens})
        after = read_launches()
        state = transformer.init_decode_state(cfg2, B, T + 1, device=DEV)
        worst = 0.0
        for t in range(T):
            logits, state = transformer.decode_step(model, cfg2, state,
                                                    tokens[:, t:t + 1])
            worst = max(worst, float((logits[:, 0] - full[:, t]).abs().max()))
        last = tokens[:, T - 1:T]
        # a copy of the caches (updated in place) for the logits to compare
        peek = {k: type(v)(*(t.clone() for t in v))
                if isinstance(v, tuple) else v for k, v in state.items()}
        nxt_logits, _ = transformer.decode_step(model, cfg2, peek, last)
        nxt, _ = serve_step(cfg2, B, T + 1, sample=False)(model, state,
                                                           last)
    launched = {n: after[n] - before[n] for n in after}
    if launched != launches_per_step(cfg2):
        raise AssertionError(f"forward launched {launched}")
    if not worst <= 1e-3:
        raise AssertionError(f"decode chain vs forward: {worst:.3e} > 1e-3")
    if not torch.equal(nxt, torch.argmax(nxt_logits[:, -1], dim=-1)
                       .to(torch.int32)):
        raise AssertionError("serve step: not the argmax of each head")
    emit({"phase": "decode_equals_prefill", "ok": True, "arch": cfg.name,
          "dtype": "float32", "n_layers": n_layers, "tokens": T,
          "max_abs_err": worst, "tol": 1e-3,
          "serve_step_tokens": list(nxt.shape),
          "changed_for_the_check": {
              k: str(getattr(cfg2, k)) for k in
              ("moe", "sliding_window", "vision_tokens")
              if getattr(cfg2, k) != getattr(cfg, k)}})


def drive_path(cfg, args, serve: bool, decode_layers: int,
               n_steps: int = None, f32_layers: int = None) -> dict:
    """One main path: init, the counted prefill steps (and server run) with
    the launch counts set to 0 just before and read just after, then the
    comparisons against the plain path.  Returns the counts.  ``n_steps``
    prefill steps (default: 3 on a served path, else 1); ``f32_layers``: the
    f32 comparison runs on a fresh model of that depth (full width), where
    the path's own depth would not fit on the card in f32."""
    (B, S) = PREFILL_TOKENS
    if n_steps is None:
        n_steps = PREFILL_STEPS if serve else 1
    name = cfg.name
    with phase(f"{name}:init"):
        model = phase_init(cfg, args.seed, B, S)

    # ---- the main path, with the launch counts set to 0 just before -------
    reset_launches()
    with phase(f"{name}:prefill.run"):
        batch, logits, times = phase_prefill(cfg, model, B, S, args.seed,
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
        phase_prefill_compare(cfg, model, batch, logits, times, launched,
                              n_steps)
    if args.profile:
        with phase(f"{name}:profile"):
            phase_profile(cfg, model, batch, args.seed, serve)
    if f32_layers is not None:
        del model, logits
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(cfg, n_layers=f32_layers)
        model = transformer.init_params(cfg, device=DEV, seed=args.seed)
        logits = prefill_step(cfg, B, S)(model, batch)
    with phase(f"{name}:prefill.compare_f32"):
        phase_prefill_compare_f32(cfg, model, batch, logits)
    del model, batch, logits
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


def phase_profile(cfg, model, batch, seed, serve: bool):
    """Optional (--profile): where one prefill step and one decode iteration
    spend their time: the server's (8 slots after 16-token prompts) on a
    served path, else a greedy ``make_serve_step`` over 8 rows."""
    step = prefill_step(cfg, *batch["tokens"].shape[:2])
    pre = _profile(lambda: step(model, batch), 1)
    slots = SERVE["slots"]
    if serve:
        server = DecodeServer(cfg, model, slots=slots,
                              max_len=SERVE["max_len"], seed=seed, device=DEV)
        rng = np.random.default_rng(seed)
        for rid in range(slots):
            prompt = rng.integers(2, cfg.vocab_size, size=16).astype(np.int32)
            server.submit(Request(rid=rid, prompt=prompt, max_new=64))
        server._refill()
        dec = _profile(server.step, 5)
    else:
        state = transformer.init_decode_state(cfg, slots, SERVE["max_len"],
                                              device=DEV)
        step1 = serve_step(cfg, slots, SERVE["max_len"], sample=False)
        tok = main_batch(cfg, slots, 1, seed)["tokens"]

        def one():
            nonlocal state
            _, state = step1(model, state, tok)
        dec = _profile(one, 5)
    record_idle(cfg, "prefill", pre)
    if serve:
        record_idle(cfg, "decode", dec)
    emit({"phase": "profile", "ok": True, "arch": cfg.name,
          "prefill_step": pre, "decode_iteration": dec,
          "decode_by": "DecodeServer.step" if serve
          else "steps.make_serve_step (greedy)"})


# ---------------------------------------------------------------------------
# the training paths


def train_launches_per_step(cfg, L: int) -> dict:
    """The kernel launches one train step of ``cfg`` at sequence length
    ``L`` must make under remat ``full``: each attention and SSD layer's
    forward, and again in the backward's recompute; and each SSD layer's
    backward kernels (``ssd.BACKWARD_LAUNCHES``) where ``backward_rule``
    takes the layer's inputs in the model's compute type."""
    counts = {n: 2 * k for n, k in launches_per_step(cfg).items()}
    s = cfg.ssm
    if counts["ssd_scan"] and ssd.backward_rule(
            s.head_dim, s.d_state, L,
            cfg.compute_dtype == "bfloat16") == "kernel":
        counts["ssd_scan_backward"] = \
            ssd.BACKWARD_LAUNCHES * launches_per_step(cfg)["ssd_scan"]
    return counts


def new_trainer(cfg, seed, ckpt_dir=None, save_on_exit=True) -> Trainer:
    B, S = TRAIN_TOKENS
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                    seed=seed)
    tc = TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=2, keep_ckpts=2,
                       seed=seed, save_on_exit=save_on_exit, **TRAIN_LR)
    return Trainer(cfg, dc, tc, device=DEV)


def quiet(step, metrics) -> None:
    """``Trainer.train``'s per-step callback: the phase lines report."""


def rel_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """Relative Frobenius difference of one tensor (0 where both are 0)."""
    num = float((a.float() - b.float()).norm())
    den = float(b.float().norm())
    return num / den if den else (0.0 if num == 0.0 else math.inf)


def loss_and_grads(cfg, model, batch, events=None):
    """One ``loss_fn`` + backward (the config's remat), as the train step
    takes it; ``events``: three CUDA events recorded before the forward,
    between forward and backward, and after the backward."""
    params = [p for _, p in model.named_parameters()]
    if events:
        events[0].record()
    loss, _ = transformer.loss_fn(model, cfg, batch)
    if events:
        events[1].record()
    grads = torch.autograd.grad(loss, params)
    if events:
        events[2].record()
    return loss.detach(), grads


def checkpoint_bytes(trainer) -> int:
    """Bytes of one checkpoint: the parameters and AdamW's m and v."""
    st = trainer.state
    ts = [*st.params.parameters(), *st.opt_state["m"].values(),
          *st.opt_state["v"].values()]
    return sum(t.numel() * t.element_size() for t in ts)


def phase_train_init(cfg, seed) -> Trainer:
    t0 = time.perf_counter()
    trainer = new_trainer(cfg, seed)
    n_params = transformer.param_count(trainer.state.params)
    if n_params != cfg.n_params():
        raise AssertionError(f"{n_params} parameters, config says "
                             f"{cfg.n_params()}")
    torch.cuda.synchronize()
    emit({"phase": "train.init", "ok": True, "arch": cfg.name,
          "n_params": n_params, "dtype": cfg.param_dtype,
          "optimizer": cfg.optimizer, "remat": cfg.remat_policy,
          "tokens": list(TRAIN_TOKENS), "lr": TRAIN_LR,
          "memory_allocated_bytes": torch.cuda.memory_allocated(),
          "checkpoint_bytes": checkpoint_bytes(trainer),
          "seconds": round(time.perf_counter() - t0, 2)})
    return trainer


def grad_stats(rels: dict) -> dict:
    worst = max(rels, key=rels.get)
    return {"max": rels[worst], "worst": worst,
            "median": float(np.median(list(rels.values())))}


def phase_train_compare(cfg, seed) -> dict:
    """The training path's weights (the trainer's seed) and first batch:
    one loss + backward through the kernels and one under
    ``use_kernels(False)`` (attention then takes the reference's chunked
    path, 4096² > 2048² pairs), in bf16, then both again with the model in
    f32.  The f32 gradient of the plain path is the yardstick: bf16 itself
    moves every gradient by several per cent at this depth, the plain path's
    as much as the kernels', so the bf16 bar holds the kernel path's
    distance to it within ``TOL_TRAIN_GRAD`` of the plain path's, and the
    f32 kernel path must match the f32 plain path to ``TOL_TRAIN_F32``.
    The bf16 kernel path's forward / backward are timed with CUDA events."""
    B, S = TRAIN_TOKENS
    model = transformer.init_params(cfg, device=DEV, seed=seed)
    names = [n for n, _ in model.named_parameters()]
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                    seed=seed)
    batch = {k: torch.from_numpy(v).to(DEV)
             for k, v in PackedLoader(dc).batch(0).items()}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    want = train_launches_per_step(cfg, S)

    def run(cfg_, kernels, events=None):
        before = read_launches()
        with flags.use_kernels(kernels):
            loss, grads = loss_and_grads(cfg_, model, batch, events)
        torch.cuda.synchronize()
        after = read_launches()
        launched = {n: after[n] - before[n] for n in after}
        per = train_launches_per_step(cfg_, S)
        if launched != (per if kernels else {n: 0 for n in per}):
            raise AssertionError(f"{cfg_.name}: loss + backward launched "
                                 f"{launched} (kernels {kernels})")
        return float(loss), grads

    loss_k, gk = run(cfg, True, ev[:3])
    loss_p, gp = run(cfg, False, ev[3:])
    bf16 = grad_stats({n: rel_diff(a, b) for n, a, b in zip(names, gk, gp)})
    model.float()
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    loss_32, g32 = run(cfg32, False)
    k_vs_32 = {n: rel_diff(a, b) for n, a, b in zip(names, gk, g32)}
    p_vs_32 = {n: rel_diff(a, b) for n, a, b in zip(names, gp, g32)}
    del gk, gp
    excess = {n: k_vs_32[n] - p_vs_32[n] for n in names}
    loss_32k, g32k = run(cfg32, True)
    f32 = grad_stats({n: rel_diff(a, b) for n, a, b in zip(names, g32k, g32)})
    del g32k, g32, model
    torch.cuda.empty_cache()
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    worst_excess = max(excess, key=excess.get)
    ok = (loss_rel <= TOL_TRAIN_LOSS and math.isfinite(loss_k)
          and excess[worst_excess] <= TOL_TRAIN_GRAD
          and f32["max"] <= TOL_TRAIN_F32)
    res = {"phase": "train.compare", "ok": ok, "arch": cfg.name,
           "tokens": [B, S], "launches": want,
           "loss": {"bf16_kernels": loss_k, "bf16_plain": loss_p,
                    "f32_plain": loss_32, "f32_kernels": loss_32k},
           "loss_rel_diff": loss_rel, "loss_tol": TOL_TRAIN_LOSS,
           "n_grads": len(names),
           "grad_bf16_kernels_vs_bf16_plain": bf16,
           "grad_bf16_kernels_vs_f32": grad_stats(k_vs_32),
           "grad_bf16_plain_vs_f32": grad_stats(p_vs_32),
           "grad_bf16_kernel_excess_over_plain": {
               "max": excess[worst_excess], "worst": worst_excess},
           "grad_tol": TOL_TRAIN_GRAD,
           "grad_f32_kernels_vs_f32_plain": f32, "grad_f32_tol": TOL_TRAIN_F32,
           "kernels_forward_ms": ev[0].elapsed_time(ev[1]),
           "kernels_backward_ms": ev[1].elapsed_time(ev[2]),
           "plain_forward_ms": ev[3].elapsed_time(ev[4]),
           "plain_backward_ms": ev[4].elapsed_time(ev[5]),
           "timing_note": "first calls of the run (warm-up included)"}
    emit(res)
    if not ok:
        raise AssertionError(
            f"{cfg.name}: train step kernels vs plain: loss {loss_rel:.3e} "
            f"(bar {TOL_TRAIN_LOSS:g}); bf16 gradient {worst_excess} "
            f"{excess[worst_excess]:.3e} farther from f32 than the plain "
            f"path's (bar {TOL_TRAIN_GRAD:g}); f32 gradient {f32['worst']} "
            f"{f32['max']:.3e} (bar {TOL_TRAIN_F32:g})")
    return res


def phase_train_steps(cfg, trainer, n_steps) -> list:
    """The counted train steps through ``Trainer.train``."""
    torch.cuda.reset_peak_memory_stats()
    hist = trainer.train(n_steps, on_metrics=quiet)
    peak = torch.cuda.max_memory_allocated()
    B, S = TRAIN_TOKENS
    n = cfg.n_params()
    steps_out = [{"step": m["step"], "loss": m["loss"],
                  "grad_norm": m["grad_norm"], "lr": m["lr"],
                  "seconds": m["time_s"], "tokens_per_s": B * S / m["time_s"],
                  "mfu_bf16": 6.0 * n * B * S / (m["time_s"]
                                                 * PEAK_BF16_FLOPS)}
                 for m in hist]
    if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
               for m in hist):
        raise AssertionError(f"{cfg.name}: a loss is not finite: {hist}")
    record_path(cfg, "train", WorkloadSpec(phase="train", global_batch=B,
                                           seq_len=S),
                float(np.median([m["time_s"] for m in hist])),
                f"median of {n_steps} Trainer.train steps",
                plan=TRAINER_PLAN, peak_memory_bytes=peak)
    emit({"phase": "train.steps", "ok": True, "arch": cfg.name,
          "tokens": [B, S], "steps": steps_out,
          "losses": [m["loss"] for m in hist],
          "seconds_median": float(np.median([m["time_s"] for m in hist])),
          "peak_memory_bytes": peak,
          "mfu_note": "6 * n_params * tokens / (step seconds * 989e12)"})
    return hist


def resume_config(cfg):
    """The training path cut in depth for the checkpoint round trip: one
    checkpoint of llama3.2-3b is 33.6 GiB (zamba2-2.7b 22.6 GiB), and the
    whole run must write well under 45 GiB to disk, so two saves of each at
    full depth are out of reach.  Full width; 2 layers (the hybrid: one
    super-block of ``attn_every`` SSM layers and the shared block)."""
    n = cfg.hybrid.attn_every if cfg.family == "hybrid" else 2
    return dataclasses.replace(cfg, n_layers=n)


def phase_train_resume(cfg, seed, n_steps):
    """``n_steps`` steps through ``Trainer.train`` with a checkpoint
    directory (an async save after step 2 and the exit save), then a fresh
    Trainer resumes from the async save and replays the last step: the exit
    save is set aside first (``store.quarantine``), as if the run had been
    preempted before it landed.  The replayed loss must equal the first
    run's."""
    cut = resume_config(cfg)
    with tempfile.TemporaryDirectory(prefix=f"ckpt-{cfg.name}-") as ckpt_dir:
        t0 = time.perf_counter()
        first = new_trainer(cut, seed, ckpt_dir)
        nbytes = checkpoint_bytes(first)
        hist = first.train(n_steps, on_metrics=quiet)
        first_s = time.perf_counter() - t0
        saved = sorted(int(d[5:]) for d in os.listdir(ckpt_dir)
                       if d.startswith("step_"))
        if saved != [n_steps - 1, n_steps]:
            raise AssertionError(f"checkpoints {saved}, expected the async "
                                 f"save {n_steps - 1} and the exit save "
                                 f"{n_steps}")
        del first
        store.quarantine(ckpt_dir, n_steps)
        t0 = time.perf_counter()
        trainer = new_trainer(cut, seed, ckpt_dir, save_on_exit=False)
        restore_s = time.perf_counter() - t0
        if trainer.step != n_steps - 1:
            raise AssertionError(f"resumed at step {trainer.step}, expected "
                                 f"{n_steps - 1}")
        replay = trainer.train(1, on_metrics=quiet)[0]
        del trainer
    want = hist[-1]["loss"]
    rel = abs(replay["loss"] - want) / abs(want)
    emit({"phase": "train.resume", "ok": rel <= TOL_REPLAY, "arch": cfg.name,
          "n_layers": cut.n_layers, "d_model": cut.d_model,
          "checkpoint_bytes": nbytes, "checkpoints_written": saved,
          "losses": [m["loss"] for m in hist],
          "resumed_at_step": n_steps - 1, "loss_first_run": want,
          "loss_replayed": replay["loss"], "rel_diff": rel,
          "tol": TOL_REPLAY, "first_run_seconds": first_s,
          "init_and_restore_seconds": restore_s})
    if not rel <= TOL_REPLAY:
        raise AssertionError(f"{cfg.name}: replayed loss {replay['loss']} "
                             f"vs {want} (rel {rel:.3e} > {TOL_REPLAY:g})")


def phase_train_split(cfg, trainer) -> dict:
    """One step as ``make_train_step`` takes it, its three parts timed with
    CUDA events: forward (``loss_fn``), backward, optimizer (global-norm
    clip and the AdamW update)."""
    state = trainer.state
    model = state.params
    batch = {k: torch.from_numpy(v).to(DEV)
             for k, v in trainer.loader.batch(state.step).items()}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = loss_and_grads(cfg, model, batch, ev[:3])
    names = [n for n, _ in model.named_parameters()]
    grads, _ = opt.clip_by_global_norm(dict(zip(names, grads)), 1.0)
    lr = opt.warmup_cosine(TRAIN_LR["lr"], TRAIN_LR["warmup"],
                           TRAIN_LR["total_steps"])(state.step)
    _, opt_state = trainer.optimizer.update(
        grads, state.opt_state, dict(model.named_parameters()), lr)
    ev[3].record()
    trainer.state = steps.TrainState(model, opt_state, state.step + 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = {"forward_ms": ev[0].elapsed_time(ev[1]),
           "backward_ms": ev[1].elapsed_time(ev[2]),
           "optimizer_ms": ev[2].elapsed_time(ev[3]), "wall_ms": wall * 1e3}
    emit({"phase": "train.split", "ok": math.isfinite(float(loss)),
          "arch": cfg.name, **res,
          "note": "one further step, its parts timed with CUDA events"})
    return res


def phase_train_profile(cfg, trainer):
    """Optional (--profile): where one train step spends its time."""
    prof = _profile(lambda: trainer.train(1, on_metrics=quiet), 1)
    record_idle(cfg, "train", prof)
    emit({"phase": "train.profile", "ok": True, "arch": cfg.name,
          "train_step": prof})


#: the SSD backward kernels' gradients against autograd of the plain
#: version in f32, relative Frobenius, each its own: bf16 dx, dB, dC round
#: once (1.65-1.66e-3); f32 ddt and dA read 1e-6 to 6e-5 with the products'
#: f32 operands as hi + lo pairs, 3-4e-5 and 1e-4 with one TF32 each, and
#: 2.5-3.2e-4 and 5e-4 to 1.3e-3 (dx, dB, dC 2.3e-3) rounded once to bf16
TOL_SSD_BACKWARD = {"x": 2e-3, "dt": 1e-5, "A": 1e-4, "B": 2e-3, "C": 2e-3}

#: train steps timed at each SSD chunk of ``phase_train_ssd_chunk``
SSD_CHUNK_STEPS = 2


def phase_train_ssd_chunk(cfg, trainer) -> dict:
    """The training step at the SSD chunk ``"auto"`` picks under autograd
    (the backward kernels priced, the same at every chunk) and at 64, 128
    and 256, in turns (the pick first and last): ``SSD_CHUNK_STEPS`` steps
    each, the chunk pinned by wrapping ``ops.ssd_chunk``.  Steps of the
    same trainer (the weights move on), so the seconds compare the chunks,
    not the losses.  ``pick_over_fastest``: the pick's median over the
    fastest chunk's."""
    from repro_torch.kernels import autotune
    B, S = TRAIN_TOKENS
    s = cfg.ssm
    shape = {"Bz": B, "H": cfg.ssm_heads, "L": S, "P": s.head_dim,
             "N": s.d_state, "bits": 16, "tma": True}
    picks = {name: autotune.best_block_sizes(
        "ssd_scan", dict(shape, grad=grad), kops.CARD_MODEL)["chunk"]
        for name, grad in (("autograd", True), ("kernel_only", False))}
    picks["configured"] = min(s.chunk, S)
    chunks = [picks["autograd"]] + [c for c in (64, 128, 256)
                                    if c != picks["autograd"]]
    resolve = kops.ssd_chunk
    times = {c: [] for c in chunks}
    try:
        for c in chunks + chunks[:1]:
            kops.ssd_chunk = lambda *a, _c=c, **k: _c
            hist = trainer.train(SSD_CHUNK_STEPS, on_metrics=quiet)
            times[c] += [m["time_s"] for m in hist[-SSD_CHUNK_STEPS:]]
    finally:
        kops.ssd_chunk = resolve
    med = {c: float(np.median(t)) for c, t in times.items()}
    out = {"phase": "train.ssd_chunk", "ok": True, "arch": cfg.name,
           "tokens": [B, S], "chunks": picks,
           "seconds": {str(c): t for c, t in times.items()},
           "seconds_median": {str(c): m for c, m in med.items()},
           "pick_over_fastest": med[picks["autograd"]] / min(med.values())}
    emit(out)
    return out


def drive_train(cfg, args) -> dict:
    """One training path at full width and depth: the kernels against the
    plain paths on one batch, the trainer, then the counted steps with the
    launch counts set to 0 just before and read just after, the split of a
    step and (--profile) a traced step; then the checkpoint round trip at
    cut depth (``resume_config``).  Returns the counts."""
    name = cfg.name
    with phase(f"{name}:train.compare"):
        phase_train_compare(cfg, args.seed)
    with phase(f"{name}:train.init"):
        trainer = phase_train_init(cfg, args.seed)

    # ---- the main path, with the launch counts set to 0 just before -------
    reset_launches()
    with phase(f"{name}:train.steps"):
        phase_train_steps(cfg, trainer, TRAIN_STEPS)
    launched = read_launches()
    # ---- read just after ---------------------------------------------------
    per = train_launches_per_step(cfg, TRAIN_TOKENS[1])
    want = {n: k * TRAIN_STEPS for n, k in per.items()}
    if launched != want:
        raise AssertionError(f"{name}: kernel launches on the training path "
                             f"{launched}, expected {want}")
    with phase(f"{name}:train.split"):
        phase_train_split(cfg, trainer)
    if cfg.ssm is not None:
        with phase(f"{name}:train.ssd_chunk"):
            phase_train_ssd_chunk(cfg, trainer)
    if args.profile:
        with phase(f"{name}:train.profile"):
            phase_train_profile(cfg, trainer)
    del trainer
    torch.cuda.empty_cache()
    with phase(f"{name}:train.resume"):
        phase_train_resume(cfg, args.seed, TRAIN_STEPS)
    torch.cuda.empty_cache()
    return launched


# ---------------------------------------------------------------------------
# data-parallel training: the manual-DP step on a one-rank NCCL group

#: llama3.2-3b at full width and depth, the training phases' batch, AdamW at
#: the steps' constant 3e-4: DP_STEPS steps each of ``make_train_step`` and
#: of the DP step uncompressed and under ``int8_ef``, each run from the
#: weights the seed makes and the same global batch.  ``DP_LAYERS`` cuts the
#: depth (None: all layers; the width stays)
DP_STEPS = 3
DP_LAYERS = None
#: the uncompressed DP step against ``make_train_step``: each loss and every
#: parameter after the last step, relative (Frobenius)
TOL_DP = 1e-6
#: ``int8_ef``'s loss against the uncompressed step's at every step (the
#: reference's bar, tests/test_multidevice.py)
TOL_DP_INT8 = 0.05


def dp_config():
    cfg = get_arch(ARCH)
    return cfg if DP_LAYERS is None \
        else dataclasses.replace(cfg, n_layers=DP_LAYERS)


def dp_batch(cfg, seed: int) -> dict:
    """The global batch, tokens and labels (B, S) from ``seed``."""
    B, S = TRAIN_TOKENS
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                                ).to(DEV) for k in ("tokens", "labels")}


@contextlib.contextmanager
def one_rank():
    """One rank on the one card: a group of world size 1 (NCCL on the card)
    that meets through a ``FileStore`` in a temporary directory."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import BACKENDS
    with tempfile.TemporaryDirectory(prefix="dp-store-") as d:
        dist.init_process_group(
            BACKENDS[DEV], store=dist.FileStore(os.path.join(d, "store"), 1),
            rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


@contextlib.contextmanager
def device_spans(targets):
    """CUDA events around every call of each ``(module, attribute, label)``
    of ``targets`` while the block runs (the calls look the attribute up
    when they run); yields label -> [(start, end)]."""
    pairs = {label: [] for _, _, label in targets}
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in targets]
    for (owner, attr, label), (_, _, fn) in zip(targets, saved):
        def timed(*a, _fn=fn, _pairs=pairs[label], **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = _fn(*a, **kw)
            end.record()
            _pairs.append((start, end))
            return out
        setattr(owner, attr, timed)
    try:
        yield pairs
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def dp_state(cfg, seed: int, optimizer) -> steps.TrainState:
    model = transformer.init_params(cfg, device=DEV, seed=seed)
    return steps.TrainState(
        model, optimizer.init(dict(model.named_parameters())), 0)


def dp_steps(step, state) -> tuple:
    """``DP_STEPS`` timed steps (``step(state) -> (state, metrics)``); the
    first under ``count_collectives``, every one with device spans of the
    error-feedback quantizer (``ef_compress``: quantize, dequantize, the
    new residual) and the collectives (``psum_compressed`` with its
    requantize; ``all_reduce``).  -> (state, rows, collective bytes of a
    step)."""
    import torch.distributed as dist
    from repro_torch.distributed import compression as comp
    targets = [(comp, "ef_compress", "ef_compress"),
               (comp, "psum_compressed", "psum_compressed"),
               (dist, "all_reduce", "all_reduce")]
    rows, counted = [], None
    for i in range(DP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with device_spans(targets) as pairs:
            if i == 0:
                with extract.count_collectives() as counted:
                    state, m = step(state)
            else:
                state, m = step(state)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        rows.append({"step": i + 1, "loss": loss, "grad_norm": gnorm,
                     "seconds": seconds,
                     "tokens_per_s": math.prod(TRAIN_TOKENS) / seconds,
                     "collectives_counted": i == 0,
                     "device_ms": {k: sum(a.elapsed_time(b) for a, b in v)
                                   for k, v in pairs.items() if v},
                     "calls": {k: len(v) for k, v in pairs.items() if v}})
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise AssertionError(f"dp: step {i + 1} is not finite: {rows}")
    return state, rows, dict(counted)


def phase_dp(seed: int) -> dict:
    """The data-parallel path on one card: ``make_train_step``, then the
    manual-DP step (``steps.make_manual_dp_train_step`` on
    ``make_mesh((1,), ("data",))`` over a one-rank NCCL group) uncompressed
    and under ``int8_ef``, each ``DP_STEPS`` steps from the same weights and
    global batch.  Fails unless the uncompressed step equals the train step
    within ``TOL_DP`` (losses, every parameter) and the int8 losses are
    within ``TOL_DP_INT8`` of the uncompressed ones; reports step times,
    peak memory, the quantizer's and collectives' device ms, the collective
    bytes ``count_collectives`` saw beside ``archcount.collective_counts``'
    closed form.  Resets the launch counts just before and -> reads them
    just after."""
    from repro_torch.core import archcount
    from repro_torch.core.symcount import evaluate_vector
    from repro_torch.launch.mesh import make_mesh
    cfg = dp_config()
    B, S = TRAIN_TOKENS
    batch = dp_batch(cfg, seed)
    optimizer = opt.get_optimizer("adamw")
    n = cfg.n_params()
    line = {"phase": "dp", "ok": True, "arch": cfg.name,
            "n_layers": cfg.n_layers, "tokens": [B, S],
            "optimizer": "adamw", "lr": 3e-4, "ranks": 1,
            "reckoned_bytes": {"params_bf16": 2 * n, "adamw_m_v_f32": 8 * n,
                               "ef_residual_f32": 4 * n,
                               "int8_grads_f32": 4 * n}}
    reset_launches()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step = steps.make_train_step(cfg, optimizer)
    state, rows, _ = dp_steps(lambda st: step(st, batch),
                              dp_state(cfg, seed, optimizer))
    want = {k: p.detach().clone() for k, p in state.params.named_parameters()}
    line["train_step"] = {"steps": rows, "peak_memory_bytes":
                          torch.cuda.max_memory_allocated()}
    del state, step
    runs = {}
    with one_rank():
        mesh = make_mesh((1,), ("data",), device=DEV)
        for compression in (None, "int8_ef"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            fn, init_ef = steps.make_manual_dp_train_step(
                cfg, optimizer, mesh, compression=compression)
            state = dp_state(cfg, seed, optimizer)
            ef = init_ef(state.params)

            def dp_step(st, fn=fn, ef=ef):
                st, _, m = fn(st, ef, batch)
                return st, m
            state, rows, counted = dp_steps(dp_step, state)
            tag = compression or "fp32"
            runs[tag] = {"steps": rows, "collective_bytes": counted,
                         "coll_properties":
                             extract.collective_property_vector(counted),
                         "peak_memory_bytes":
                             torch.cuda.max_memory_allocated()}
            if compression is None:
                diffs = {k: rel_diff(p.detach(), want[k])
                         for k, p in state.params.named_parameters()}
                worst = max(diffs, key=diffs.get)
                runs[tag]["params_max_rel_diff"] = diffs[worst]
                runs[tag]["params_worst"] = worst
                del want
            del state, ef, fn, init_ef
    launched = read_launches()
    ref_losses = [r["loss"] for r in line["train_step"]["steps"]]
    fp32 = [r["loss"] for r in runs["fp32"]["steps"]]
    int8 = [r["loss"] for r in runs["int8_ef"]["steps"]]
    line["loss_rel_diff_fp32_vs_train_step"] = [
        abs(a - b) / abs(b) for a, b in zip(fp32, ref_losses)]
    line["loss_rel_diff_int8_vs_fp32"] = [abs(a - b) / abs(b)
                                          for a, b in zip(int8, fp32)]
    env = {"B": B, "S": S, "M": 1}
    line["closed_form"] = {
        f"{tag} dp={dp}": {k: float(v) for k, v in evaluate_vector(
            archcount.collective_counts(
                cfg, "train", Plan(dp_axes=("data",), fsdp=False,
                                   compression=c), {"data": dp}),
            env).items()}
        for tag, c in (("fp32", None), ("int8_ef", "int8_ef"))
        for dp in (1, 8)}
    line.update(runs)
    want_fa = 2 * cfg.n_layers * 3 * DP_STEPS
    line["launches"] = launched
    line["flash_attention_expected"] = want_fa
    emit(line)
    if max(line["loss_rel_diff_fp32_vs_train_step"]) > TOL_DP \
            or runs["fp32"]["params_max_rel_diff"] > TOL_DP:
        raise AssertionError(f"dp: the uncompressed DP step differs from "
                             f"make_train_step beyond {TOL_DP}")
    if max(line["loss_rel_diff_int8_vs_fp32"]) > TOL_DP_INT8:
        raise AssertionError(f"dp: int8_ef's losses {int8} are not within "
                             f"{TOL_DP_INT8} of fp32's {fp32}")
    if launched["flash_attention"] != want_fa:
        raise AssertionError(f"dp: flash_attention launched "
                             f"{launched['flash_attention']} times, not "
                             f"{want_fa}")
    return launched


# ---------------------------------------------------------------------------
# the DTensor-sharded steps (gspmd.*) and the dry run

#: train steps of the sharded step and of ``make_train_step`` each; prefill
#: steps of each; decode iterations of each (slots x cache rows)
GSPMD_TRAIN_STEPS = 3
GSPMD_PREFILL_STEPS = 2
GSPMD_DECODE = dict(slots=8, max_len=2048, iterations=16)
#: a sharded step against its unsharded step on one rank: losses and every
#: parameter (train), logits (prefill), relative Frobenius; tokens equal
TOL_GSPMD = 1e-6
#: the dry run: a 256-rank fake world in a process of its own
DRYRUN_ARGS = ["dryrun", "--arch", ARCH, "--shape", "train_4k", "--mesh",
               "single"]
DRYRUN_TIMEOUT = 600


def gspmd_plan(cfg, kind: str, B: int, S: int, **edit):
    """``plan_for`` a (B, S) cell of ``kind`` on one card: model axis 1,
    the budget the card's memory."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.plan import plan_for
    shape = ShapeConfig(f"gspmd_{kind}", S, B, kind)
    budget = torch.cuda.get_device_properties(0).total_memory
    return shape, plan_for(cfg, shape, tp_size=1,
                           hbm_budget=budget).with_(**edit), budget


def _local(m: dict) -> dict:
    """Metrics of a sharded step as plain tensors (replicated on the
    mesh: each rank's copy is the value)."""
    return {k: v.to_local() if sharding.is_dtensor(v) else v
            for k, v in m.items()}


def timed_calls(fn, n: int) -> tuple:
    """``n`` synchronized calls of ``fn``; -> (last result, seconds each)."""
    secs, out = [], None
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return out, secs


def phase_gspmd_train(mesh, seed: int) -> dict:
    """llama3.2-3b uncut, 2 x 4096, AdamW at a constant 3e-4:
    ``GSPMD_TRAIN_STEPS`` steps of ``make_train_step``, then as many of the
    train step ``step_and_specs`` gives, run as a DTensor program
    (``specs.sharded``) on the parameters and optimizer state laid out as
    DTensors, from the same weights and batch.  Fails unless the losses and
    every parameter agree within ``TOL_GSPMD``.  The sharded run's model
    is built straight into DTensors (``init_params(mesh=, plan=)``)."""
    cfg = get_arch(ARCH)
    B, S = TRAIN_TOKENS
    batch = dp_batch(cfg, seed)
    optimizer = opt.get_optimizer("adamw")
    shape, plan, budget = gspmd_plan(cfg, "train", B, S)
    n = cfg.n_params()
    line = {"phase": "gspmd.train", "ok": True, "arch": cfg.name,
            "n_layers": cfg.n_layers, "tokens": [B, S], "optimizer": "adamw",
            "lr": 3e-4, "mesh": [list(mesh.mesh_dim_names),
                                 list(mesh.shape)],
            "hbm_budget": budget, "plan": dataclasses.asdict(plan),
            "reckoned_bytes": {"params_bf16": 2 * n, "adamw_m_v_f32": 8 * n,
                               "reference_params_bf16": 2 * n}}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step = steps.make_train_step(cfg, optimizer)
    state, rows, _ = dp_steps(lambda st: step(st, batch),
                              dp_state(cfg, seed, optimizer))
    want = {k: p.detach().clone() for k, p in state.params.named_parameters()}
    line["train_step"] = {"steps": rows, "peak_memory_bytes":
                          torch.cuda.max_memory_allocated()}
    del state, step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fn, _, in_sh, out_sh = specs.train_cell(cfg, shape, mesh, plan)
    run = specs.sharded(fn, mesh, plan, in_sh, out_sh)
    # the model built straight into its shards, the optimizer's state laid
    # out as the parameters
    model = transformer.init_params(cfg, device=DEV, seed=seed, mesh=mesh,
                                    plan=plan)
    state = specs.shard_args(steps.TrainState(
        model, optimizer.init(dict(model.named_parameters())), 0),
        in_sh[0], mesh)
    del model

    def sharded_step(st):
        st, m = run(st, batch)
        return st, _local(m)
    state, rows, counted = dp_steps(sharded_step, state)
    diffs = {k: rel_diff(p.to_local().detach(), want[k])
             for k, p in state.params.named_parameters()}
    worst = max(diffs, key=diffs.get)
    line["sharded_step"] = {
        "steps": rows, "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "collective_bytes": counted,
        "param_placements": sorted({str(p.placements)
                                    for p in state.params.parameters()})}
    del state, run, fn, want
    ref = [r["loss"] for r in line["train_step"]["steps"]]
    got = [r["loss"] for r in line["sharded_step"]["steps"]]
    line["loss_rel_diff"] = [abs(a - b) / abs(b) for a, b in zip(got, ref)]
    line["params_max_rel_diff"] = diffs[worst]
    line["params_worst"] = worst
    line["bit_equal"] = got == ref and diffs[worst] == 0.0
    line["seconds_a_step"] = {
        "train_step": [r["seconds"] for r in line["train_step"]["steps"]],
        "sharded_step": [r["seconds"] for r in line["sharded_step"]["steps"]]}
    if max(line["loss_rel_diff"]) > TOL_GSPMD \
            or diffs[worst] > TOL_GSPMD:
        emit(dict(line, ok=False))
        raise AssertionError(f"gspmd.train: the sharded step differs from "
                             f"make_train_step beyond {TOL_GSPMD}")
    return line


def phase_gspmd_prefill(mesh, cfg, seed: int, phase_name: str,
                        **edit) -> dict:
    """``GSPMD_PREFILL_STEPS`` prefill steps of ``cfg`` on tokens
    ``PREFILL_TOKENS`` through ``make_prefill_step``, then as many through
    the prefill step of ``step_and_specs`` as a DTensor program (the kernels
    on each rank's shard under ``local_map``), the model's parameters laid
    out as DTensors in place.  Fails unless the logits agree within
    ``TOL_GSPMD``."""
    B, S = PREFILL_TOKENS
    shape, plan, budget = gspmd_plan(cfg, "prefill", B, S, **edit)
    model = transformer.init_params(cfg, device=DEV, seed=seed)
    batch = main_batch(cfg, B, S, seed)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step = steps.make_prefill_step(cfg)
    want, plain_s = timed_calls(lambda: step(model, batch),
                                GSPMD_PREFILL_STEPS)
    fn, _, in_sh, _ = specs.prefill_cell(cfg, shape, mesh, plan)
    run = specs.sharded(fn, mesh, plan, in_sh)
    model = specs.shard_args(model, in_sh[0], mesh)
    with extract.count_collectives() as counted:
        got, sharded_s = timed_calls(lambda: run(model, batch),
                                     GSPMD_PREFILL_STEPS)
    got = got.to_local()
    finite = bool(torch.isfinite(got).all())
    rel = rel_frobenius(got, want)
    line = {"phase": phase_name, "ok": True, "arch": cfg.name,
            "n_layers": cfg.n_layers, "dtype": cfg.param_dtype,
            "tokens": [B, S], "hbm_budget": budget,
            "plan": dataclasses.asdict(plan),
            "logits_rel_diff": rel, "bit_equal": bool(torch.equal(got, want)),
            "finite": finite,
            "ms_a_step": {"prefill_step": [t * 1e3 for t in plain_s],
                          "sharded_step": [t * 1e3 for t in sharded_s]},
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "collective_bytes": dict(counted),
            "param_placements": sorted({str(p.placements)
                                        for p in model.parameters()})}
    del model, got, want, run, fn
    if not finite or rel > TOL_GSPMD:
        emit(dict(line, ok=False))
        raise AssertionError(f"{phase_name}: the sharded prefill's logits "
                             f"differ by {rel} (finite {finite}), beyond "
                             f"{TOL_GSPMD}")
    return line


def phase_gspmd_decode(mesh, seed: int) -> dict:
    """llama3.2-3b, ``GSPMD_DECODE`` (8 slots x 2048 rows, 16 iterations):
    the decode step ``make_serve_step`` gives on plain tensors, then the
    serve step of ``step_and_specs`` as a DTensor program on the parameters
    and decode caches laid out as DTensors; each with a generator seeded
    alike.  Fails unless the sampled tokens are equal."""
    cfg = get_arch(ARCH)
    a = GSPMD_DECODE
    shape, plan, budget = gspmd_plan(cfg, "decode", a["slots"],
                                     a["max_len"])
    model = transformer.init_params(cfg, device=DEV, seed=seed)
    rng = np.random.default_rng(seed)
    first = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (a["slots"], 1))).to(DEV)

    def decode(step, model, state):
        gen = torch.Generator(DEV).manual_seed(seed)
        tok, toks, secs = first, [], []
        for _ in range(a["iterations"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nxt, state = step(model, state, tok, gen)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            toks.append(nxt.tolist())
            tok = nxt[:, None]
        return toks, secs

    plain_toks, plain_s = decode(
        steps.make_serve_step(cfg), model,
        transformer.init_decode_state(cfg, a["slots"], a["max_len"],
                                      device=DEV))
    fn, _, in_sh, _ = specs.decode_cell(cfg, shape, mesh, plan)
    run = specs.sharded(fn, mesh, plan, in_sh)
    model = specs.shard_args(model, in_sh[0], mesh)
    state = specs.shard_args(transformer.init_decode_state(
        cfg, a["slots"], a["max_len"], device=DEV), in_sh[1], mesh)
    toks, secs = decode(run, model, state)
    line = {"phase": "gspmd.decode", "ok": True, "arch": cfg.name,
            "slots": a["slots"], "max_len": a["max_len"],
            "iterations": a["iterations"], "hbm_budget": budget,
            "plan": dataclasses.asdict(plan), "tokens_equal": toks ==
            plain_toks,
            "ms_an_iteration": {"serve_step": [t * 1e3 for t in plain_s],
                                "sharded_step": [t * 1e3 for t in secs]},
            "median_ms": {"serve_step": float(np.median(plain_s)) * 1e3,
                          "sharded_step": float(np.median(secs)) * 1e3}}
    del model, state, run, fn
    if toks != plain_toks:
        emit(dict(line, ok=False))
        raise AssertionError(f"gspmd.decode: the sharded serve step sampled "
                             f"{toks}, the plain one {plain_toks}")
    return line


def phase_dryrun() -> dict:
    """``python -m repro_torch.launch dryrun`` on ``DRYRUN_ARGS`` in a
    process of its own (its fake world of 256 ranks is that process's
    default group), beside ``archcount``'s closed form of the cell's flops
    and collective bytes per rank and ``predictor.estimate_peak_bytes``."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.core import archcount
    from repro_torch.core.symcount import evaluate_vector
    from repro_torch.distributed.plan import H100_HBM_BYTES, plan_for
    with tempfile.TemporaryDirectory(prefix="dryrun-") as d:
        out = os.path.join(d, "dryrun.json")
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "repro_torch.launch",
                            *DRYRUN_ARGS, "--out", out], env=env,
                           capture_output=True, text=True,
                           timeout=DRYRUN_TIMEOUT)
        seconds = time.perf_counter() - t0
        if p.returncode != 0:
            raise AssertionError(f"dryrun exited {p.returncode}:\n"
                                 f"{p.stdout[-4000:]}\n{p.stderr[-4000:]}")
        (rec,) = json.load(open(out))
    os.makedirs(EXPERIMENTS_OUT, exist_ok=True)
    with open(os.path.join(EXPERIMENTS_OUT, "dryrun_torch.json"), "w") as f:
        json.dump([rec], f, indent=1)
    if rec["status"] != "ok" or rec["n_devices"] != 256:
        raise AssertionError(f"dryrun: {rec}")
    cfg, shape = get_arch(ARCH), SHAPES["train_4k"]
    plan = plan_for(cfg, shape, hbm_budget=H100_HBM_BYTES)
    env_ = {"B": shape.global_batch, "S": shape.seq_len,
            "M": plan.microbatches}
    counts = archcount.counts_for(cfg, shape)
    pv = evaluate_vector(counts.pv, env_)
    model_flops = float(evaluate_vector({"f": counts.model_flops},
                                        env_)["f"])
    mesh = {"data": 16, "model": 16}
    coll = {k: float(v) for k, v in evaluate_vector(
        archcount.collective_counts(cfg, "train", plan, mesh),
        env_).items()}
    closed = {
        "mxu_flops_per_device": sum(v for k, v in pv.items()
                                    if k.startswith("mxu:")) / 256,
        "model_flops_per_device": model_flops / 256,
        "collective_bytes_per_device": coll,
        "estimate_peak_bytes": predictor.estimate_peak_bytes(
            cfg, shape, plan, mesh)}
    return {"phase": "dryrun", "ok": True, "args": DRYRUN_ARGS,
            "seconds": seconds, "record": rec, "closed_form": closed,
            "flops_over_model_flops":
                rec["flops_per_device"] / closed["model_flops_per_device"]}


def phase_gspmd(seed: int) -> dict:
    """The DTensor-sharded steps on a (1, 1) ``data, model`` mesh over the
    one-rank NCCL group ``one_rank`` makes (``gspmd.train``,
    ``gspmd.prefill`` on zamba2-2.7b, ``gspmd.ep`` on mixtral-8x7b at
    ``MOE_LAYERS`` layers under ``moe_mode="ep"``, ``gspmd.decode``), each
    beside its unsharded step, then the dry run.  Resets the launch counts
    just before and -> reads them just after; fails unless they are the
    ones the steps make (two of each kind of step, sharded and not)."""
    from repro_torch.launch.mesh import make_mesh
    reset_launches()
    with one_rank():
        mesh = make_mesh((1, 1), ("data", "model"), device=DEV)
        emit(phase_gspmd_train(mesh, seed))
        torch.cuda.empty_cache()
        emit(phase_gspmd_prefill(mesh, get_arch(HYBRID), seed,
                                 "gspmd.prefill"))
        torch.cuda.empty_cache()
        mixtral = dataclasses.replace(get_arch(MOE), n_layers=MOE_LAYERS)
        emit(phase_gspmd_prefill(mesh, mixtral, seed, "gspmd.ep",
                                 moe_mode="ep"))
        torch.cuda.empty_cache()
        emit(phase_gspmd_decode(mesh, seed))
    launched = read_launches()
    torch.cuda.empty_cache()
    want = {"flash_attention": 2 * (
        2 * get_arch(ARCH).n_layers * GSPMD_TRAIN_STEPS
        + GSPMD_PREFILL_STEPS * (
            launches_per_step(get_arch(HYBRID))["flash_attention"]
            + MOE_LAYERS)),
        "ssd_scan": 2 * GSPMD_PREFILL_STEPS * get_arch(HYBRID).n_layers,
        "matmul": 0, "transpose": 0, "ssd_scan_backward": 0}
    emit({"phase": "gspmd.launches", "ok": launched == want,
          "launches": launched, "expected": want})
    if launched != want:
        raise AssertionError(f"gspmd: launches {launched}, expected {want}")
    emit(phase_dryrun())
    return launched


# ---------------------------------------------------------------------------
# online calibration and supervised recovery (robust.serve, robust.train,
# robust.fleet)

#: the serving stretch: 16 requests on a server of 8 slots x 2048 rows (the
#: serve phase's geometry), tokens sampled from the server's seed, no early
#: stop; two prefill steps of the prefill phase's shape through the
#: kernel first (the server feeds prompts through the decode step, as the
#: reference's)
ROBUST_SERVE = dict(slots=8, max_len=2048, requests=16, max_new=32,
                    prompt_len=(8, 16), prefill_steps=2)
#: iteration-indexed: 20 clean iterations (the calibrator's 16 warmup
#: samples and 4 more), a x3 slowdown for 10, a x4 spike, a poisoned
#: telemetry sample, a device loss that evicts every slot 13 tokens into the
#: second wave of requests, then a clean stretch to the end
ROBUST_SERVE_FAULTS = ("slowdown@20:factor=3,duration=10;timing_spike@36;"
                       "telemetry_nan@40;device_loss@45")
#: the training stretch: llama3.2-3b at the train.resume cut (2 layers, full
#: width), 2 x 4096 tokens a step, with Adafactor in place of the config's
#: AdamW: one save with AdamW's m and v is 9.2 GiB at this cut and the run's
#: disk writes must stay under 45 GiB (train.resume writes 27.9 GiB); a save
#: every 3 steps, 7 steps
ROBUST_TRAIN_STEPS = 7
ROBUST_TRAIN_CKPT_EVERY = 3
ROBUST_TRAIN_OPTIMIZER = "adafactor"
#: a x3 slowdown of steps 1-2, a poisoned sample at step 2; at step 6 the
#: newest save (step 6), a copy of the calibrate phase's registry and a
#: compile cache of the phase's own corrupted, then a device lost
ROBUST_TRAIN_FAULTS = ("slowdown@1:factor=3,duration=2;telemetry_nan@2;"
                       "corrupt_checkpoint@6:mode=garbage;corrupt_registry@6;"
                       "corrupt_compile_cache@6;device_loss@6")
#: the devices a replan prices meshes over (the run stays on one card)
ROBUST_REPLAN_DEVICES = 8
#: the fleet's CLI run and its migration on the card
ROBUST_FLEET_ARGS = ["fleet", "--manifest", "demo", "--steps", "12",
                     "--fault-plan", "pool_shrink@5:pool=a100,k=2",
                     "--chaos-seed", "7"]
ROBUST_FLEET_STEPS = 5
#: the window of samples ``window_rel_err`` reads before and after a refit
REFIT_WINDOW = 16


class RecordedCalibrator(OnlineCalibrator):
    """``OnlineCalibrator`` that keeps, for each sample, what the robust
    phases print: the measured seconds, the tracked (RLS) and the active
    model's predictions before the sample, the CUSUM evidence after it, the
    sink seq; and, around each refit, the windowed relative error of the
    active model.  ``poison``: a ``FaultInjector`` whose
    ``perturb_telemetry`` the sample passes on its way in (the server has no
    telemetry hook, as the reference's; the trainer calls it itself)."""

    def __init__(self, *a, poison=None, **kw):
        super().__init__(*a, **kw)
        self.poison = poison
        self.rows = []
        self.refit_errors = []
        self._samples = {}      # samples offered so far, by phase

    def observe(self, pv, seconds, *, step=None, tag="", phase="train"):
        k = self._samples.get(phase, 0)
        self._samples[phase] = k + 1
        if self.poison is not None:
            seconds = self.poison.perturb_telemetry(k, seconds)
        scoped = self.phase is None or phase == self.phase
        tracked = self.rls.predict(pv) if scoped else None
        active = self.model.predict(pv)
        before = self.window_rel_err(REFIT_WINDOW)
        n0 = self.sink.n_recorded
        ev = super().observe(pv, seconds, step=step, tag=tag, phase=phase)
        self.rows.append({
            "k": k, "phase": phase, "step": step,
            "seq": n0 if self.sink.n_recorded > n0 else None,
            "measured_ms": seconds * 1e3 if math.isfinite(seconds) else None,
            "tracked_ms": None if tracked is None else tracked * 1e3,
            "model_ms": active * 1e3, "cusum": self.drift.evidence})
        if ev is not None:
            self.refit_errors.append({
                "seq": ev.seq, "window": REFIT_WINDOW,
                "rel_err_before": before,
                "rel_err_after": self.window_rel_err(REFIT_WINDOW)})
        return ev

    def events_json(self) -> list:
        return [{"seq": e.seq, "step": e.step, "onset_seq": e.onset_seq,
                 "direction": e.direction, "phase": e.phase,
                 "magnitude": e.magnitude} for e in self.events]


def serve_requests(cfg, seed: int) -> list:
    a = ROBUST_SERVE
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(a["requests"]):
        plen = int(rng.integers(a["prompt_len"][0], a["prompt_len"][1] + 1))
        out.append(Request(rid=rid, prompt=rng.integers(
            2, cfg.vocab_size, size=plen).astype(np.int32),
            max_new=a["max_new"]))
    return out


def robust_server(cfg, model, seed, **kw) -> DecodeServer:
    a = ROBUST_SERVE
    server = DecodeServer(cfg, model, slots=a["slots"], max_len=a["max_len"],
                          seed=seed, eos_id=-1, device=DEV, **kw)
    for r in serve_requests(cfg, seed):
        server.submit(r)
    return server


def phase_robust_serve(reg_dir: str, seed: int) -> dict:
    """llama3.2-3b (full width and depth, bf16) on ``ROBUST_SERVE``: two
    prefill steps through the attention kernel, then a server under
    ``ServingSupervisor`` with an ``OnlineCalibrator`` scoped to decode and
    warm-started from the ``gpu-h100`` model the calibrate phase fitted, and
    a ``FaultInjector`` on ``ROBUST_SERVE_FAULTS``; beside a clean run of the
    same requests on the same seed.  Fails where a request does not
    complete, an evicted request's tokens before its eviction differ from
    the clean run's or are not kept after it, the poisoned sample is not
    quarantined, the slowdown raises no "slow" event, or the logits are not
    finite.  The launch counts are set to 0 before the prefill and read
    after the supervised run (the decode path launches no kernel)."""
    cfg = get_arch(ARCH)
    model = transformer.init_params(cfg, device=DEV, seed=seed)
    a = ROBUST_SERVE
    # the clean run: the same requests, seed and server, no fault
    clean = robust_server(cfg, model, seed)
    t0 = time.perf_counter()
    clean_done = clean.run()
    clean_s = time.perf_counter() - t0
    clean_out = {r.rid: list(r.out) for r in clean_done}
    del clean
    torch.cuda.empty_cache()

    fitted = registry.load_model(CALIB_DEVICE, reg_dir)
    plan = FaultPlan.parse(ROBUST_SERVE_FAULTS, seed=seed)
    inj = FaultInjector(plan)
    cal = RecordedCalibrator(fitted, device=CALIB_DEVICE, phase="decode",
                             registry_dir=reg_dir, poison=inj)
    reset_launches()
    B, S = PREFILL_TOKENS
    step = prefill_step(cfg, B, S)
    batch = main_batch(cfg, B, S, seed)
    live = WorkloadSpec(phase="prefill", global_batch=B, seq_len=S,
                        name="prefill_live")
    prefill_pv = predictor.plan_property_vector(cfg, live, Plan(dp_axes=()),
                                                MESH1)
    prefill_ms = []
    for _ in range(a["prefill_steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = step(model, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        prefill_ms.append(dt * 1e3)
        cal.observe(prefill_pv, dt, tag="prefill", phase="prefill")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("prefill logits are not finite")
    del logits

    server = robust_server(cfg, model, seed, calibrator=cal, injector=inj)
    snap = {}
    evict = server.evict_slot

    def evict_and_keep(slot):
        req = server.active[slot]
        if req is not None:
            snap[req.rid] = list(req.out)
        return evict(slot)
    server.evict_slot = evict_and_keep
    sup = ServingSupervisor(server, ServingPolicy(), injector=inj)
    t0 = time.perf_counter()
    done = sup.run()
    run_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launched = read_launches()
    want = {n: k * a["prefill_steps"]
            for n, k in launches_per_step(cfg).items()}
    if launched != want:
        raise AssertionError(f"robust.serve launches {launched}, expected "
                             f"{want}")
    if not bool(torch.isfinite(server.last_logits).all()):
        raise AssertionError("decode logits are not finite")
    if sorted(r.rid for r in done) != list(range(a["requests"])) or \
            any(len(r.out) != a["max_new"] for r in done):
        raise AssertionError(f"{len(done)} of {a['requests']} requests "
                             "completed with their tokens")
    if sorted(clean_out) != list(range(a["requests"])):
        raise AssertionError("the clean run did not complete")
    by_rid = {r.rid: r for r in done}
    resumed = []
    for rid, before in sorted(snap.items()):
        out = by_rid[rid].out
        if out[:len(before)] != before:
            raise AssertionError(f"request {rid}: its tokens before the "
                                 "eviction were not kept")
        if before != clean_out[rid][:len(before)]:
            raise AssertionError(f"request {rid}: tokens before the "
                                 "eviction differ from the clean run's")
        after = out[len(before):]
        same = sum(x == y for x, y in zip(after,
                                          clean_out[rid][len(before):]))
        resumed.append({"rid": rid, "tokens_before_eviction": len(before),
                        "prefix_equals_clean_run": True,
                        "tokens_after_resume": len(after),
                        "after_resume_equal_to_clean_run": same})
    untouched = [rid for rid in by_rid if rid not in snap]
    same_untouched = sum(by_rid[r].out == clean_out[r] for r in untouched)
    decode = [r for r in cal.rows if r["phase"] == "decode"]
    poisoned = [r for r in decode if r["seq"] is None]
    if len(poisoned) != 1 or cal.sink.stats()["n_dropped"] != 1:
        raise AssertionError(f"poisoned samples {poisoned}, sink "
                             f"{cal.sink.stats()}")
    slow_seqs = [r["seq"] for r in decode if 20 <= r["k"] < 30]
    slow = [e for e in cal.events if e.direction == "slow"
            and slow_seqs[0] <= e.seq <= slow_seqs[-1]]
    if not slow:
        raise AssertionError(f"the x3 slowdown raised no slow event: "
                             f"{cal.events_json()}")
    if len(snap) != a["slots"] or sup.evictions != a["slots"] or sup.shed:
        raise AssertionError(f"evictions {sup.evictions} ({sorted(snap)}), "
                             f"shed {len(sup.shed)}")
    report = sup.report(printer=lambda s: None)
    out = {"phase": "robust.serve", "ok": True, "arch": cfg.name,
           "dtype": cfg.param_dtype, "slots": a["slots"],
           "max_len": a["max_len"], "requests": a["requests"],
           "max_new": a["max_new"], "fault_plan": plan.describe(),
           "model": {"device": fitted.device,
                     "source": fitted.meta.get("source"),
                     "revision": fitted.meta.get("revision", 0)},
           "prefill": {"tokens": [B, S], "ms": prefill_ms,
                       "model_ms": fitted.predict(prefill_pv) * 1e3},
           "iterations": [[r["k"], r["measured_ms"], r["tracked_ms"],
                           r["model_ms"], r["cusum"]] for r in decode],
           "iteration_columns": ["k", "measured_ms", "tracked_ms",
                                 "model_ms", "cusum"],
           "poisoned_iteration": poisoned[0]["k"],
           "drift_events": cal.events_json(), "refits": cal.refits,
           "revision": cal.revision, "refit_errors": cal.refit_errors,
           "sink": cal.sink.stats(), "rls_samples": cal.rls.n_samples,
           "calib": cal.report_line(),
           "faults": inj.counts(), "evictions": sup.evictions,
           "shed": len(sup.shed), "completed": len(done),
           "supervisor": report, "iters": sup._iters,
           "decode_calls_total": int(server.state["pos"]),
           "resumed": resumed, "untouched_requests": len(untouched),
           "untouched_equal_to_clean_run": same_untouched,
           "clean_run_seconds": clean_s, "supervised_run_seconds": run_s,
           "launches": launched}
    emit(out)
    return launched


def robust_train_config():
    return dataclasses.replace(resume_config(get_arch(ARCH)),
                               optimizer=ROBUST_TRAIN_OPTIMIZER)


def robust_trainer(cfg, seed, ckpt_dir=None, **kw) -> Trainer:
    B, S = TRAIN_TOKENS
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                    seed=seed)
    # blocking saves: a fault at the step after a save must find that save
    # on disk (an async one may still be in flight; train.resume times the
    # async checkpointer)
    tc = TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=ROBUST_TRAIN_CKPT_EVERY,
                       keep_ckpts=2, seed=seed, save_on_exit=False,
                       async_ckpt=False, log_every=1000, **TRAIN_LR)
    return Trainer(cfg, dc, tc, device=DEV, **kw)


def phase_robust_train(reg_dir: str, seed: int):
    """``ROBUST_TRAIN_STEPS`` steps of ``robust_train_config()`` unsupervised,
    then under a ``Supervisor`` (checkpoints every
    ``ROBUST_TRAIN_CKPT_EVERY`` steps, an ``OnlineCalibrator`` scoped to
    train and warm-started from the fitted ``gpu-h100``, replans priced over
    ``ROBUST_REPLAN_DEVICES`` by the model of a copy of the calibrate
    phase's registry) through ``ROBUST_TRAIN_FAULTS``.  Fails unless the
    supervised history equals the unsupervised one step for step within
    ``TOL_REPLAY``, the corrupt save is quarantined and the resume falls
    back one save, the registry copy falls back to its previous revision,
    the compile cache rebuilds an entry equal to the one corrupted, and the
    poisoned sample is quarantined.  Returns the launch counts of the
    supervised run and the unsupervised history."""
    cfg = robust_train_config()
    B, S = TRAIN_TOKENS
    t0 = time.perf_counter()
    clean = robust_trainer(cfg, seed)
    want = clean.train(ROBUST_TRAIN_STEPS, on_metrics=quiet)
    clean_s = time.perf_counter() - t0
    del clean
    torch.cuda.empty_cache()

    spec = WorkloadSpec(phase="train", global_batch=B, seq_len=S,
                        name="train_live")
    fitted = registry.load_model(CALIB_DEVICE, reg_dir)
    predicted = predictor.predict_step(cfg, spec, TRAINER_PLAN, MESH1,
                                       fitted).seconds
    with tempfile.TemporaryDirectory(prefix="robust-") as tmp:
        ckpt, reg_copy, cache = (os.path.join(tmp, d)
                                 for d in ("ckpt", "registry", "cache"))
        shutil.copytree(reg_dir, reg_copy)
        # a second revision, so the corrupted file has one to fall back to
        _, rev = registry.register_revision(fitted, reg_copy,
                                            name=CALIB_DEVICE)
        # one program in a compile cache of the phase's own
        old_cache = os.environ.get("REPRO_COMPILE_CACHE")
        os.environ["REPRO_COMPILE_CACHE"] = cache
        key = exprops.program_key("robust.train", cfg.name, "train_live")
        build = functools.partial(predictor._step_pv_sym, cfg, spec)
        env = spec.env(cfg)
        try:
            before = exprops.load_or_build(key, build).score(env, fitted)
        finally:
            os.environ["REPRO_COMPILE_CACHE"] = old_cache
        plan = FaultPlan.parse(ROBUST_TRAIN_FAULTS, seed=seed)
        inj = FaultInjector(plan, ckpt_dir=ckpt, registry_dir=reg_copy,
                            registry_device=CALIB_DEVICE,
                            compile_cache_dir=cache)
        cal = RecordedCalibrator(fitted, device=CALIB_DEVICE, phase="train",
                                 registry_dir=reg_copy)
        fallbacks = registry._FALLBACKS.value(device=CALIB_DEVICE)
        sup = Supervisor(
            lambda mesh: robust_trainer(cfg, seed, ckpt, calibrator=cal,
                                        injector=inj,
                                        predicted_step_s=predicted),
            ROBUST_TRAIN_STEPS, cfg=cfg, workload=spec,
            n_devices=ROBUST_REPLAN_DEVICES, model=CALIB_DEVICE,
            registry_dir=reg_copy, injector=inj,
            backoff=BackoffPolicy(seed=seed))
        reset_launches()
        t0 = time.perf_counter()
        hist = sup.run()
        run_s = time.perf_counter() - t0
        launched = read_launches()
        report = sup.report(printer=lambda s: None)
        quarantined = sorted(os.listdir(os.path.join(ckpt, "quarantine"))) \
            if os.path.isdir(os.path.join(ckpt, "quarantine")) else []
        save = os.path.join(ckpt, f"step_{ROBUST_TRAIN_CKPT_EVERY:08d}")
        save_bytes = sum(os.path.getsize(os.path.join(save, f))
                         for f in os.listdir(save))
        fell_back = registry.load_model(CALIB_DEVICE, reg_copy)
        fallbacks = registry._FALLBACKS.value(device=CALIB_DEVICE) \
            - fallbacks
        corrupt_registry = os.path.exists(
            registry._model_path(reg_copy, CALIB_DEVICE) + ".corrupt")
        os.environ["REPRO_COMPILE_CACHE"] = cache
        errors = exprops.DISK_STATS["errors"]
        try:
            after = exprops.load_or_build(key, build).score(env, fitted)
        finally:
            os.environ["REPRO_COMPILE_CACHE"] = old_cache
        rebuilt = exprops.DISK_STATS["errors"] - errors
        del sup.trainer
    torch.cuda.empty_cache()
    per_step = train_launches_per_step(cfg, TRAIN_TOKENS[1])
    want_launches = {n: k * len(cal.rows) for n, k in per_step.items()}
    if launched != want_launches:
        raise AssertionError(f"robust.train launches {launched}, expected "
                             f"{want_launches}")
    if [h["step"] for h in hist] != [h["step"] for h in want]:
        raise AssertionError("the supervised run's steps differ")
    rel = [abs(h["loss"] - w["loss"]) / abs(w["loss"])
           for h, w in zip(hist, want)]
    checks = {
        "history_within_tol": max(rel) <= TOL_REPLAY,
        "one_recovery": len(sup.recoveries) == 1,
        "checkpoint_quarantined": quarantined == ["step_00000006"],
        "resumed_one_save_back": sup.steps_run == 6 + ROBUST_TRAIN_STEPS - 3,
        "registry_fell_back": corrupt_registry and fallbacks >= 1
        and fell_back.meta.get("revision", 0) == rev - 1,
        "compile_cache_rebuilt": rebuilt == 1
        and float(after) == float(before),
        "poison_quarantined": cal.sink.stats()["n_dropped"] == 1,
    }
    out = {"phase": "robust.train", "ok": all(checks.values()),
           "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "tokens": [B, S], "optimizer": cfg.optimizer,
           "reduced": {"n_layers": "2 of 28 (train.resume's cut)",
                       "optimizer": "adafactor in place of adamw: the "
                                    "call's 45 GiB of disk writes"},
           "fault_plan": plan.describe(), "checks": checks,
           "losses": [h["loss"] for h in hist],
           "losses_unsupervised": [w["loss"] for w in want],
           "rel_diff_max": max(rel), "tol": TOL_REPLAY,
           "step_ms": [h["time_s"] * 1e3 for h in hist],
           "predicted_step_ms": predicted * 1e3,
           "recoveries": [{"step": r.step, "cause": r.cause,
                           "action": r.action, "mttr_ms": r.mttr_s * 1e3,
                           "devices": r.n_devices, "detail": r.detail}
                          for r in sup.recoveries],
           "mesh": None if sup.mesh is None else dict(sup.mesh.shape),
           "steps_run": sup.steps_run, "quarantined": quarantined,
           "checkpoint_bytes": save_bytes,
           "registry_revision_served": fell_back.meta.get("revision", 0),
           "registry_revision_corrupted": rev,
           "registry_fallbacks": fallbacks, "compile_cache_errors": rebuilt,
           "samples": [[r["k"], r["measured_ms"], r["tracked_ms"],
                        r["model_ms"], r["cusum"]] for r in cal.rows],
           "drift_events": cal.events_json(), "refits": cal.refits,
           "refit_errors": cal.refit_errors, "sink": cal.sink.stats(),
           "calib": cal.report_line(), "supervisor": report,
           "faults": inj.counts(), "unsupervised_seconds": clean_s,
           "supervised_seconds": run_s, "launches": launched}
    emit(out)
    if not out["ok"]:
        raise AssertionError(f"robust.train: {checks}")
    return launched, want


def phase_robust_fleet(reg_dir: str, seed: int, want: list) -> dict:
    """``python -m repro_torch.launch fleet`` (``ROBUST_FLEET_ARGS``, host
    only, pools priced by ``reg_dir``'s models) twice in-process: the two
    placement histories must be byte for byte equal.  Then one
    ``TrainerJobRunner`` on the card (``robust_train_config()``, a save
    every ``ROBUST_TRAIN_CKPT_EVERY`` steps) migrated by a pool shrink at
    fleet step 4: its history must equal ``want`` (the unsupervised run of
    robust.train) within ``TOL_REPLAY``."""
    hist = []
    with tempfile.TemporaryDirectory(prefix="fleet-") as tmp:
        for i in range(2):
            path = os.path.join(tmp, f"history{i}.json")
            t0 = time.perf_counter()
            launch_main(ROBUST_FLEET_ARGS + ["--registry", reg_dir,
                                             "--history-json", path])
            hist.append((open(path, "rb").read(),
                         time.perf_counter() - t0))
        if hist[0][0] != hist[1][0]:
            raise AssertionError("the fleet's placement history differs "
                                 "between two runs")
        events = [e["event"] for e in json.loads(hist[0][0])]

        cfg = robust_train_config()
        B, S = TRAIN_TOKENS
        job = JobSpec(name="train", arch=ARCH, workload=WorkloadSpec(
            phase="train", global_batch=B, seq_len=S, name="train"),
            priority=5, min_devices=2, max_devices=2)
        manifest = Manifest(pools=[PoolSpec("a100", "gpu-a100", 2),
                                   PoolSpec("v5e", "tpu-v5e", 2)],
                            jobs=[job])
        allocator = FleetAllocator(manifest, registry_dir=reg_dir)
        assignment = allocator.allocate()
        home = assignment.placements["train"].pool
        ckpt = os.path.join(tmp, "ckpt")
        built = []

        def factory(job_spec, placement):
            built.append(placement.pool)
            return robust_trainer(cfg, seed, ckpt)

        sup = FleetSupervisor(
            allocator, assignment=assignment,
            injector=FaultInjector(FaultPlan.parse(
                f"pool_shrink@4:pool={home},k=2", seed=seed)),
            runner_factory=TrainerJobRunner.factory(
                factory, target=ROBUST_FLEET_STEPS))
        reset_launches()
        t0 = time.perf_counter()
        sup.run(ROBUST_FLEET_STEPS)
        run_s = time.perf_counter() - t0
        launched = read_launches()
        runner = sup.runners["train"]
        got = runner.history
        del runner.trainer
    torch.cuda.empty_cache()
    rel = [abs(h["loss"] - w["loss"]) / abs(w["loss"])
           for h, w in zip(got, want)]
    checks = {"histories_byte_equal": True,
              "migrated": sup.actions.get("migrate") == 1
              and len(built) == 2 and built[0] != built[1],
              "steps": [h["step"] for h in got]
              == list(range(ROBUST_FLEET_STEPS)),
              "history_within_tol": bool(rel) and max(rel) <= TOL_REPLAY}
    out = {"phase": "robust.fleet", "ok": all(checks.values()),
           "cli": " ".join(ROBUST_FLEET_ARGS), "events": events,
           "history_bytes": len(hist[0][0]),
           "cli_seconds": [h[1] for h in hist], "checks": checks,
           "pools": built, "losses": [h["loss"] for h in got],
           "rel_diff_max": max(rel) if rel else None, "tol": TOL_REPLAY,
           "migration_run_seconds": run_s, "launches": launched}
    emit(out)
    if not out["ok"]:
        raise AssertionError(f"robust.fleet: {checks}")
    return launched


def kernel_entry(name, source, replaces, launched, rows, cases, **extra):
    """One kernel of the ``kernels`` line: the first main-path shape's
    numbers at the top, every timed shape under ``shapes``."""
    total = sum(n for n in launched.values())
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": total,
            "launches_by_path": launched,
            **rows[0], **extra,
            "max_abs_err": max(r["max_abs_err"] for r in rows + cases),
            "max_abs_err_over_cases": max(c["max_abs_err"] for c in cases),
            "shapes": rows, "cases": cases}


def fa_extra(wg_ptxas: list) -> dict:
    """The flash_attention fields beyond the common ones: which kernel
    serves which type, and the bf16 kernel's registers and spills per
    instance (padded head width), from the build log."""
    return {"variants": {str(t).replace("torch.", ""): v
                         for t, v in VARIANT.items()},
            "ptxas": [{"head_dim_padded": int(m.group(1)) if m else None,
                       **{k: e[k] for k in ("registers", "spill_store_bytes",
                                            "spill_load_bytes")}}
                      for e in wg_ptxas
                      for m in [re.search(r"ILi(\d+)E", e["function"])]]}


def mm_extra(mm_ptx: list) -> dict:
    """The matmul fields beyond the common ones: the kernels and the
    registers and spills of each instance, from the build log."""
    return {"variants": {"16³ request": "paper16",
                         "128 request, f32": "fma128",
                         "128 request, bf16 TMA can read": "wgmma",
                         "128 request, other bf16": "fma128"},
            "ptxas": [{k: e[k] for k in e if k != "function"}
                      for e in mm_ptx]}


def ssd_extra(ss_ptxas: list) -> dict:
    """The ssd_scan fields beyond the common ones: the variant rule, and the
    registers and spills of every instance of both kernels, from the build
    log."""
    return {"variants": {"bf16 x, B, C; chunk 64/128/256 (256 in halves of "
                         "128); P, N multiples of 16 up to 128; "
                         "TMA-readable": "wgmma",
                         "anything else": "fma"},
            "ptxas": ss_ptxas}


def tr_extra(tr_ptx: list) -> dict:
    """The transpose fields beyond the common ones: the variant rule, and
    the registers and spills of every instance, from the build log."""
    return {"variants": {"block < 32; base, leading stride, M, N aligned to "
                         "one 16-byte access": "vec16",
                         "anything else": "scalar"},
            "ptxas": tr_ptx}


def emit_ssd_backward(gen) -> list:
    """The kernels line of the SSD backward at the training paths' shape
    (zamba2-2.7b; mamba2-370m's N of 128) -> its rows."""
    TB, TS = TRAIN_TOKENS
    rows = [phase_ssd_backward_main_shape(get_arch(a), TB, TS, gen)
            for a in (HYBRID, SSM)]
    line = {"phase": "kernels.ssd_backward.main_shape",
            "ok": all(r["ok"] for r in rows),
            "kernel": "ssd_scan_backward", "shapes": rows}
    emit(line)
    if not line["ok"]:
        raise AssertionError(f"the SSD backward kernels: {rows}")
    return rows


def kernel_only(args, smi) -> int:
    """``--only fa-cases|fa|ssd-cases|ssd|mm-cases|mm|tr-cases|tr``: the
    build, one kernel's case table, and (without ``-cases``) its timings at
    the main paths' shapes; no main path runs, so the last line says so."""
    with phase("build"):
        ptx = phase_build()
    if args.only == "dp":
        with phase("dp"):
            phase_dp(args.seed)
        return finish(args, smi, {"ok": True, "scope": f"--only {args.only}",
                                  "main_paths": "dp only"})
    if args.only == "gspmd":
        with phase("gspmd"):
            phase_gspmd(args.seed)
        return finish(args, smi, {"ok": True, "scope": f"--only {args.only}",
                                  "main_paths": "gspmd only"})
    if args.only in ("engines", "examples", "docs"):
        with phase(args.only):
            {"engines": phase_engines, "examples": phase_examples,
             "docs": phase_docs}[args.only]()
        return finish(args, smi, {"ok": True, "scope": f"--only {args.only}",
                                  "main_paths": f"{args.only} only"})
    if args.only == "train.ssd_chunk":
        cfg = get_arch(HYBRID)
        with phase(f"{cfg.name}:train.init"):
            trainer = phase_train_init(cfg, args.seed)
        with phase(f"{cfg.name}:train.ssd_chunk"):
            phase_train_ssd_chunk(cfg, trainer)
        return finish(args, smi, {"ok": True, "scope": f"--only {args.only}",
                                  "main_paths": "train.ssd_chunk only"})
    if args.only == "autotune":
        reset_launches()
        with phase("autotune"):
            phase_autotune()
        emit({"phase": "autotune.launches", "ok": True, **read_launches()})
        return finish(args, smi, {"ok": True, "scope": f"--only {args.only}",
                                  "main_paths": "not run"})
    gen = torch.Generator(DEV).manual_seed(args.seed)
    kernel = args.only.split("-")[0]
    cases = {"fa": ("kernels.cases", phase_kernel_cases),
             "ssd": ("kernels.ssd.cases", phase_ssd_cases),
             "mm": ("kernels.matmul.cases", phase_matmul_cases),
             "tr": ("kernels.transpose.cases", phase_transpose_cases)}
    name, fn = cases[kernel]
    with phase(name):
        fn(gen)
    if kernel == "fa":
        with phase("kernels.lse.cases"):
            phase_lse_cases(gen)
    if args.only == "fa":
        with phase("kernels.main_shape"):
            B, S = PREFILL_TOKENS
            TB, TS = TRAIN_TOKENS
            rows = [phase_kernel_main_shape(get_arch(a), B, S, gen)
                    for a in (ARCH, HYBRID, MOE, VLM, AUDIO)]
            rows += [phase_kernel_main_shape(get_arch(a), TB, TS, gen)
                     for a in (ARCH, HYBRID)]
            emit({"phase": "kernels.main_shape", "ok": True,
                  "kernel": "flash_attention", "shapes": rows,
                  **fa_extra(ptx["flash_attention"])})
    elif args.only == "ssd":
        with phase("kernels.ssd.main_shape"):
            B, S = PREFILL_TOKENS
            TB, TS = TRAIN_TOKENS
            emit({"phase": "kernels.ssd.main_shape", "ok": True,
                  "kernel": "ssd_scan",
                  "shapes": [phase_ssd_main_shape(get_arch(a), B, S, gen)
                             for a in (HYBRID, SSM)]
                  + [phase_ssd_main_shape(get_arch(HYBRID), TB, TS, gen,
                                          train=True)],
                  **ssd_extra(ptx["ssd_scan"])})
        with phase("kernels.ssd_backward.main_shape"):
            emit_ssd_backward(gen)
    elif args.only == "mm":
        with phase("kernels.matmul.main_shape"):
            emit({"phase": "kernels.matmul.main_shape", "ok": True,
                  "kernel": "matmul", "shapes": phase_matmul_main_shape(gen),
                  **mm_extra(ptx["matmul"])})
    elif args.only == "tr":
        with phase("kernels.transpose.main_shape"):
            emit({"phase": "kernels.transpose.main_shape", "ok": True,
                  "kernel": "transpose",
                  "shapes": phase_transpose_main_shape(gen),
                  **tr_extra(ptx["transpose"])})
    return finish(args, smi, {"ok": True, "scope": f"--only {args.only}",
                              "main_paths": "not run"})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one prefill step and a few decode "
                         "iterations of each main path, and the multi-op "
                         "calibration cases, with torch.profiler")
    ap.add_argument("--out", default=None,
                    help="also write every phase line to this JSON file")
    ap.add_argument("--only", choices=("fa-cases", "fa", "ssd-cases", "ssd",
                                       "mm-cases", "mm", "tr-cases", "tr",
                                       "autotune", "dp", "gspmd",
                                       "engines", "examples", "docs",
                                       "train.ssd_chunk"),
                    default=None,
                    help="build, then only the flash-attention (fa), SSD-scan "
                         "(ssd), matmul (mm) or transpose (tr) cases (-cases) "
                         "or the cases and timings, or the autotune phase "
                         "under the analytic seed alone, or the "
                         "data-parallel phase (dp) or the sharded steps and "
                         "the dry run (gspmd), or the engine benchmarks "
                         "(engines), the examples (examples) or the "
                         "documents' commands (docs) alone, or zamba2's "
                         "training step by SSD chunk (train.ssd_chunk)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script runs on a GPU only", file=sys.stderr)
        return 1
    # a compile cache of the run's own: no step program of an earlier run is
    # read, so the predict phase's build times are cold
    with tempfile.TemporaryDirectory(prefix="exprops-") as cache_dir:
        os.environ["REPRO_COMPILE_CACHE"] = cache_dir
        return run(args, cache_dir)


def run(args, cache_dir: str) -> int:
    t_start = time.perf_counter()
    with phase("device"):
        smi = phase_device()
    if args.only:
        return kernel_only(args, smi)
    with phase("build"):
        ptx = phase_build()

    gen = torch.Generator(DEV).manual_seed(args.seed)
    dense, hybrid, pure = get_arch(ARCH), get_arch(HYBRID), get_arch(SSM)
    B, S = PREFILL_TOKENS

    with phase("kernels.cases"):
        fa_cases = phase_kernel_cases(gen)
    with phase("kernels.lse.cases"):
        lse_cases = phase_lse_cases(gen)
    with phase("kernels.ssd.cases"):
        ssd_cases = phase_ssd_cases(gen)

    # the main paths; each resets the launch counts just before it runs and
    # reads them just after
    mixtral = dataclasses.replace(get_arch(MOE), n_layers=MOE_LAYERS)
    vlm, audio = get_arch(VLM), get_arch(AUDIO)
    launched = {ARCH: drive_path(dense, args, serve=True, decode_layers=2),
                HYBRID: drive_path(hybrid, args, serve=True,
                                   decode_layers=hybrid.hybrid.attn_every),
                SSM: drive_path(pure, args, serve=False, decode_layers=2),
                MOE: drive_path(mixtral, args, serve=True, decode_layers=2,
                                f32_layers=MOE_F32_LAYERS),
                VLM: drive_path(vlm, args, serve=True, decode_layers=2),
                # the server serves one codebook, as the reference's: the
                # audio path is prefill, then decode through the steps
                AUDIO: drive_path(audio, args, serve=False, decode_layers=2,
                                  n_steps=PREFILL_STEPS)}
    # the training paths, each with its own reset and read of the counts
    for cfg in (dense, hybrid):
        launched[f"{cfg.name}:train"] = drive_train(cfg, args)
    # data-parallel training on a one-rank NCCL group (its own reset and
    # read of the counts)
    torch.cuda.empty_cache()
    with phase("dp"):
        launched["dp"] = phase_dp(args.seed)
    torch.cuda.empty_cache()
    # the DTensor-sharded steps on a one-rank NCCL group, then the dry run
    # (its own reset and read of the counts)
    with phase("gspmd"):
        launched["gspmd"] = phase_gspmd(args.seed)
    torch.cuda.empty_cache()
    with phase("roofline"):
        phase_roofline()

    TB, TS = TRAIN_TOKENS
    with phase("kernels.main_shape"):
        fa_rows = [phase_kernel_main_shape(cfg, b, s, gen)
                   for b, s in ((B, S), (TB, TS)) for cfg in (dense, hybrid)]
        fa_rows += [phase_kernel_main_shape(cfg, B, S, gen)
                    for cfg in (mixtral, vlm, audio)]
        emit({"phase": "kernels.main_shape", "ok": True,
              "kernel": "flash_attention", "shapes": fa_rows})
    torch.cuda.empty_cache()
    with phase("kernels.ssd.main_shape"):
        ssd_rows = [phase_ssd_main_shape(cfg, B, S, gen)
                    for cfg in (hybrid, pure)] \
            + [phase_ssd_main_shape(hybrid, TB, TS, gen, train=True)]
        emit({"phase": "kernels.ssd.main_shape", "ok": True,
              "kernel": "ssd_scan", "shapes": ssd_rows,
              **ssd_extra(ptx["ssd_scan"])})
    torch.cuda.empty_cache()
    with phase("kernels.ssd_backward.main_shape"):
        bwd_rows = emit_ssd_backward(gen)
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
        with phase("table2"):
            phase_table2(reg_dir)
        # the step predictor: the model just fitted, loaded back by name,
        # against every path measured above
        with phase("predict"):
            phase_predict(reg_dir, cache_dir)
        # whole-step validation of the fit on every architecture (its own
        # reset and read of the counts)
        with phase("validate"):
            launched["validate"] = phase_validate(reg_dir)
        # the autotuner: every candidate of every grid launched, with the
        # counts set to 0 just before it and read just after
        torch.cuda.empty_cache()
        reset_launches()
        with phase("autotune"):
            phase_autotune(reg_dir)
        launched["autotune"] = read_launches()
        with phase("explain"):
            phase_explain(reg_dir)
        # online calibration and supervised recovery: each phase sets the
        # launch counts to 0 just before its main path and reads them just
        # after; all three read the model fitted above
        torch.cuda.empty_cache()
        with phase("robust.serve"):
            launched["robust.serve"] = phase_robust_serve(reg_dir, args.seed)
        torch.cuda.empty_cache()
        with phase("robust.train"):
            launched["robust.train"], unsupervised = phase_robust_train(
                reg_dir, args.seed)
        torch.cuda.empty_cache()
        with phase("robust.fleet"):
            launched["robust.fleet"] = phase_robust_fleet(
                reg_dir, args.seed, unsupervised)
    torch.cuda.empty_cache()
    # model-scored serving: the same requests under FIFO and the model,
    # measured beside the simulation (the decode path launches no kernel)
    reset_launches()
    with phase("admission"):
        phase_admission(args.seed)
    launched["admission"] = read_launches()
    torch.cuda.empty_cache()
    with phase("autoshard"):
        phase_autoshard()
    # the planner's engine benchmarks in processes of their own, then every
    # example on the card (each with its own reset and read of the counts)
    with phase("engines"):
        phase_engines()
    with phase("examples"):
        launched["examples"] = phase_examples()
    torch.cuda.empty_cache()
    # every card form of the documents' commands, each in a process of its
    # own (what those processes launch is not counted here), beside the
    # kernel roofline, whose process prices fake tensors on the host and
    # times nothing on the card
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        docs = pool.submit(docs_line)
        with phase("kernel_roofline"):
            phase_kernel_roofline()
        with phase("docs"):
            emit(docs.result())
    if args.profile:
        with phase("calibrate.profile"):
            phase_calibration_profile(args.seed)

    with phase("kernels.matmul.main_shape"):
        mm_rows = phase_matmul_main_shape(gen)
        emit({"phase": "kernels.matmul.main_shape", "ok": True,
              "kernel": "matmul", "shapes": mm_rows})
    torch.cuda.empty_cache()
    with phase("kernels.transpose.main_shape"):
        tr_rows = phase_transpose_main_shape(gen)
        emit({"phase": "kernels.transpose.main_shape", "ok": True,
              "kernel": "transpose", "shapes": tr_rows})

    kernels = {"kernels": [
        kernel_entry("flash_attention",
                     "src/repro_torch/kernels/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:116",
                     {a: n["flash_attention"] for a, n in launched.items()},
                     fa_rows, fa_cases, lse_cases=lse_cases,
                     **fa_extra(ptx["flash_attention"])),
        kernel_entry("ssd_scan", "src/repro_torch/kernels/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan.py:97",
                     {a: n["ssd_scan"] for a, n in launched.items()},
                     ssd_rows, ssd_cases, **ssd_extra(ptx["ssd_scan"])),
        kernel_entry("matmul", "src/repro_torch/kernels/csrc/matmul.cu",
                     "src/repro/kernels/matmul.py:50",
                     {a: n["matmul"] for a, n in launched.items()},
                     mm_rows, mm_cases, **mm_extra(ptx["matmul"])),
        kernel_entry("transpose",
                     "src/repro_torch/kernels/csrc/transpose.cu",
                     "src/repro/kernels/transpose.py:30",
                     {a: n["transpose"] for a, n in launched.items()},
                     tr_rows, tr_cases, **tr_extra(ptx["transpose"])),
        {**bwd_rows[0], "name": "ssd_scan_backward", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
         "replaces": "models/ssm._SSDScan.backward's recompute of "
                     "ssd_scan_reference (the reference has no backward "
                     "kernel)",
         "launches": sum(n["ssd_scan_backward"] for n in launched.values()),
         "launches_by_path": {a: n["ssd_scan_backward"]
                              for a, n in launched.items()},
         "shapes": bwd_rows},
    ]}
    for k in kernels["kernels"]:
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} was never launched on a "
                                 "main path")

    total = round(time.perf_counter() - t_start, 1)
    emit({"phase": "total", "ok": True, "seconds": total})
    emit(kernels)
    return finish(args, smi, {"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


def finish(args, smi: str, last: dict) -> int:
    """The card's name and power limit, then the last line; with ``--out``
    every phase line also goes to that file."""
    print(smi, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"nvidia_smi": smi, "lines": LINES, "last": last}, f,
                      indent=1)
    print(json.dumps(last), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
