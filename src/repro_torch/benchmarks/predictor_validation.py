"""Whole-training-step validation of the fitted model on the port's device
(the counterpart of the reference's ``benchmarks/predictor_validation.py``).

The paper predicts single kernels; the framework extends the same linear
machinery to whole training steps.  For every architecture of the registry
this builds the training step (``runtime/steps.make_train_step``, AdamW
as the reference does), extracts its property vector from the step's ATen
graph (``core/extract.extract_graph``, the counterpart of the reference's
``extract_jaxpr``), predicts its time with the *measurement-kernel-fitted*
model of ``paper_table1`` (no step-level refit), measures it (8 runs, drop
2) and reports the geomean relative error, raw and after a one-point
calibration on smollm-360m.

Each row also names the keys the fit leaves unpriced (``unpriced``: a key
with a count the fitted model has no weight for, and the count): the
library is f32 throughout, as the reference's, so a bf16 step's ``mxu:16``
and 16-bit memory keys go unpriced and its error column reads against
that.  ``extract_warnings`` lists what the graph walk could not see.

Sizes: ``--scale tiny`` / ``cpu`` run ``ArchConfig.reduced()`` at ``-B`` ×
``-S`` (the reference's reduced sizes); ``--scale gpu`` runs each
architecture at full width, batch 2 × 2048, its depth cut only as far as
the card forces: the most layers whose ``predictor.estimate_peak_bytes``
(AdamW states, one card) stays under 0.75 × the card's memory.  That
estimate runs 1.5–20 % under the card's peaks, hence the margin.  An
architecture of which not one layer fits is a ``skip`` row with its
reckoned bytes.  ``layers`` and ``layers_run`` record each cut.

    PYTHONPATH=src python -m repro_torch.benchmarks.predictor_validation \\
        --scale gpu                                      # on the card
    PYTHONPATH=src python -m repro_torch.benchmarks.predictor_validation \\
        --device cpu --scale tiny -B 2 -S 64 --registry /tmp/reg
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import multiprocessing as mp
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.benchmarks import paper_table1
from repro_torch.configs.registry import ARCHS
from repro_torch.core import extract, measure, mkernels, predictor
from repro_torch.core.model import LinearCostModel, geomean, relative_error
from repro_torch.core.workload import WorkloadSpec
from repro_torch.distributed.plan import Plan
from repro_torch.optim import optimizers as opt
from repro_torch.runtime import steps

OUT_DIR = paper_table1.OUT_DIR
#: the card's scale: batch × sequence of every step, and the share of the
#: card's memory the estimated peak may take
GPU_TOKENS = (2, 2048)
MEMORY_SHARE = 0.75
CALIBRATION_ARCH = "smollm-360m"


def batch_for(cfg, B: int, S: int, device, seed: int = 1
              ) -> Dict[str, torch.Tensor]:
    """Tokens and labels from ``seed`` (and the codebooks' or vision
    embeddings' parts of the batch), on ``device``."""
    rng = np.random.default_rng(seed)
    shp = (B, S, cfg.n_input_codebooks) if cfg.n_input_codebooks > 1 \
        else (B, S)
    b = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, shp)).to(
        device=device, dtype=torch.int64) for k in ("tokens", "labels")}
    if cfg.vision_tokens:
        b["vision_embeds"] = torch.full(
            (B, cfg.vision_tokens, cfg.d_model), 0.01, device=device,
            dtype=getattr(torch, cfg.compute_dtype))
        b["loss_mask"] = torch.ones((B, S), device=device)
    return b


def reckoned_bytes(cfg, B: int, S: int) -> float:
    """``estimate_peak_bytes`` of one card training ``cfg`` at B × S under
    AdamW (the step's optimizer here, whatever the config trains with)."""
    spec = WorkloadSpec(phase="train", global_batch=B, seq_len=S)
    return predictor.estimate_peak_bytes(
        dataclasses.replace(cfg, optimizer="adamw"), spec, Plan(dp_axes=()),
        {"data": 1})


def fit_depth(cfg, B: int, S: int, budget: float) -> Optional[int]:
    """The most layers (≤ ``cfg.n_layers``) whose reckoned peak fits
    ``budget``; None when not one does."""
    step = cfg.hybrid.attn_every if cfg.family == "hybrid" else 1
    for n in range(cfg.n_layers, 0, -step):
        if reckoned_bytes(dataclasses.replace(cfg, n_layers=n), B,
                          S) <= budget:
            return n
    return None


@contextlib.contextmanager
def _bound(model: torch.nn.Module, params: Dict[str, torch.Tensor]):
    """``model`` with ``params`` in the place of its parameters."""
    saved = {}
    for n, t in params.items():
        mod, _, leaf = n.rpartition(".")
        owner = model.get_submodule(mod)
        saved[n] = (owner, leaf, owner._parameters[leaf])
        owner._parameters[leaf] = t
    try:
        yield model
    finally:
        for owner, leaf, p in saved.values():
            owner._parameters[leaf] = p


def step_properties(cfg, optimizer, state: steps.TrainState,
                    batch: Dict[str, torch.Tensor]):
    """The property vector of one training step and the extraction's
    warnings.  The step is traced as a function of the parameters, the
    optimizer state and the batch (the model's parameters are bound to the
    traced ones), so that nothing of ``state`` is touched."""
    step_fn = steps.make_train_step(cfg, optimizer)
    model = state.params
    trains = steps.trainable(model)
    warnings: list = []

    def fn(params, opt_state, batch):
        params = {n: p.detach().requires_grad_(n in trains)
                  for n, p in params.items()}
        with _bound(model, params):
            _, metrics = step_fn(steps.TrainState(model, opt_state,
                                                  state.step), batch)
        return metrics["loss"], metrics["grad_norm"]

    pv = extract.extract_graph(fn, dict(model.named_parameters()),
                               state.opt_state, batch, warnings=warnings)
    return pv, sorted(set(warnings))


def step_flops(pv) -> float:
    """Matrix and vector flops of a property vector."""
    return float(sum(v for k, v in pv.items()
                     if k.startswith(("mxu:", "flop:"))))


def step_config(name: str, scale: str, B: int, S: int,
                device: str):
    """-> (the configuration the step runs, or None, and the skip row)."""
    full = ARCHS[name]
    if scale != "gpu":
        return full.reduced(), None
    budget = MEMORY_SHARE * torch.cuda.get_device_properties(
        torch.device(device)).total_memory
    n = fit_depth(full, B, S, budget)
    if n is None:
        return None, {
            "arch": name, "status": "skip", "layers": full.n_layers,
            "layers_run": 0,
            "reckoned_bytes": reckoned_bytes(
                dataclasses.replace(full, n_layers=1), B, S),
            "budget_bytes": budget,
            "why": "one layer with its embedding and head does not fit the "
                   "card under AdamW"}
    return dataclasses.replace(full, n_layers=n), None


def traced_properties(cfg, B: int, S: int):
    """-> (property vector, warnings) of ``cfg``'s AdamW training step at B
    × S, traced from a model on ``meta`` (nothing allocated: the trace runs
    on stand-ins of the same shapes and types as the card's)."""
    from repro_torch.launch.specs import param_specs
    optimizer = opt.get_optimizer("adamw")
    model = param_specs(cfg)
    state = steps.TrainState(
        model, optimizer.init(dict(model.named_parameters())), 0)
    pv, warnings = step_properties(cfg, optimizer, state,
                                   batch_for(cfg, B, S, "cpu"))
    return dict(pv), warnings


def timed_step(cfg, device: str, B: int, S: int, runs: int = 8,
               drop: int = 2) -> float:
    """Seconds of one AdamW training step of ``cfg`` on ``device`` (the
    minimum of ``runs`` after ``drop``)."""
    optimizer = opt.get_optimizer("adamw")
    state = steps.init_train_state(
        cfg, torch.Generator(device).manual_seed(0), optimizer,
        device=device)
    batch = batch_for(cfg, B, S, device)
    step_fn = steps.make_train_step(cfg, optimizer)
    tr = measure.time_kernel(lambda: step_fn(state, batch)[1]["loss"],
                             runs=runs, drop=drop)
    del state, batch, step_fn
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return tr.min_s


def row_for(name: str, cfg, layers: int, model: LinearCostModel, pv,
            warnings, seconds: float) -> Dict:
    """One validated row; ``layers`` the architecture's depth before the
    cut."""
    pred = model.predict(pv)
    return {"arch": name, "status": "ok", "predicted_ms": pred * 1e3,
            "actual_ms": seconds * 1e3,
            "rel_err": relative_error(pred, seconds),
            "layers": layers,
            "layers_run": cfg.n_layers, "flops": step_flops(pv),
            "unpriced": {k: float(v) for k, v in sorted(pv.items())
                         if v and k not in model.keys},
            "extract_warnings": warnings}


def run(scale: str = "gpu", B: Optional[int] = None, S: Optional[int] = None,
        device: str = "cuda", out: str = OUT_DIR,
        registry: Optional[str] = None, archs=None, trace_workers: int = 0,
        verbose: bool = True) -> Dict:
    """Every row, then the geomeans.  ``trace_workers`` > 0 traces the
    steps in that many processes of their own while the device times them
    (the traces are host work on stand-ins; the timings do not wait for
    them)."""
    if B is None or S is None:
        B, S = GPU_TOKENS if scale == "gpu" else (4, 512)
    name = paper_table1.model_name(device, scale)
    path = paper_table1.model_path(out, name, scale)
    if not os.path.exists(path):
        paper_table1.run(scale=scale, device=device, out=out,
                         registry=registry, verbose=False)
    model = LinearCostModel.load(path)

    names = sorted(archs or ARCHS)
    cfgs = {n: step_config(n, scale, B, S, device) for n in names}
    pool, traces = None, {}
    if trace_workers > 0:
        pool = ProcessPoolExecutor(trace_workers,
                                   mp_context=mp.get_context("spawn"))
        traces = {n: pool.submit(traced_properties, c, B, S)
                  for n, (c, _) in cfgs.items() if c is not None}
    rows = []
    try:
        for arch in names:
            cfg, skip = cfgs[arch]
            if cfg is None:
                rows.append(skip)
                if verbose:
                    print(f"{arch:<18} skip: {skip['why']} "
                          f"({skip['reckoned_bytes'] / 1e9:.1f} GB)")
                continue
            if pool is None:
                pv, warnings = traced_properties(cfg, B, S)
                seconds = timed_step(cfg, device, B, S)
            else:
                seconds = timed_step(cfg, device, B, S)
                pv, warnings = traces[arch].result()
            layers = ARCHS[arch].n_layers if scale == "gpu" \
                else cfg.n_layers
            r = row_for(arch, cfg, layers, model, pv, warnings, seconds)
            rows.append(r)
            if verbose:
                print(f"{arch:<18} pred={r['predicted_ms']:9.2f}ms "
                      f"act={r['actual_ms']:9.2f}ms err={r['rel_err']:.2f} "
                      f"layers {r['layers_run']}/{r['layers']}")
    finally:
        if pool is not None:
            pool.shutdown(cancel_futures=True)
    ok = [r for r in rows if r["status"] == "ok"]
    g = geomean(r["rel_err"] for r in ok)

    # one-point calibration: a single whole-step measurement (smollm, the
    # smallest architecture) scales every other prediction
    cal_row = next(r for r in ok if r["arch"] == CALIBRATION_ARCH)
    k = cal_row["actual_ms"] / cal_row["predicted_ms"]
    cal_errs = []
    for r in ok:
        if r["arch"] == cal_row["arch"]:
            continue
        r["calibrated_ms"] = r["predicted_ms"] * k
        r["cal_rel_err"] = relative_error(r["calibrated_ms"], r["actual_ms"])
        cal_errs.append(r["cal_rel_err"])
    g_cal = geomean(cal_errs)
    if verbose:
        print(f"\nwhole-step geomean rel |err| over {len(ok)} archs: "
              f"{g:.3f} raw; {g_cal:.3f} after ONE-POINT calibration "
              f"(factor {k:.2f}x from {CALIBRATION_ARCH})")
    result = {"rows": rows, "geomean_rel_err": g,
              "geomean_rel_err_calibrated": g_cal,
              "calibration_factor": k, "B": B, "S": S,
              "device": model.device, "scale": scale}
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "torch_predictor_validation.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", default="gpu", choices=mkernels.SCALES)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("-B", type=int, default=None)
    ap.add_argument("-S", type=int, default=None)
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--registry", default=None)
    ap.add_argument("--trace-workers", type=int, default=0,
                    help="trace the steps in this many processes while the "
                         "device times them (default: in this process)")
    a = ap.parse_args(argv)
    return run(scale=a.scale, B=a.B, S=a.S, device=a.device, out=a.out,
               registry=a.registry, trace_workers=a.trace_workers)


if __name__ == "__main__":
    main()
