"""Cost-model-guided block-size autotuning — the paper's §6.2 payoff
("select the optimal set of kernel configurations") at kernel granularity.

For a kernel family (``core.kernelmodel.KERNELS``) and a concrete problem
shape, the tuner:

  1. enumerates the candidate grid — the tiles the CUDA sources build for
     this shape, type and layout (their Python mirrors; nothing is
     compiled), filtered by a block's shared memory (``kSmemLimit``);
  2. builds the kernel's symbolic property vector with the block sizes left
     as ``symcount`` variables, once per CUDA kernel (``variant``) that the
     grid reaches, compiles it into a fused basis program, and evaluates
     every candidate of that kernel as numpy arrays — no per-point
     tree-walks;
  3. scores every candidate through a ``LinearCostModel`` (an in-memory
     model, a registry device name like ``"gpu-h100"``, or None for the
     analytic v5e seed, as in the reference) as weighted sums of property
     arrays.

A copy of the reference's ``kernels/autotune.py``.  Every function takes a
``KernelModel`` in place of a kernel name, and the workload-level ones a
registry (``kernels=``): ``core.kernelmodel.PALLAS_KERNELS``, the
reference's power-of-two grids under a v5e core's VMEM, gives the
reference's answers, which is how the parity tests hold this module to it.

``best_block_sizes`` results are memoized per (kernel, shape, model-name,
registry state), so ``block_sizes="auto"`` kernel calls (see
``repro_torch.kernels.ops``) pay the sweep once per shape.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import kernelmodel
from repro_torch.core.model import LinearCostModel
from repro_torch.core.symcount import evaluate_vector


def _resolve_model(model) -> LinearCostModel:
    from repro_torch.core import predictor  # None | registry name | model
    return predictor.resolve_model(model)


# ---------------------------------------------------------------------------
# Candidate enumeration
# ---------------------------------------------------------------------------


def candidate_configs(kernel, shape: Mapping[str, int],
                      budget: Optional[float] = None
                      ) -> List[Dict[str, int]]:
    """Valid block-size candidates for ``kernel`` at ``shape``: the
    kernel model's grid, minus configurations whose on-chip footprint
    exceeds the budget (default the kernel model's: a block's shared memory
    for the CUDA registry, 75% of a v5e core's 16 MiB for the Pallas
    one)."""
    km = kernelmodel.get(kernel)
    if budget is None:
        budget = km.budget
    cands = km.candidates(shape)
    ok = [c for c in cands if km.footprint(shape, c) <= budget]
    if not ok:  # nothing fits the budget: keep the smallest footprint
        ok = [min(cands, key=lambda c: km.footprint(shape, c))]
    return ok


# ---------------------------------------------------------------------------
# Scoring
# ---------------------------------------------------------------------------


# Bounded memo (LRU, like predictor._STEP_PV_CACHE): keys are the kernel
# model, the *sorted* shape items and the variant, so equal shapes hit
# regardless of caller dict order, and old shapes evict instead of
# accumulating.
@functools.lru_cache(maxsize=128)
def _fused_program(km: kernelmodel.KernelModel,
                   shape_items: Tuple[Tuple[str, object], ...],
                   variant: Optional[str]):
    from repro_torch.core import exprops
    dk = exprops.program_key("kernel", km.schedule, km.name, variant,
                             shape_items)
    return exprops.load_or_build(
        dk, lambda: km.vector(dict(shape_items), km.symbolic_blocks(),
                              variant))


def _by_variant(km, shape, configs) -> Dict[Optional[str], List[int]]:
    """Candidate indices grouped by the kernel that runs them, in order of
    first appearance."""
    groups: Dict[Optional[str], List[int]] = {}
    for i, c in enumerate(configs):
        groups.setdefault(km.variant(shape, c), []).append(i)
    return groups


def score_configs(kernel, shape: Mapping[str, int],
                  configs: Sequence[Mapping[str, int]],
                  model=None) -> np.ndarray:
    """Predicted seconds for every candidate — the fused fast path.

    The kernel's property vector (shape baked in as constants, block sizes
    free) lowers to one basis program per variant (``core.exprops``:
    canonicalized, cross-property CSE'd, memoized per shape in memory and
    on disk); the model's weights fold through the coefficient matrix once,
    and each variant's candidates score as a single GEMV.
    """
    from repro_torch.core import exprops
    km = kernelmodel.get(kernel)
    model = _resolve_model(model)
    items = tuple(sorted(shape.items()))
    out = np.empty(len(configs), dtype=np.float64)
    for variant, idx in _by_variant(km, shape, configs).items():
        prog = _fused_program(km, items, variant)
        env = {b: np.asarray([configs[i][b] for i in idx], dtype=np.int64)
               for b in km.block_params}
        out[idx] = exprops.score_cells(prog, env, len(idx), model)
    return out


def score_configs_interpreted(kernel, shape: Mapping[str, int],
                              configs: Sequence[Mapping[str, int]],
                              model=None) -> np.ndarray:
    """Reference scorer: per-point ``Expr.eval`` + ``model.predict``.
    Semantically identical to ``score_configs``; kept as the oracle the
    compiled path is tested (and benchmarked) against."""
    km = kernelmodel.get(kernel)
    model = _resolve_model(model)
    out = np.empty(len(configs), dtype=np.float64)
    for i, c in enumerate(configs):
        pv = km.vector(shape, c, km.variant(shape, c))
        out[i] = model.predict(evaluate_vector(pv, {}))
    return out


def rank_block_sizes(kernel, shape: Mapping[str, int], model=None,
                     configs: Optional[Sequence[Mapping[str, int]]] = None
                     ) -> List[Tuple[float, Dict[str, int]]]:
    """All candidates sorted by predicted time (ascending)."""
    if configs is None:
        configs = candidate_configs(kernel, shape)
    secs = score_configs(kernel, shape, configs, model)
    order = np.argsort(secs, kind="stable")
    return [(float(secs[i]), dict(configs[i])) for i in order]


# ---------------------------------------------------------------------------
# Public entry point (+ memo for "auto" kernel calls)
# ---------------------------------------------------------------------------


# Bounded LRU memo; the registry fingerprint ``_stamp`` is part of the key
# so recalibration invalidates block choices tuned against a stale model.
@functools.lru_cache(maxsize=128)
def _best_cached(km: kernelmodel.KernelModel,
                 shape_items: Tuple[Tuple[str, object], ...],
                 model_name: Optional[str],
                 _stamp) -> Tuple[Tuple[str, int], ...]:
    shape = dict(shape_items)
    configs = candidate_configs(km, shape)
    if len(configs) == 1:  # one tile (bf16 attention): nothing to score
        return tuple(sorted(configs[0].items()))
    ranked = rank_block_sizes(km, shape, model_name, configs)
    best = ranked[0][1]
    return tuple(sorted(best.items()))


def best_block_sizes(kernel, shape: Mapping[str, int],
                     model=None) -> Dict[str, int]:
    """Model-chosen block sizes for ``kernel`` at ``shape``.

    ``model`` is anything ``core.predictor.resolve_model`` accepts: None
    (analytic v5e seed), a registry device name (fitted model shadows the
    analytic seed of the same name), or an in-memory ``LinearCostModel``.
    """
    km = kernelmodel.get(kernel)
    if model is None or isinstance(model, str):
        # stamp the registry state into the key: a recalibration (or a
        # registry-dir redirect) must invalidate block choices tuned
        # against the superseded fitted model
        stamp = None
        if isinstance(model, str):
            from repro_torch.calibration import registry
            stamp = registry.fingerprint(model)
        items = tuple(sorted(shape.items()))
        return dict(_best_cached(km, items, model, stamp))
    return rank_block_sizes(km, shape, model)[0][1]


# ---------------------------------------------------------------------------
# Workload-level tuning — a WorkloadSpec names the step, this derives the
# per-kernel problem shapes
# ---------------------------------------------------------------------------


def workload_kernel_shapes(cfg, workload, *, dp: int = 1, tp: int = 1,
                           microbatches: int = 1
                           ) -> Dict[str, Dict[str, object]]:
    """The dominant kernels' concrete *per-device* problem shapes for one
    step of ``cfg`` under ``workload`` (a ``repro_torch.core.workload``
    ``WorkloadLike``), sharded ``dp`` × ``tp`` ways with ``microbatches``
    grad-accumulation chunks.

    Decode steps tune only the per-token matmul (its cache-streaming
    attention / recurrent update has no kernel here); train/prefill add
    flash-attention and/or ssd_scan per the config family.
    """
    from repro_torch.core import workload as wl
    spec = wl.as_spec(workload)
    bits = 16 if "16" in cfg.compute_dtype else 32
    if spec.phase == "decode":
        rows = spec.global_batch if spec.active_slots is None \
            else spec.active_slots
        tok = max((rows * spec.spec_len) // dp, 1)
        b_dev = tok
    else:
        b_dev = max(spec.global_batch // (dp * max(microbatches, 1)), 1)
        tok = b_dev * spec.seq_len

    out: Dict[str, Dict[str, object]] = {}
    if cfg.d_ff:
        out["matmul"] = {"M": tok, "N": max(cfg.d_ff // tp, 1),
                         "K": cfg.d_model, "bits": bits}
    if cfg.n_heads and spec.phase != "decode":
        out["flash_attention"] = {
            "B": b_dev, "H": max(cfg.n_heads // tp, 1),
            "KVH": max(cfg.n_kv_heads // tp, 1),
            "Sq": spec.seq_len, "Skv": spec.seq_len,
            "dh": cfg.head_dim_, "causal": True,
            "window": cfg.sliding_window, "bits": bits}
    if cfg.ssm is not None and spec.phase != "decode":
        out["ssd_scan"] = {
            "Bz": b_dev, "H": max(cfg.ssm_heads // tp, 1),
            "L": spec.seq_len, "P": cfg.ssm.head_dim,
            "N": cfg.ssm.d_state, "bits": bits}
    return out


def best_blocks_for_workload(
        cfg, workload, model=None, *, dp: int = 1, tp: int = 1,
        microbatches: int = 1,
        kernels: Optional[Mapping[str, kernelmodel.KernelModel]] = None
) -> Dict[str, Dict[str, int]]:
    """Model-chosen block sizes for every dominant kernel of one step of
    ``cfg`` under ``workload`` — ``workload_kernel_shapes`` fed through
    ``best_block_sizes`` kernel by kernel, over ``kernels`` (default the
    CUDA registry ``kernelmodel.KERNELS``)."""
    return {kern: best_block_sizes(kernelmodel.get(kern, kernels), shape,
                                   model)
            for kern, shape in workload_kernel_shapes(
                cfg, workload, dp=dp, tp=tp,
                microbatches=microbatches).items()}
