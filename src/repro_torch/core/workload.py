"""One ``WorkloadSpec`` — the single currency every prediction consumer
speaks.

The paper's premise is ONE symbolic counting mechanism feeding ONE linear
model; what fragments that in practice is not the model but the *workload
description*: a trainer, a plan search, a block-size autotuner and a decode
server each re-deriving "what a step is" from ad-hoc ``(cfg, shape, kind)``
tuples.  ``WorkloadSpec`` replaces those tuples with one frozen record that
all five subsystems (predictor, planspace, autotuner, trainer, server)
consume:

  * ``phase`` — ``train`` | ``prefill`` | ``decode`` (first-class, not a
    string threaded positionally through every call);
  * the batch/sequence/microbatch shape (``global_batch``, ``seq_len``,
    ``microbatches``);
  * decode-only refinements the old taxonomy could not express at all:
    KV/SSM-cache read traffic (``cache_tokens``), slot occupancy
    (``active_slots``), speculative-decode length (``spec_len``) and MoE
    routing imbalance (``moe_imbalance``).

Each refinement, when set, introduces a dedicated free variable into the
symbolic counts (``CT``/``AS``/``SL``/``MI`` next to the classic
``B``/``S``/``M``), so a fused ``BasisProgram`` compiled once can rescore a
whole sweep of occupancies or context loads as array ops — that is what
lets ``runtime/server.py`` score admission decisions per decode iteration.
When a refinement is left at its default the corresponding variable stays
OUT of the formulas (``structure()`` is the program-cache key), so default
specs compile to exactly the pre-spec programs.

``ShapeConfig`` remains a valid argument everywhere (it names a benchmark
cell, which is still useful); ``as_spec`` converts it silently.  Bare
``kind=`` strings are the deprecated legacy path: they convert too, but
with a ``DeprecationWarning`` attributed to the caller — CI promotes that
warning to an error for ``repro.*`` modules so no internal caller can keep
using them silently.
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.configs import base as _shapes

PHASES = ("train", "prefill", "decode")


@dataclass(frozen=True)
class WorkloadSpec:
    """A complete, hashable description of one step of work.

    Shape semantics per phase:
      * ``train`` / ``prefill``: ``global_batch`` rows of ``seq_len``
        tokens each (prefill additionally writes those tokens' KV/SSM
        cache rows).
      * ``decode``: ``global_batch`` is the ALLOCATED slot count of the
        continuous-batching server, ``seq_len`` the per-slot cache
        capacity.  One iteration emits one token per slot (times
        ``spec_len`` under speculative decoding).

    Decode refinements (``None``/default = not modeled, variable absent):
      * ``cache_tokens`` — total context tokens read across slots this
        iteration (free variable ``CT``).  Default: every slot full,
        ``B · min(S, sliding_window)``.
      * ``active_slots`` — occupied slots (free variable ``AS``).  When
        set, per-token work (projections, FFN, head, VPU, cache writes)
        scales with occupancy — an occupancy-aware runtime; when unset,
        per-token work scales with the allocated ``B`` — the static-shape
        XLA execution this repo's server actually runs.
      * ``spec_len`` — tokens verified per iteration under speculative
        decoding (free variable ``SL``, multiplies token throughput).
      * ``moe_imbalance`` — hottest-expert load multiplier on expert FFN
        compute (free variable ``MI``).  Train/prefill dispatch is
        capacity-padded (GShard), where imbalance drops tokens instead of
        adding flops, so ``MI`` only enters decode counts.

    ``microbatches`` is the schedule default; a ``Plan`` carried alongside
    (plan search, predict_step) overrides it, exactly as the plan always
    overrode the shape.
    """
    phase: str = "train"
    global_batch: int = 1
    seq_len: int = 1
    microbatches: int = 1
    active_slots: Optional[int] = None
    cache_tokens: Optional[float] = None
    spec_len: int = 1
    moe_imbalance: float = 1.0
    name: str = ""

    def __post_init__(self):
        if self.phase not in PHASES:
            raise ValueError(f"unknown phase {self.phase!r}; "
                             f"expected one of {PHASES}")

    # -- identity ----------------------------------------------------------
    @property
    def kind(self) -> str:
        """Alias for ``phase`` — lets a spec duck-type a ``ShapeConfig``."""
        return self.phase

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch

    def structure(self) -> Tuple[str, ...]:
        """The program-cache key: phase plus which optional variables the
        symbolic counts must carry.  Two specs with equal structure share
        one compiled ``BasisProgram`` (their numbers differ only through
        the environment), and a spec with NO refinements shares the
        program of the pre-spec ``kind=`` era."""
        flags = []
        if self.phase == "decode":
            if self.cache_tokens is not None:
                flags.append("ct")
            if self.active_slots is not None:
                flags.append("as")
            if self.spec_len != 1:
                flags.append("sl")
            if self.moe_imbalance != 1.0:
                flags.append("mi")
        return (self.phase, *flags)

    # -- evaluation --------------------------------------------------------
    def env(self, cfg: Optional[ArchConfig] = None) -> Dict[str, float]:
        """The free-variable environment this spec pins: ``B``/``S``/``M``
        always, plus the decode refinements' variables with their defaults
        filled in (``CT`` needs ``cfg`` for the sliding-window clamp).
        Callers may override entries (a plan's microbatch count, a
        planspace column) by merging on top."""
        e: Dict[str, float] = {"B": self.global_batch, "S": self.seq_len,
                               "M": self.microbatches}
        if self.phase == "decode":
            e["AS"] = (self.global_batch if self.active_slots is None
                       else self.active_slots)
            if self.cache_tokens is None:
                ctx = self.seq_len
                if cfg is not None and cfg.sliding_window is not None:
                    ctx = min(ctx, cfg.sliding_window)
                e["CT"] = self.global_batch * ctx
            else:
                e["CT"] = self.cache_tokens
            e["SL"] = self.spec_len
            e["MI"] = self.moe_imbalance
        return e

    def with_(self, **kw) -> "WorkloadSpec":
        return dataclasses.replace(self, **kw)


#: what every spec-taking entry point accepts.
WorkloadLike = Union[WorkloadSpec, ShapeConfig, str]


def from_shape(shape: ShapeConfig) -> WorkloadSpec:
    """A ``ShapeConfig`` as a spec: same shape, no decode refinements —
    the exact workload the pre-spec code scored for that shape."""
    return WorkloadSpec(phase=shape.kind, global_batch=shape.global_batch,
                        seq_len=shape.seq_len, name=shape.name)


def as_spec(workload: WorkloadLike, *, _stacklevel: int = 3) -> WorkloadSpec:
    """Coerce any accepted workload form to a ``WorkloadSpec``.

    ``ShapeConfig`` converts silently (it is a named benchmark cell, still
    first-class).  A bare phase STRING is the legacy ``kind=`` path: it
    converts to a shapeless spec — fine for the purely symbolic builders,
    which only read ``structure()`` — but warns ``DeprecationWarning``
    attributed ``_stacklevel`` frames up (default: the caller of the public
    API that called ``as_spec``), so CI's warning-as-error filter catches
    internal ``repro.*`` callers while external callers get one release of
    grace."""
    if isinstance(workload, WorkloadSpec):
        return workload
    if isinstance(workload, ShapeConfig):
        return from_shape(workload)
    if isinstance(workload, str):
        warnings.warn(
            f"kind={workload!r} strings are deprecated; pass a "
            f"repro_torch.core.workload.WorkloadSpec (or a ShapeConfig) instead",
            DeprecationWarning, stacklevel=_stacklevel)
        return WorkloadSpec(phase=workload)
    raise TypeError(
        f"expected WorkloadSpec | ShapeConfig | phase string, got "
        f"{type(workload).__name__}: {workload!r}")


# -- the library's canonical cells, as specs (mirrors configs.base.SHAPES) --

TRAIN_4K = from_shape(_shapes.TRAIN_4K)
PREFILL_32K = from_shape(_shapes.PREFILL_32K)
DECODE_32K = from_shape(_shapes.DECODE_32K)
LONG_500K = from_shape(_shapes.LONG_500K)

SPECS = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
