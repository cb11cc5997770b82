"""Parallelism plan: how logical axes map onto the physical mesh.

A ``Plan`` is the unit the cost-model-driven autosharding search ranks
(``core/predictor.py``, ``core/planspace.py``, ``launch/autoshard.py``).  A copy of the
reference's ``distributed/plan.py``: on one device the trainer reads only
``microbatches`` and ``remat_policy``.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class Plan:
    # mesh axis names used for each role (must exist in the physical mesh)
    dp_axes: Tuple[str, ...] = ("pod", "data")  # batch / FSDP axes
    tp_axis: Optional[str] = "model"            # tensor-parallel axis
    # features
    fsdp: bool = True                 # shard params over dp_axes too (ZeRO-3)
    sequence_parallel: bool = True    # shard residual-stream seq dim over tp
    moe_mode: str = "tp"              # "tp" | "ep" (expert-parallel)
    microbatches: int = 1             # gradient-accumulation chunks
    remat_policy: Optional[str] = None  # override arch default
    compression: Optional[str] = None   # None | "int8_ef" for DP grad all-reduce
    # decode-specific
    cache_seq_axes: Tuple[str, ...] = ()  # mesh axes sharding the KV-cache
    # sequence dim (context-parallel decode; scores psum over these axes)

    def param_rules(self) -> Dict[str, object]:
        """Logical param axis -> mesh axes."""
        fsdp_ax = self.dp_axes if self.fsdp else ()
        return {
            "embed": fsdp_ax,          # FSDP shards the embed dim of weights
            "ff": self.tp_axis,
            "heads": self.tp_axis,
            "kv_heads": self.tp_axis,  # applied only when divisible
            "vocab": self.tp_axis,
            "layers": None,
            "codebook": None,
            "head_idx": None,
            "expert": self.tp_axis if self.moe_mode == "ep" else None,
            "ssm_inner": self.tp_axis,
            "ssm_state": None,
            "ssm_heads": self.tp_axis,
            "conv": None,
            "head_dim": None,
        }

    def act_rules(self) -> Dict[str, object]:
        """Logical activation axis -> mesh axes."""
        return {
            "act_batch": self.dp_axes,
            "act_seq": self.tp_axis if self.sequence_parallel else None,
            "act_seq_dp": self.cache_seq_axes or None,
            "act_embed": None,
            "act_heads": self.tp_axis,
            "act_kv_heads": self.tp_axis,
            "act_ff": self.tp_axis,
            "act_vocab": self.tp_axis,
            "act_expert": self.tp_axis if self.moe_mode == "ep" else None,
            "act_cp": self.tp_axis,   # context-parallel q-slice dim
            "act_ssm_heads": self.tp_axis,
            "act_ssm_inner": self.tp_axis,
            "act_layers": None,
        }

    def with_(self, **kw) -> "Plan":
        return replace(self, **kw)


# sensible defaults per shape kind
def default_plan(kind: str, multi_pod: bool) -> Plan:
    dp = ("pod", "data") if multi_pod else ("data",)
    if kind == "train":
        return Plan(dp_axes=dp)
    if kind == "prefill":
        return Plan(dp_axes=dp, fsdp=False, microbatches=1)
    # decode: batch over dp, weights TP; cache seq sharding for long contexts
    return Plan(dp_axes=dp, fsdp=False, sequence_parallel=False)


#: device memory a plan is sized for by default: the H100 SXM's 80 GB of
#: HBM3 (the ``gpu-h100`` catalog entry); on the card callers pass
#: ``torch.cuda.get_device_properties(dev).total_memory``, and parity tests
#: the reference's 16e9 (``core/predictor.HBM_BYTES``)
H100_HBM_BYTES = 80e9


def plan_for(cfg, shape, *, multi_pod: bool = False,
             tp_size: int = 16, hbm_budget: float = H100_HBM_BYTES) -> Plan:
    """Memory-aware default plan for an (arch × shape) cell.

    This is the *paper-faithful baseline* plan the dry-run lowers; the
    cost-model autosharding search (launch/autoshard.py) refines it.
    ``hbm_budget``: one device's memory (it decides weight-distributed
    serving).
    """
    dp = ("pod", "data") if multi_pod else ("data",)
    n_dev = (2 if multi_pod else 1) * 16 * tp_size
    bits = 16 if "16" in cfg.param_dtype else 32
    param_bytes = cfg.n_params() * (bits // 8)

    if shape.kind == "train":
        # microbatches so that remat boundary activations fit comfortably
        act = (2 * shape.global_batch * shape.seq_len * cfg.d_model
               * cfg.n_layers) / n_dev
        m = 1
        while m < shape.global_batch and act / m > 2e9:
            m *= 2
        # sequence-parallel norms pay a dW reduce penalty under GSPMD (the
        # token contraction crosses the seq-shard axis and lowers as a
        # replicated all-reduce): at 405B width the dW tensors dominate
        # that trade (measured 8× collective inflation; EXPERIMENTS.md
        # §Perf iter B), below it the activation savings win.
        sp = cfg.d_model < 12288
        return Plan(dp_axes=dp, fsdp=True, microbatches=m,
                    sequence_parallel=sp)

    fsdp = param_bytes / tp_size > hbm_budget / 2  # weight-distributed serving
    if shape.kind == "prefill":
        return Plan(dp_axes=dp, fsdp=fsdp, microbatches=1)

    # decode: shard the KV-cache sequence over the model axis when the
    # effective context is long (kv-head sharding alone underuses the axis)
    eff_ctx = min(shape.seq_len, cfg.sliding_window or shape.seq_len)
    cache_seq = ("model",) if (cfg.n_heads and eff_ctx >= 32768) else ()
    return Plan(dp_axes=dp, fsdp=fsdp, sequence_parallel=False,
                cache_seq_axes=cache_seq)
