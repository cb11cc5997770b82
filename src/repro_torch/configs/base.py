"""Architecture + shape configuration system.

Every assigned architecture is a frozen ``ArchConfig``; the four assigned
input-shape points are ``ShapeConfig``s.  ``registry.py`` maps ``--arch`` ids
to configs.  Reduced (smoke) variants are derived with ``cfg.reduced()``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    # Token capacity factor for dense (GShard-style) dispatch.
    capacity_factor: float = 1.25
    # router jitter / aux loss weight
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) mixer configuration."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64  # P
    n_groups: int = 1
    chunk: int = 128  # SSD chunk length


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style hybrid: shared attention block applied every k SSM layers."""

    attn_every: int = 6  # apply the (single, shared) attention block after
    # every `attn_every`-th SSM layer


# ---------------------------------------------------------------------------
# Main architecture config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int  # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # --- positional encoding ---
    rope_theta: float = 10000.0
    m_rope: bool = False  # Qwen2-VL multi-dimensional RoPE
    mrope_sections: Tuple[int, ...] = (16, 24, 24)  # splits of head_dim//2
    # --- attention variants ---
    sliding_window: Optional[int] = None  # SWA (Mixtral): window size
    use_qkv_bias: bool = False  # Qwen2 uses qkv bias
    # --- mixers ---
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    # --- heads / embeddings ---
    tie_embeddings: bool = False
    n_output_heads: int = 1  # MusicGen: 4 codebook heads
    n_input_codebooks: int = 1  # MusicGen: sum of 4 codebook embeddings
    # --- modality frontend stubs ---
    vision_tokens: int = 0  # Qwen2-VL: leading positions carry patch embeds
    embed_inputs: bool = False  # True -> input_specs supplies (B,S,d) embeds
    # --- numerics ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    # --- training-memory knobs (per-arch defaults, overridable by plan) ---
    optimizer: str = "adamw"  # adamw | adafactor
    remat_policy: str = "full"  # none | dots | full (full = save block
    # boundaries only; required for the large-arch dry-runs to fit HBM)

    # ------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        assert self.n_heads > 0
        return self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run the long_500k decode cell?"""
        return (
            self.ssm is not None
            or self.hybrid is not None
            or self.sliding_window is not None
        )

    @property
    def d_inner(self) -> int:
        assert self.ssm is not None
        return self.ssm.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        assert self.ssm is not None
        return self.d_inner // self.ssm.head_dim

    def n_params(self) -> int:
        """Closed-form parameter count (embedding + blocks + head)."""
        d, ff, V, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        total = V * d * self.n_input_codebooks  # embeddings
        if not self.tie_embeddings:
            total += V * d * self.n_output_heads
        hd = self.head_dim_ if self.n_heads else 0

        def attn_params() -> int:
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            b = (self.n_heads + 2 * self.n_kv_heads) * hd if self.use_qkv_bias else 0
            return q + kv + o + b

        def ffn_params(dff: int) -> int:
            return 3 * d * dff  # SwiGLU

        def ssm_params() -> int:
            s = self.ssm
            din = self.d_inner
            nh = self.ssm_heads
            conv_dim = din + 2 * s.n_groups * s.d_state
            in_proj = d * (2 * din + 2 * s.n_groups * s.d_state + nh)
            conv = (s.d_conv + 1) * conv_dim  # weight + bias
            out_proj = din * d
            extra = 3 * nh + din  # A_log, D, dt_bias, gated-norm weight
            return in_proj + conv + out_proj + extra

        per_layer = 0
        if self.family == "ssm":
            per_layer = ssm_params() + d  # + norm
            total += L * per_layer
        elif self.family == "hybrid":
            total += L * (ssm_params() + d)
            # one shared attention+MLP block
            total += attn_params() + ffn_params(self.d_ff) + 2 * d
        else:
            per_layer = attn_params() + 2 * d  # two norms
            if self.moe is not None:
                per_layer += d * self.moe.n_experts  # router
                per_layer += self.moe.n_experts * ffn_params(self.d_ff)
            else:
                per_layer += ffn_params(self.d_ff)
            total += L * per_layer
        total += d  # final norm
        return total

    def n_active_params(self) -> int:
        """Active (per-token) parameter count — differs for MoE."""
        if self.moe is None:
            return self.n_params()
        dense_like = dataclasses.replace(self, moe=None)
        base = dense_like.n_params()
        # dense counted 1 FFN / layer; MoE activates top_k + router
        per_layer_extra = (self.moe.top_k - 1) * 3 * self.d_model * self.d_ff
        per_layer_extra += self.d_model * self.moe.n_experts
        return base + self.n_layers * per_layer_extra

    # ------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        kw = dict(
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_heads else 0,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            head_dim=16 if self.n_heads else 0,
            vision_tokens=min(self.vision_tokens, 4),
        )
        if self.m_rope:
            kw["mrope_sections"] = (2, 3, 3)  # scaled to head_dim 16
        if self.moe is not None:
            kw["moe"] = MoEConfig(n_experts=4, top_k=2)
        if self.ssm is not None:
            kw["ssm"] = SSMConfig(
                d_state=16, head_dim=16, expand=2, n_groups=1, chunk=16,
                d_conv=self.ssm.d_conv,
            )
        if self.hybrid is not None:
            kw["hybrid"] = HybridConfig(attn_every=1)
            kw["n_kv_heads"] = 4
        if self.sliding_window is not None:
            kw["sliding_window"] = 16
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """long_500k needs sub-quadratic attention (see DESIGN.md §4)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "SKIP(full-attention): 524k dense-attn KV cache infeasible"
    return True, ""
