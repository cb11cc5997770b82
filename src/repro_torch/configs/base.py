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
    # the picks' weights, renormalised over the top_k, are scaled by this
    routed_scale: float = 1.0
    # width of one shared expert every token passes through (0: none)
    shared_ff: int = 0
    # False: GShard's capacity-bounded dense dispatch of softmax-routed
    # SwiGLU experts.  True: no capacity, every pick computed (index-based
    # dispatch), of relu² experts (down(relu(up x)^2), no gate) routed by a
    # sigmoid of each logit with a correction bias that steers the picks
    # only (the router and its bias held in f32)
    dropless: bool = False


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) mixer configuration."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64  # P
    n_groups: int = 1
    chunk: int = 128  # SSD chunk length
    # SSD heads; 0 -> expand * d_model / head_dim (d_inner = heads *
    # head_dim where set)
    heads: int = 0


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
    family: str  # dense | moe | ssm | hybrid | vlm | audio | pattern
    n_layers: int
    d_model: int
    n_heads: int  # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # --- positional encoding ---
    rope_theta: float = 10000.0
    use_rope: bool = True  # False: attention turns no q, k (NoPE)
    m_rope: bool = False  # Qwen2-VL multi-dimensional RoPE
    mrope_sections: Tuple[int, ...] = (16, 24, 24)  # splits of head_dim//2
    # --- attention variants ---
    sliding_window: Optional[int] = None  # SWA (Mixtral): window size
    use_qkv_bias: bool = False  # Qwen2 uses qkv bias
    # --- mixers ---
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    # the pattern family: block i is the i-th letter, "M" a Mamba2 mixer,
    # "E" the MoE, "*" attention, each one pre-norm residual block
    block_pattern: Optional[str] = None
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

    def __post_init__(self):
        if self.block_pattern is not None and (
                len(self.block_pattern) < self.n_layers
                or set(self.block_pattern) - set("ME*")):
            raise ValueError(f"{self.name}: block_pattern "
                             f"{self.block_pattern!r} is not {self.n_layers} "
                             f"or more letters of M, E and *")

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
        if self.ssm.heads:
            return self.ssm.heads * self.ssm.head_dim
        return self.ssm.expand * self.d_model

    @property
    def blocks(self) -> str:
        """The pattern family's blocks, a letter each: the first
        ``n_layers`` of ``block_pattern`` (fewer layers cut the model's
        depth, as in the other families)."""
        return self.block_pattern[:self.n_layers]

    def blocks_of(self, kind: str) -> int:
        """How many of ``blocks`` are of ``kind`` (M, E or *)."""
        return self.blocks.count(kind)

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

        def expert_params() -> int:
            m = self.moe
            per = (2 if m.dropless else 3) * d * ff
            return d * m.n_experts + (m.n_experts if m.dropless else 0) \
                + m.n_experts * per + 2 * d * m.shared_ff

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
        if self.family == "pattern":
            total += self.blocks_of("M") * (ssm_params() + d)
            total += self.blocks_of("E") * (expert_params() + d)
            total += self.blocks_of("*") * (attn_params() + d)
        elif self.family == "ssm":
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
        if self.family == "pattern":
            m = self.moe
            per = (2 if m.dropless else 3) * self.d_model \
                * self.d_ff
            return self.n_params() \
                - self.blocks_of("E") * (m.n_experts - m.top_k) * per
        dense_like = dataclasses.replace(self, moe=None)
        base = dense_like.n_params()
        # dense counted 1 FFN / layer; MoE activates top_k + router
        per_layer_extra = (self.moe.top_k - 1) * 3 * self.d_model * self.d_ff
        per_layer_extra += self.d_model * self.moe.n_experts
        return base + self.n_layers * per_layer_extra

    # ------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        if self.family == "pattern":
            return self._reduced_pattern()
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

    def _reduced_pattern(self) -> "ArchConfig":
        """Every letter of the pattern once or twice, at tiny widths; the
        SSD heads in 4 groups, the router's kind, scale and experts'
        function kept."""
        ssm = dataclasses.replace(self.ssm, d_state=16, head_dim=16,
                                  heads=8, n_groups=4, chunk=16)
        moe = dataclasses.replace(self.moe, n_experts=8, top_k=2,
                                  shared_ff=48 if self.moe.shared_ff else 0)
        return dataclasses.replace(
            self, name=self.name + "-smoke", block_pattern="MEM*E",
            n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32,
            vocab_size=256, head_dim=16, ssm=ssm, moe=moe)


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
