"""Qwen2-VL-7B [arXiv:2409.12191] — VLM backbone, M-RoPE, GQA kv=4.

Backbone only: the vision frontend is a stub; ``input_specs()`` supplies
precomputed patch embeddings occupying the first ``vision_tokens`` positions.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    head_dim=128,
    rope_theta=1000000.0,
    m_rope=True,
    mrope_sections=(16, 24, 24),
    use_qkv_bias=True,
    vision_tokens=256,
)
