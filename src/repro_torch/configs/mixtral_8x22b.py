"""Mixtral-8x22B [arXiv:2401.04088] — MoE 8 experts top-2, GQA kv=8, SWA."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    head_dim=128,
    rope_theta=1000000.0,
    sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2),
)
