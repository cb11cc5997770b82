"""Mixtral-8x7B [arXiv:2401.04088] — MoE 8 experts top-2, GQA kv=8, SWA."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    rope_theta=1000000.0,
    sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2),
)
