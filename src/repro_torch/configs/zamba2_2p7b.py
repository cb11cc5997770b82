"""Zamba2-2.7B [arXiv:2411.15242] — Mamba2 blocks + shared attention block.

54 SSD layers; a single shared (attention + MLP) block is applied after every
6th SSD layer (9 applications, one parameter set).
"""
from repro_torch.configs.base import ArchConfig, HybridConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,  # shared block is MHA
    d_ff=10240,
    vocab_size=32000,
    head_dim=80,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, n_groups=1),
    hybrid=HybridConfig(attn_every=6),
)
