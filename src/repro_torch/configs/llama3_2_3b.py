"""Llama-3.2-3B [arXiv:2407.21783 family] — small llama3, GQA kv=8."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    head_dim=128,
    rope_theta=500000.0,
)
