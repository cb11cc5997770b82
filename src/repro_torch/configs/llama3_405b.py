"""Llama-3-405B [arXiv:2407.21783] — GQA kv=8, 128k vocab.

Configured for Adafactor + full remat (the reference's choice for its
largest model); the training path is not ported yet.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    head_dim=128,
    rope_theta=500000.0,
    optimizer="adafactor",
    remat_policy="full",
)
