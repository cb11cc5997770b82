"""Mamba2-370M [arXiv:2405.21060] — attention-free SSD (state-space duality)."""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1),
    tie_embeddings=True,
)
