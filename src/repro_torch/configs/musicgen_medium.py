"""MusicGen-medium [arXiv:2306.05284] — decoder-only over EnCodec tokens.

Backbone only: the EnCodec frontend is a stub; ``input_specs()`` supplies
4-codebook token ids (summed codebook embeddings on input, 4 parallel
lm-heads with the delay pattern on output).  Text cross-attention conditioning
is out of backbone scope (DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    head_dim=64,
    n_output_heads=4,
    n_input_codebooks=4,
)
