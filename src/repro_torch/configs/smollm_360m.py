"""SmolLM-360M [hf:HuggingFaceTB/SmolLM-135M family] — small llama-arch, GQA kv=5."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    head_dim=64,
    rope_theta=10000.0,
    tie_embeddings=True,
)
