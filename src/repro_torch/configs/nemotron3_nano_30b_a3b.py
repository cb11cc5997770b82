"""NVIDIA-Nemotron-3-Nano-30B-A3B (``nemotron_h``; the family in
arXiv:2504.03624) — 52 pre-norm blocks by a pattern: 23 Mamba2 mixers (64
SSD heads of 64, d_state 128, 8 groups), 23 MoE layers (128 relu² experts
of 1856, top-6 by sigmoid scores with a correction bias, weights scaled
by 2.5, one shared expert of 3712, no token dropped) and 6 GQA attention
layers (32 query and 2 KV heads of 128, no positional encoding)."""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig

PATTERN = "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME"

CONFIG = ArchConfig(
    name="nemotron-3-nano-30b-a3b",
    family="pattern",
    n_layers=len(PATTERN),
    d_model=2688,
    n_heads=32,
    n_kv_heads=2,
    d_ff=1856,
    vocab_size=131072,
    head_dim=128,
    use_rope=False,
    block_pattern=PATTERN,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=8,
                  chunk=128, heads=64),
    moe=MoEConfig(n_experts=128, top_k=6, routed_scale=2.5, shared_ff=3712,
                  dropless=True, aux_loss_weight=0.0),
)
