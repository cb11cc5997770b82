"""Hand-written Hopper kernels (CUDA sources under ``csrc/``), their wrappers
and their plain PyTorch versions."""
