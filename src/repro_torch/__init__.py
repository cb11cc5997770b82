"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100).

Same subpackage and module names as the JAX package ``repro``, which stays
in the repository as the reference this package is tested against.  This
package imports ``torch`` and never ``jax`` or ``repro``.
"""
