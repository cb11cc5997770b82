"""Runtime feature flags (thread-local, context-managed).

``use_kernels(False)`` switches the attention and SSM mixers from their
hand-written CUDA kernels to the plain PyTorch versions of the same
functions.  Kernels are
ON by default.  The flag exists so that tests and ``chip_smoke.py`` can run
the plain version beside the kernel and compare them; it is not a fallback:
with kernels enabled, a CUDA tensor goes through the kernel or the call
raises.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

_tls = threading.local()


def kernels_enabled() -> bool:
    return getattr(_tls, "kernels", True)


@contextmanager
def use_kernels(enabled: bool = True):
    prev = getattr(_tls, "kernels", True)
    _tls.kernels = enabled
    try:
        yield
    finally:
        _tls.kernels = prev


def attention_stubbed() -> bool:
    return getattr(_tls, "attn_stub", False)


@contextmanager
def stub_attention(enabled: bool = True):
    """Replace the attention contraction with a free pass-through — used to
    ATTRIBUTE which share of a step's cost is attention (difference of two
    runs)."""
    prev = getattr(_tls, "attn_stub", False)
    _tls.attn_stub = enabled
    try:
        yield
    finally:
        _tls.attn_stub = prev
