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


class _Flags(threading.local):
    # class-level defaults: a thread that never set a flag reads them
    # without the caught AttributeError a getattr default costs per call
    kernels = True
    attn_stub = False
    priced = False


_tls = _Flags()


def kernels_enabled() -> bool:
    return _tls.kernels


@contextmanager
def use_kernels(enabled: bool = True):
    prev = _tls.kernels
    _tls.kernels = enabled
    try:
        yield
    finally:
        _tls.kernels = prev


def attention_stubbed() -> bool:
    return _tls.attn_stub


@contextmanager
def stub_attention(enabled: bool = True):
    """Replace the attention contraction with a free pass-through — used to
    ATTRIBUTE which share of a step's cost is attention (difference of two
    runs)."""
    prev = _tls.attn_stub
    _tls.attn_stub = enabled
    try:
        yield
    finally:
        _tls.attn_stub = prev


def kernels_priced() -> bool:
    return _tls.priced


@contextmanager
def price_kernels(enabled: bool = True):
    """Fake tensors stand for the card's (the dry run): a kernel wrapper
    handed fake tensors prices the kernel it would launch (its schedule's
    products, the bytes it moves; ``core.extract.price_kernel``) instead of
    running its plain version, and ``block_sizes="auto"`` scores through
    the card's cost model."""
    prev = _tls.priced
    _tls.priced = enabled
    try:
        yield
    finally:
        _tls.priced = prev
