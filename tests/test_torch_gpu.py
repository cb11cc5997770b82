"""Tests of the port that need an NVIDIA GPU and ``nvcc`` (a CUDA kernel has
no interpret mode).  They import ``torch`` and the port only, so they run on
a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Where there is no GPU every test here skips (decided inside the fixture, never
at import).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import ARCHS
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as kops
from repro_torch.models import transformer
from repro_torch.runtime import flags

pytestmark = pytest.mark.gpu

FA_CASES = [
    # B, H, KVH, Sq, Skv, dh, causal, window, dtype
    (2, 4, 2, 256, 256, 64, True, None, "float32"),
    (1, 4, 4, 128, 128, 32, True, None, "float32"),   # MHA
    (1, 8, 1, 128, 128, 64, True, None, "float32"),   # MQA
    (2, 8, 2, 256, 256, 64, True, 64, "float32"),     # SWA
    (1, 2, 1, 128, 256, 64, False, None, "float32"),  # cross/bidir
    (2, 4, 2, 256, 256, 64, True, None, "bfloat16"),
    (1, 4, 2, 256, 256, 128, True, 128, "bfloat16"),
    (1, 4, 2, 100, 77, 48, False, None, "float32"),   # ragged, padded dh
    (2, 4, 2, 40, 40, 16, True, None, "float32"),     # the reduced configs' dh
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(case, device, seed=42):
    B, H, KVH, Sq, Skv, dh = case[:6]
    rng = np.random.default_rng(seed)
    dt = getattr(torch, case[8])
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(device=device, dtype=dt)
            for s in ((B, H, Sq, dh), (B, KVH, Skv, dh), (B, KVH, Skv, dh))]


@pytest.mark.parametrize("case", FA_CASES,
                         ids=[f"fa{i}" for i in range(len(FA_CASES))])
def test_cuda_kernel_matches_plain_version(case, cuda):
    q, k, v = _qkv(case, cuda)
    causal, window, dtype = case[6], case[7], case[8]
    before = fa.flash_attention.launches
    o = kops.flash_attention(q, k, v, causal=causal, window=window,
                             block_q=64, block_k=64)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    with flags.use_kernels(False):
        r = kops.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.flash_attention.launches == before + 1
    # f32: 1e-4, the reference's 3e-5 loosened because the kernel sums the
    # products in another order than the plain version; bf16: the
    # reference's own 2e-2
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    assert o.dtype == q.dtype and o.shape == q.shape
    torch.testing.assert_close(o.float(), r.float(), atol=tol, rtol=tol)


def test_strided_views_are_taken_without_copies(cuda):
    g = torch.Generator(cuda).manual_seed(0)
    q = torch.randn(2, 96, 6, 64, device=cuda, generator=g).transpose(1, 2)
    k = torch.randn(2, 96, 2, 64, device=cuda, generator=g).transpose(1, 2)
    v = torch.randn(2, 96, 2, 64, device=cuda, generator=g).transpose(1, 2)
    o = kops.flash_attention(q, k, v)
    assert o.stride() == q.stride()  # (B, S, H, dh) in memory, like q
    r = fa.attention_reference(q, k, v)
    torch.testing.assert_close(o, r, atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="contiguous"):
        kops.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                             k, v)


def test_kernel_refuses_autograd(cuda):
    q = torch.randn(1, 2, 32, 16, device=cuda, requires_grad=True)
    k = torch.randn(1, 2, 32, 16, device=cuda)
    with pytest.raises(NotImplementedError, match="backward"):
        kops.flash_attention(q, k, k)


@pytest.mark.parametrize("name", ["llama3.2-3b", "smollm-360m"])
def test_forward_through_the_kernel_matches_plain_path(name, cuda):
    cfg = dataclasses.replace(ARCHS[name].reduced(), param_dtype="float32",
                              compute_dtype="float32")
    model = transformer.init_params(cfg, seed=0)  # device defaults to cuda
    tok = torch.randint(0, cfg.vocab_size, (2, 48), device=cuda)
    before = fa.flash_attention.launches
    with torch.no_grad():
        a, _ = transformer.forward(model, cfg, {"tokens": tok})
        assert fa.flash_attention.launches == before + cfg.n_layers
        with flags.use_kernels(False):
            b, _ = transformer.forward(model, cfg, {"tokens": tok})
    torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
