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


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------

SSD_CASES = [
    # Bz, H, G, L, P, N, chunk, dtype (the reference's table, then edges)
    (2, 4, 1, 256, 32, 16, 64, "float32"),
    (1, 4, 2, 128, 64, 32, 32, "float32"),
    (2, 2, 2, 128, 16, 64, 128, "float32"),
    (1, 4, 1, 256, 64, 128, 64, "float32"),
    (2, 4, 1, 256, 32, 16, 64, "bfloat16"),
    (1, 2, 1, 200, 32, 16, 100, "float32"),    # chunk not a tile multiple
    (1, 2, 1, 256, 64, 128, 128, "float32"),   # mamba2-370m's d_state
    (1, 2, 1, 256, 16, 128, 256, "float32"),   # the largest chunk at N 128
]


def _ssd_inputs(case, device, seed=42, main_layout=False):
    """numpy inputs; with ``main_layout`` x, B, C are column slices of one
    (Bz, L, width) tensor viewed as (Bz, H, L, P) / (Bz, G, L, N), as
    ``ssm_apply`` hands them over."""
    Bz, H, G, L, P, N, _, dtype = case
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((Bz, L, H, P))).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bz, L, H)))).astype(np.float32)
    A = -np.exp(0.3 * rng.standard_normal(H)).astype(np.float32)
    B = (0.3 * rng.standard_normal((Bz, L, G, N))).astype(np.float32)
    C = (0.3 * rng.standard_normal((Bz, L, G, N))).astype(np.float32)
    xdt = getattr(torch, dtype)
    if main_layout:
        cat = np.concatenate([a.reshape(Bz, L, -1) for a in (x, B, C)], -1)
        xbc = torch.from_numpy(cat).to(device=device, dtype=xdt)
        d = H * P
        xt = xbc[..., :d].reshape(Bz, L, H, P).transpose(1, 2)
        Bt = xbc[..., d:d + G * N].reshape(Bz, L, G, N).transpose(1, 2)
        Ct = xbc[..., d + G * N:].reshape(Bz, L, G, N).transpose(1, 2)
    else:
        def t(a, dtype=torch.float32):
            return torch.from_numpy(np.ascontiguousarray(
                a.swapaxes(1, 2))).to(device=device, dtype=dtype)
        xt, Bt, Ct = t(x, xdt), t(B), t(C)
    dtt = torch.from_numpy(dt).to(device).transpose(1, 2)
    return xt, dtt, torch.from_numpy(A).to(device), Bt, Ct


@pytest.mark.parametrize("main_layout", [False, True],
                         ids=["contiguous", "strided"])
@pytest.mark.parametrize("case", SSD_CASES,
                         ids=[f"ssd{i}" for i in range(len(SSD_CASES))])
def test_ssd_kernel_matches_recurrence_and_plain_version(case, main_layout,
                                                          cuda):
    from repro_torch.kernels import ref, ssd_scan
    x, dt, A, B, C = _ssd_inputs(case, cuda, main_layout=main_layout)
    chunk, dtype = case[6], case[7]
    before = ssd_scan.ssd_scan.launches
    y, h = kops.ssd_scan(x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.ssd_scan.launches == before + 1
    assert y.dtype == x.dtype and y.shape == x.shape
    assert h.dtype == torch.float32
    yr, hr = ref.ssd(x, dt, A, B, C)
    yp, hp = ssd_scan.ssd_scan_reference(x, dt, A, B, C, chunk=chunk)
    # the reference's own tolerances: f32 5e-4, bf16 3e-2, state 5e-4
    tol = 3e-2 if dtype == "bfloat16" else 5e-4
    for r in (yr, yp):
        torch.testing.assert_close(y.float(), r.float(), atol=tol, rtol=tol)
    for r in (hr, hp):
        torch.testing.assert_close(h, r, atol=5e-4, rtol=5e-4)


def test_ssd_chunk_invariance(cuda):
    x, dt, A, B, C = _ssd_inputs((1, 2, 1, 256, 16, 16, 0, "float32"), cuda)
    outs = [kops.ssd_scan(x, dt, A, B, C, chunk=c)[0]
            for c in (32, 64, 128, 256)]
    for o in outs[1:]:
        torch.testing.assert_close(outs[0], o, atol=1e-4, rtol=1e-4)


def test_ssd_output_keeps_the_inputs_layout(cuda):
    case = (2, 4, 1, 128, 32, 16, 64, "bfloat16")
    x, dt, A, B, C = _ssd_inputs(case, cuda, main_layout=True)
    y, _ = kops.ssd_scan(x, dt, A, B, C, chunk=64)
    assert y.transpose(1, 2).is_contiguous()  # (B, L, H, P) in memory
    with pytest.raises(ValueError, match="contiguous"):
        kops.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A,
                      B, C, chunk=64)
    with pytest.raises(ValueError, match="chunk"):
        kops.ssd_scan(x, dt, A, B, C, chunk=48)


@pytest.mark.parametrize("P,N,chunk,want", [
    (64, 64, 128, 64),    # zamba2-2.7b: two blocks share an SM
    (64, 128, 128, 64),   # mamba2-370m
    (64, 128, 256, 16),   # the largest chunk at the largest state
    (16, 16, 256, 16),    # the reduced configs' P
    (32, 16, 100, 32),    # a chunk that is not a tile multiple
])
def test_ssd_tile_fits_shared_memory(P, N, chunk, want, cuda):
    from repro_torch.kernels import ssd_scan
    pb, nbytes = ssd_scan.tile(P, N, chunk)
    assert pb == want
    assert nbytes <= 227 * 1024  # what one block may use on sm_90
    with pytest.raises(ValueError, match="no tile"):
        ssd_scan.tile(P, 132, chunk)


def test_ssd_kernel_refuses_autograd(cuda):
    x, dt, A, B, C = _ssd_inputs((1, 2, 1, 64, 16, 16, 64, "float32"), cuda)
    with pytest.raises(NotImplementedError, match="backward"):
        kops.ssd_scan(x.requires_grad_(), dt, A, B, C, chunk=64)


@pytest.mark.parametrize("name", ["mamba2-370m", "zamba2-2.7b"])
def test_ssm_forward_through_the_kernels_matches_plain_path(name, cuda):
    from repro_torch.kernels import ssd_scan
    cfg = dataclasses.replace(ARCHS[name].reduced(), param_dtype="float32",
                              compute_dtype="float32")
    model = transformer.init_params(cfg, seed=0)
    tok = torch.randint(0, cfg.vocab_size, (2, 64), device=cuda)
    before = ssd_scan.ssd_scan.launches
    with torch.no_grad():
        a, _ = transformer.forward(model, cfg, {"tokens": tok})
        assert ssd_scan.ssd_scan.launches == before + cfg.n_layers
        with flags.use_kernels(False):
            b, _ = transformer.forward(model, cfg, {"tokens": tok})
    torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
