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
    # bf16 twins: the tensor-core kernel
    (1, 4, 4, 128, 128, 32, True, None, "bfloat16"),   # MHA
    (1, 8, 1, 128, 128, 64, True, None, "bfloat16"),   # MQA
    (2, 8, 2, 256, 256, 64, True, 64, "bfloat16"),     # SWA
    (1, 2, 1, 128, 256, 64, False, None, "bfloat16"),  # cross/bidir
    (1, 4, 2, 100, 77, 48, False, None, "bfloat16"),   # ragged, dh 48
    (2, 6, 3, 203, 203, 80, True, 50, "bfloat16"),     # ragged SWA, dh 80
    (2, 4, 2, 40, 40, 16, True, None, "bfloat16"),     # the reduced configs' dh
    (1, 32, 32, 333, 333, 80, True, None, "bfloat16"),  # zamba2's heads
    # qwen2-vl-7b's group of 7 at dh 128; musicgen-medium's MHA at dh 64
    (1, 28, 4, 256, 256, 128, True, None, "bfloat16"),
    (1, 28, 4, 256, 256, 128, True, None, "float32"),
    (1, 24, 24, 256, 256, 64, True, None, "bfloat16"),
    (1, 24, 24, 256, 256, 64, True, None, "float32"),
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


@pytest.mark.parametrize(
    "name,dtype",
    [("llama3.2-3b", "float32"), ("smollm-360m", "float32"),
     ("llama3.2-3b", "bfloat16"), ("zamba2-2.7b", "bfloat16")],
    ids=["llama3.2-3b", "smollm-360m", "llama3.2-3b-bf16", "zamba2-2.7b-bf16"])
def test_forward_through_the_kernel_matches_plain_path(name, dtype, cuda):
    cfg = dataclasses.replace(ARCHS[name].reduced(), param_dtype=dtype,
                              compute_dtype=dtype)
    model = transformer.init_params(cfg, seed=0)  # device defaults to cuda
    tok = torch.randint(0, cfg.vocab_size, (2, 48), device=cuda)
    sites = cfg.n_layers // cfg.hybrid.attn_every \
        if cfg.family == "hybrid" else cfg.n_layers
    before = fa.flash_attention.launches
    with torch.no_grad():
        a, _ = transformer.forward(model, cfg, {"tokens": tok})
        assert fa.flash_attention.launches == before + sites
        with flags.use_kernels(False):
            b, _ = transformer.forward(model, cfg, {"tokens": tok})
    if dtype == "float32":
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    else:
        # the whole step's tolerance of chip_smoke.py (TOL_PREFILL_BF16)
        rel = float((a.float() - b.float()).norm() / b.float().norm())
        assert rel <= 5e-2, rel


@pytest.mark.parametrize("dh", [16, 48, 64, 80, 128])
def test_bf16_tile_fits_shared_memory(dh, cuda):
    bq, bk, stages, nbytes = fa.tile(dh)
    # 128 keys a tile up to a head of 96; 64 above, where S, P (hi + lo)
    # and O of 128 keys do not fit ptxas's 168 registers a thread
    assert (bq, bk) == (128, 128 if dh <= 96 else 64) and stages >= 2
    assert nbytes <= 232448  # what one block may use on sm_90
    with pytest.raises(ValueError, match="head_dim"):
        fa.tile(132)


def test_bf16_kernel_refuses_a_layout_tma_cannot_read(cuda):
    q = torch.randn(1, 2, 64, 64, device=cuda, dtype=torch.bfloat16)
    wide = torch.zeros(1, 2, 64, 68, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16 bytes"):
        kops.flash_attention(wide[..., :64], q, q)   # row stride 136 bytes
    flat = torch.zeros(2 * 64 * 64 + 1, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        kops.flash_attention(flat[1:].view(1, 2, 64, 64), q, q)


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


def _ssd_inputs(case, device, seed=42, main_layout=False,
                bc_dtype="float32"):
    """numpy inputs; with ``main_layout`` x, B, C are column slices of one
    (Bz, L, width) tensor viewed as (Bz, H, L, P) / (Bz, G, L, N), as
    ``ssm_apply`` hands them over; otherwise contiguous, B and C in
    ``bc_dtype``."""
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
        bdt = getattr(torch, bc_dtype)
        xt, Bt, Ct = t(x, xdt), t(B, bdt), t(C, bdt)
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


@pytest.mark.parametrize("P,N,chunk,variant,want_pb,want_stages", [
    (64, 64, 128, "fma", 64, 1),       # zamba2-2.7b's shape, FP32 kernel
    (64, 128, 128, "fma", 64, 1),      # mamba2-370m's
    (64, 128, 256, "fma", 16, 1),      # the largest chunk at the largest state
    (16, 16, 256, "fma", 16, 1),       # the reduced configs' P
    (32, 16, 100, "fma", 32, 1),       # a chunk that is not a tile multiple
    (64, 64, 128, "wgmma", 64, 3),     # zamba2-2.7b on the tensor cores
    (64, 128, 128, "wgmma", 64, 2),    # mamba2-370m: 2 stages fit at N 128
    (128, 128, 64, "wgmma", 64, 3),
    (32, 16, 64, "wgmma", 64, 3),
])
def test_ssd_tile_fits_shared_memory(P, N, chunk, variant, want_pb,
                                     want_stages, cuda):
    from repro_torch.kernels import ssd_scan
    t = ssd_scan.tile(P, N, chunk, variant)
    assert (t.variant, t.p_block, t.stages) == (variant, want_pb, want_stages)
    assert t.smem <= 232448  # what one block may use on sm_90
    with pytest.raises(ValueError, match="no tile"):
        ssd_scan.tile(P, 132, chunk, variant)
    if variant == "wgmma":
        with pytest.raises(ValueError, match="no tile"):
            ssd_scan.tile(P, N, 100, variant)


WGMMA_CASES = [
    # Bz, H, G, L, P, N, chunk, dtype: at least 8 chunks, so the state
    # carries, or one chunk alone; chunk 64 and 128, N 16-128, G 2, P
    # 16-128
    (2, 4, 2, 1024, 64, 64, 128, "bfloat16"),
    (2, 4, 2, 512, 32, 16, 64, "bfloat16"),
    (1, 4, 1, 1024, 64, 128, 128, "bfloat16"),
    (1, 4, 2, 512, 64, 128, 64, "bfloat16"),
    (1, 2, 1, 1024, 128, 64, 128, "bfloat16"),  # P in two slices
    (2, 4, 1, 128, 64, 64, 128, "bfloat16"),    # one chunk: the walk's ends
    (1, 4, 1, 512, 16, 32, 64, "bfloat16"),     # the reduced configs' P
    (1, 2, 1, 1024, 48, 80, 128, "bfloat16"),   # N 80 inside the 128 state
]


@pytest.mark.parametrize("main_layout", [False, True],
                         ids=["contiguous", "strided"])
@pytest.mark.parametrize("case", WGMMA_CASES,
                         ids=[f"wg{i}" for i in range(len(WGMMA_CASES))])
def test_ssd_wgmma_kernel_matches_recurrence_and_plain_version(
        case, main_layout, cuda):
    from repro_torch.kernels import ref, ssd_scan
    x, dt, A, B, C = _ssd_inputs(case, cuda, main_layout=main_layout,
                                 bc_dtype="bfloat16")
    chunk = case[6]
    assert ssd_scan.tile_for(x, B, C, chunk).variant == "wgmma"
    before = ssd_scan.ssd_scan.launches
    y, h = kops.ssd_scan(x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.ssd_scan.launches == before + 1
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    # the reference's bf16 tolerances: y 3e-2, state 5e-4
    for yr, hr in (ref.ssd(x, dt, A, B, C),
                   ssd_scan.ssd_scan_reference(x, dt, A, B, C, chunk=chunk)):
        torch.testing.assert_close(y.float(), yr.float(), atol=3e-2,
                                   rtol=3e-2)
        torch.testing.assert_close(h, hr, atol=5e-4, rtol=5e-4)


def test_ssd_variant_rule_on_the_card(cuda):
    """bf16 that TMA cannot read (a base 8 bytes past a 16-byte boundary)
    goes to the FP32 kernel, chosen before the launch, and agrees too."""
    from repro_torch.kernels import ref, ssd_scan
    case = (1, 4, 1, 512, 64, 64, 128, "bfloat16")
    x, dt, A, B, C = _ssd_inputs(case, cuda, main_layout=True)
    assert ssd_scan.pick_variant(x, B, C, 128) == "wgmma"
    wide = torch.zeros((1, 4, 512 + 1, 64), dtype=torch.bfloat16,
                       device=cuda)
    shifted = wide.view(-1)[4:4 + x.numel()].view(1, 4, 512, 64)
    shifted.copy_(x)
    assert ssd_scan.pick_variant(shifted, B, C, 128) == "fma"
    assert ssd_scan.tile_for(shifted, B, C, 128).variant == "fma"
    y, h = kops.ssd_scan(shifted, dt, A, B, C, chunk=128)
    yw, hw = kops.ssd_scan(x, dt, A, B, C, chunk=128)
    yr, hr = ref.ssd(x, dt, A, B, C)
    for a, b in ((y, yr), (yw, yr)):
        torch.testing.assert_close(a.float(), b.float(), atol=3e-2, rtol=3e-2)
    for a in (h, hw):
        torch.testing.assert_close(a, hr, atol=5e-4, rtol=5e-4)
    # f32 and mixed types stay on the FP32 kernel
    assert ssd_scan.pick_variant(x.float(), B.float(), C.float(), 128) \
        == "fma"
    assert ssd_scan.pick_variant(x, B.float(), C.float(), 128) == "fma"


def test_ssd_kernel_refuses_autograd(cuda):
    x, dt, A, B, C = _ssd_inputs((1, 2, 1, 64, 16, 16, 64, "float32"), cuda)
    with pytest.raises(NotImplementedError, match="backward"):
        kops.ssd_scan(x.requires_grad_(), dt, A, B, C, chunk=64)


@pytest.mark.parametrize("name", ["mamba2-370m", "zamba2-2.7b"])
def test_ssm_bf16_forward_through_the_wgmma_kernel(name, cuda, monkeypatch):
    """bf16 forward of the reduced configs, widened to P 32, the full d_state
    and chunk 64 so that every layer's scan lands on the tensor-core kernel,
    against the plain path: relative Frobenius error of the logits within
    the whole-step bf16 tolerance of chip_smoke.py (5e-2)."""
    from repro_torch.kernels import ssd_scan
    full = ARCHS[name]
    cfg = ARCHS[name].reduced()
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, head_dim=32, d_state=full.ssm.d_state, chunk=64))
    model = transformer.init_params(cfg, seed=0)
    tok = torch.randint(0, cfg.vocab_size, (2, 512), device=cuda)
    seen, pick = [], ssd_scan.pick_variant
    monkeypatch.setattr(ssd_scan, "pick_variant",
                        lambda *a, **k: seen.append(pick(*a, **k)) or seen[-1])
    before = ssd_scan.ssd_scan.launches
    with torch.no_grad():
        a, _ = transformer.forward(model, cfg, {"tokens": tok})
        assert ssd_scan.ssd_scan.launches == before + cfg.n_layers
        assert seen == ["wgmma"] * cfg.n_layers
        with flags.use_kernels(False):
            b, _ = transformer.forward(model, cfg, {"tokens": tok})
    assert a.dtype == torch.bfloat16 and bool(torch.isfinite(a).all())
    rel = float((a.float() - b.float()).norm() / b.float().norm())
    assert rel <= 5e-2


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


# ---------------------------------------------------------------------------
# matmul and transpose
# ---------------------------------------------------------------------------

MM_CASES = [
    # M, K, N, block, dtype, layout of a and b, the kernel that serves it:
    # the reference's table, then the paper's 16³ tile, ragged edges, bf16
    # ragged, and the layouts of each copy path and each kernel (as in
    # chip_smoke.py MM_CASES)
    (256, 384, 512, 128, "float32", "contig", "fma128"),
    (128, 128, 128, 128, "float32", "contig", "fma128"),
    (512, 256, 256, 64, "float32", "contig", "fma128"),
    (256, 2048, 256, 128, "float32", "contig", "fma128"),   # skinny
    (256, 256, 256, 128, "bfloat16", "contig", "wgmma"),
    (256, 256, 256, 16, "float32", "contig", "paper16"),
    (100, 77, 53, 16, "float32", "contig", "paper16"),
    (1000, 333, 257, 128, "float32", "contig", "fma128"),
    (129, 65, 191, 64, "bfloat16", "contig", "fma128"),
    (200, 96, 144, 16, "float32", "offset", "paper16"),     # base + 4 bytes
    (300, 160, 200, 128, "float32", "offset", "fma128"),
    (130, 70, 90, 16, "float32", "stride", "paper16"),      # ld % 4 == 3
    (260, 150, 270, 128, "float32", "stride", "fma128"),
    (64, 61, 48, 16, "float32", "contig", "paper16"),       # K % 4 != 0
    (256, 61, 256, 128, "float32", "contig", "fma128"),
    (48, 62, 40, 16, "float32", "pad8", "paper16"),         # 16-byte, ragged K
    (200, 100, 150, 128, "float32", "pad8", "fma128"),      # 16-byte, ragged N
    (300, 200, 264, 128, "bfloat16", "contig", "wgmma"),  # ragged M/N/K
    (333, 77, 150, 128, "bfloat16", "pad8", "wgmma"),
    (200, 96, 136, 128, "bfloat16", "offset", "fma128"),   # TMA cannot read
    (100, 40, 72, 16, "bfloat16", "offset", "paper16"),
]


def _mm_operand(x, layout):
    """``x`` copied into the layout a case names: contig, offset (base one
    element past a 16-byte boundary), stride (leading stride cols + 3),
    pad8 (leading stride a multiple of 8, 8 past the row)."""
    rows, cols = x.shape
    extra = {"contig": 0, "offset": 1, "stride": 3,
             "pad8": -cols % 8 + 8}[layout]
    wide = torch.zeros((rows, cols + extra), dtype=x.dtype, device=x.device)
    view = wide[:, 1:] if layout == "offset" else wide[:, :cols]
    view.copy_(x)
    return view


def _mm_inputs(case, device, seed=0):
    M, K, N, _, dtype = case[:5]
    layout = case[5] if len(case) > 5 else "contig"
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    return [_mm_operand(torch.from_numpy(rng.standard_normal(s)
                                         .astype(np.float32))
                        .to(device=device, dtype=dt), layout)
            for s in ((M, K), (K, N))]


@pytest.mark.parametrize("case", MM_CASES,
                         ids=[f"mm{i}" for i in range(len(MM_CASES))])
def test_matmul_kernel_matches_plain_version(case, cuda):
    from repro_torch.kernels import matmul as mm
    a, b = _mm_inputs(case, cuda)
    blk, dtype, want = case[3], case[4], case[6]
    assert mm.tile_for(a, b, blk, blk, blk).variant == want
    before = mm.matmul.launches
    o = kops.matmul(a, b, block_m=blk, block_n=blk, block_k=blk)
    torch.cuda.synchronize()
    assert mm.matmul.launches == before + 1
    r = mm.matmul_reference(a, b)
    assert o.dtype == a.dtype and o.shape == r.shape and o.is_contiguous()
    # the reference's own tolerances: f32 atol 1e-3 / rtol 1e-5 (IEEE f32
    # products; TF32 would miss it), bf16 atol 1.0 / rtol 3e-2
    tol = dict(atol=1.0, rtol=3e-2) if dtype == "bfloat16" \
        else dict(atol=1e-3, rtol=1e-5)
    torch.testing.assert_close(o.float(), r.float(), **tol)


def test_matmul_takes_a_leading_stride_and_refuses_columns(cuda):
    from repro_torch.kernels import matmul as mm
    a, b = _mm_inputs((64, 96, 80, 16, "float32"), cuda)
    wide = torch.zeros(64, 128, device=cuda)
    wide[:, :96] = a
    o = kops.matmul(wide[:, :96], b, block_m=16, block_n=16, block_k=16)
    torch.testing.assert_close(o, mm.matmul_reference(a, b), atol=1e-3,
                               rtol=1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        kops.matmul(a.t().contiguous().t(), b)
    with pytest.raises(TypeError):
        kops.matmul(a.half(), b.half())
    with pytest.raises(NotImplementedError, match="backward"):
        kops.matmul(a.requires_grad_(), b)


@pytest.mark.parametrize("req,dtype,want", [
    ((16, 16, 16), "float32", (16, 16, 16, "paper16")),   # the paper's tile
    ((16, 16, 16), "bfloat16", (16, 16, 16, "paper16")),
    ((128, 128, 128), "float32", (128, 128, 32, "fma128")),
    ((128, 128, 128), "bfloat16", (128, 256, 64, "wgmma")),
    ((64, 64, 64), "float32", (128, 128, 32, "fma128")),  # nearer 128
    ((32, 32, 32), "float32", (16, 16, 16, "paper16")),   # nearer 16
    ((256, 256, 256), "bfloat16", (128, 256, 64, "wgmma")),
])
def test_matmul_tile_reports(req, dtype, want, cuda):
    from repro_torch.kernels import matmul as mm
    t = mm.tile(4096, 4096, 4096, *req, dtype=getattr(torch, dtype))
    assert (t.bm, t.bn, t.bk, t.variant) == want
    assert 3 <= t.stages <= 4
    assert 0 < t.smem <= 227 * 1024
    # a block clipped to a small dimension gets the small tile
    assert mm.tile(16, 16, 4096, 128, 128, 128)[:3] == (16, 16, 16)
    with pytest.raises(ValueError, match="no tile"):
        mm.tile(0, 16, 16)


@pytest.mark.parametrize("lda,ldb,a_ptr,b_ptr,want", [
    (4096, 4096, 0, 0, "wgmma"),
    (4104, 4352, 256, 1024, "wgmma"),   # strided, aligned
    (4096, 4096, 2, 0, "fma128"),          # base of a off by one element
    (4096, 4096, 0, 8, "fma128"),          # base of b 8 bytes past 16
    (4097, 4096, 0, 0, "fma128"),          # rows of a not 16-byte multiples
    (4096, 4100, 0, 0, "fma128"),          # rows of b not 16-byte multiples
])
def test_matmul_bf16_variant_rule(lda, ldb, a_ptr, b_ptr, want, cuda):
    """bf16 at the large tile takes the tensor-core kernel where TMA can
    read both inputs, and the FP32-pipe kernel otherwise; f32 and the 16³
    request never take it."""
    from repro_torch.kernels import matmul as mm
    kw = dict(lda=lda, ldb=ldb, a_ptr=a_ptr, b_ptr=b_ptr)
    assert mm.tile(4096, 4096, 4096, dtype=torch.bfloat16,
                   **kw).variant == want
    assert mm.tile(4096, 4096, 4096, **kw).variant == "fma128"
    # fma128 reads A 16 bytes at a time (k steps of 32) where its layout
    # allows, else one element at a time (k steps of 16)
    assert mm.tile(4096, 4096, 4096, **kw).bk == (32 if lda % 4 == 0
                                                  and a_ptr % 16 == 0
                                                  else 16)
    assert mm.tile(4096, 4096, 4096, 16, 16, 16, dtype=torch.bfloat16,
                   **kw).variant == "paper16"


TR_CASES = [
    # (M, N), block, dtype, layout, the variant it lands on: the reference's
    # three, then the paper's 16, bf16, ragged, and the layouts of each
    # kernel (as in chip_smoke.py TR_CASES)
    ((256, 256), 128, "float32", "contig", "scalar"),
    ((512, 256), 128, "float32", "contig", "scalar"),
    ((128, 384), 64, "float32", "contig", "scalar"),
    ((256, 512), 16, "float32", "contig", "vec16"),
    ((384, 256), 32, "bfloat16", "contig", "scalar"),
    ((100, 77), 16, "float32", "contig", "scalar"),
    ((333, 1000), 256, "bfloat16", "contig", "scalar"),
    ((384, 256), 16, "bfloat16", "contig", "vec16"),
    ((100, 64), 16, "float32", "contig", "vec16"),      # ragged, whole accesses
    ((104, 40), 16, "bfloat16", "contig", "vec16"),
    ((256, 512), 16, "float32", "offset", "scalar"),    # base + 4 bytes
    ((384, 256), 16, "bfloat16", "offset", "scalar"),
    ((256, 512), 16, "float32", "stride", "scalar"),    # leading stride N + 3
    ((256, 512), 16, "float32", "pad", "vec16"),        # leading stride N + 8
    ((2048, 2048), 16, "float32", "contig", "vec16"),   # the calibration's
]


def _tr_input(shape, dtype, layout, device):
    M, N = shape
    dt = getattr(torch, dtype)
    if layout == "offset":
        return torch.randn(M * N + 1, device=device).to(dt)[1:].view(M, N)
    extra = {"contig": 0, "stride": 3, "pad": 8}[layout]
    return torch.randn(M, N + extra, device=device).to(dt)[:, :N]


@pytest.mark.parametrize("case", TR_CASES,
                         ids=[f"tr{i}" for i in range(len(TR_CASES))])
def test_transpose_kernel_is_exact(case, cuda):
    from repro_torch.kernels import transpose as tr
    shape, blk, dtype, layout, want = case
    x = _tr_input(shape, dtype, layout, cuda)
    assert tr.pick_variant(x, blk) == want == tr.tile_for(x, blk).variant
    before = tr.transpose.launches
    o = kops.transpose(x, block=blk)
    torch.cuda.synchronize()
    assert tr.transpose.launches == before + 1
    assert o.is_contiguous() and torch.equal(o, tr.transpose_reference(x))
    if want == "scalar" and blk < 32:   # vec16 is refused, not replaced
        with pytest.raises(RuntimeError, match="CUDA error"):
            tr.transpose(x, block=blk, variant="vec16")
        assert tr.transpose.launches == before + 1


@pytest.mark.parametrize("variant", ["scalar", "vec16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transpose_named_variants_are_exact(variant, dtype, cuda):
    from repro_torch.kernels import transpose as tr
    x = _tr_input((104, 40), dtype, "contig", cuda)
    o = tr.transpose(x, block=16, variant=variant)
    torch.cuda.synchronize()
    assert torch.equal(o, tr.transpose_reference(x))


@pytest.mark.parametrize("block,variant,dtype,want", [
    (16, "scalar", "float32", (16, 256, 16 * 17 * 4)),
    (32, "scalar", "float32", (32, 256, 32 * 33 * 4)),
    (64, "scalar", "float32", (64, 256, 64 * 65 * 4)),
    (256, "scalar", "float32", (64, 256, 64 * 65 * 4)),
    (8, "scalar", "bfloat16", (16, 256, 16 * 17 * 2)),
    (16, "vec16", "float32", (16, 64, 1024)),
    (16, "vec16", "bfloat16", (16, 32, 512)),
])
def test_transpose_tile_reports(block, variant, dtype, want, cuda):
    from repro_torch.kernels import transpose as tr
    t = tr.tile(block, getattr(torch, dtype), variant)
    assert t.variant == variant and (t.edge, t.threads, t.smem) == want
    with pytest.raises(ValueError, match="no tile"):
        tr.tile(0)
    with pytest.raises(ValueError, match="no tile"):
        tr.tile(32, variant="vec16")   # vec16 is the 16 tile only


# ---------------------------------------------------------------------------
# the training path: the row log-sum-exp, the Functions' gradients, a step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", FA_CASES,
                         ids=[f"fa{i}" for i in range(len(FA_CASES))])
def test_cuda_kernel_lse_matches_plain_version(case, cuda):
    """The row log-sum-exp both attention kernels write against the plain
    version's: f32 1e-4, bf16 2e-2 (the kernels' own output tolerances)."""
    q, k, v = _qkv(case, cuda)
    causal, window, dtype = case[6], case[7], case[8]
    o, lse = kops.flash_attention(q, k, v, causal=causal, window=window,
                                  return_lse=True)
    torch.cuda.synchronize()
    r, rlse = fa.attention_reference(q, k, v, causal=causal, window=window,
                                     return_lse=True)
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    assert lse.shape == q.shape[:3] and lse.dtype == torch.float32
    torch.testing.assert_close(lse, rlse, atol=tol, rtol=tol)
    torch.testing.assert_close(o.float(), r.float(), atol=tol, rtol=tol)


def _rel(a, b) -> float:
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 96], ids=["causal", "window"])
def test_flash_attention_function_gradients_match_the_cpu(dtype, window,
                                                          cuda):
    """``_FlashAttention`` on the card (the kernel's forward and lse) against
    the same Function on the CPU (the plain forward): dq, dk, dv, relative
    Frobenius 1e-5 (f32) / 2e-2 (bf16, the kernel rounds P to bf16)."""
    from repro_torch.models import attention as attn
    rng = np.random.default_rng(3)
    dt = getattr(torch, dtype)
    shapes = [(2, 512, 8, 64), (2, 512, 2, 64), (2, 512, 2, 64),
              (2, 512, 8, 64)]
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = {}
    for dev in ("cpu", cuda):
        ts = [torch.from_numpy(a).to(device=dev, dtype=dt).requires_grad_()
              for a in arrs[:3]]
        before = fa.flash_attention.launches
        o = attn._FlashAttention.apply(*ts, window, 256, 128, True)
        o.backward(torch.from_numpy(arrs[3]).to(device=dev, dtype=dt))
        assert fa.flash_attention.launches == before + (dev != "cpu")
        grads[str(dev)] = [o] + [t.grad for t in ts]
    tol = 1e-5 if dtype == "float32" else 2e-2
    for name, a, b in zip(("o", "dq", "dk", "dv"), grads["cuda"],
                          grads["cpu"]):
        assert a.dtype == dt
        assert _rel(a, b) <= tol, (name, _rel(a, b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_function_gradients_match_the_cpu(dtype, cuda):
    """``_SSDScan`` on the card (the kernel's forward; the backward
    recomputes the plain chunked math on the card) against the same
    Function on the CPU: y and the gradients of x, dt, A, B, C, relative
    Frobenius 1e-5 (f32) / 1e-2 (bf16)."""
    from repro_torch.models import ssm
    from repro_torch.kernels import ssd_scan as ssd
    rng = np.random.default_rng(4)
    Bz, H, G, L, P, N, chunk = 2, 4, 1, 256, 64, 64, 128
    dt_ = getattr(torch, dtype)
    arrs = [rng.standard_normal((Bz, H, L, P)).astype(np.float32),
            (0.05 + 0.1 * rng.random((Bz, H, L))).astype(np.float32),
            -(0.5 + rng.random(H)).astype(np.float32),
            rng.standard_normal((Bz, G, L, N)).astype(np.float32),
            rng.standard_normal((Bz, G, L, N)).astype(np.float32),
            rng.standard_normal((Bz, H, L, P)).astype(np.float32)]
    types = (dt_, torch.float32, torch.float32, dt_, dt_)
    out = {}
    for dev in ("cpu", cuda):
        ts = [torch.from_numpy(a).to(device=dev, dtype=t).requires_grad_()
              for a, t in zip(arrs[:5], types)]
        before = ssd.ssd_scan.launches
        y = ssm._SSDScan.apply(*ts, chunk)
        y.backward(torch.from_numpy(arrs[5]).to(device=dev, dtype=dt_))
        assert ssd.ssd_scan.launches == before + (dev != "cpu")
        out[str(dev)] = [y] + [t.grad for t in ts]
    tol = 1e-5 if dtype == "float32" else 1e-2
    for name, a, b in zip(("y", "x", "dt", "A", "B", "C"), out["cuda"],
                          out["cpu"]):
        assert _rel(a, b) <= tol, (name, _rel(a, b))


@pytest.mark.parametrize("name", ["llama3.2-3b", "zamba2-2.7b"])
def test_train_step_through_the_kernels_matches_the_plain_path(name, cuda):
    """One ``make_train_step`` (adamw, remat full) at reduced size in f32
    with the kernels against the same step under ``use_kernels(False)``:
    loss and gradient norm rtol 1e-4, the updated parameters 1e-5; the
    kernels launched twice a layer (forward and the remat recompute)."""
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.optim import optimizers as opt
    from repro_torch.runtime import steps
    cfg = dataclasses.replace(ARCHS[name].reduced(), param_dtype="float32",
                              compute_dtype="float32")
    rng = np.random.default_rng(5)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)))
             .to(cuda) for k in ("tokens", "labels")}
    results = []
    for kernels in (True, False):
        optimizer = opt.adamw()
        state = steps.init_train_state(
            cfg, torch.Generator(cuda).manual_seed(0), optimizer, cuda)
        step = steps.make_train_step(cfg, optimizer)
        before = (fa.flash_attention.launches, ssd.ssd_scan.launches)
        with flags.use_kernels(kernels):
            state, m = step(state, batch)
        torch.cuda.synchronize()
        launched = (fa.flash_attention.launches - before[0],
                    ssd.ssd_scan.launches - before[1])
        results.append((state, m, launched))
    (sk, mk, lk), (sp, mp, lp) = results
    sites = cfg.n_layers // cfg.hybrid.attn_every \
        if cfg.family == "hybrid" else cfg.n_layers
    assert lk == (2 * sites, 2 * cfg.n_layers if cfg.family != "dense"
                  else 0) and lp == (0, 0)
    np.testing.assert_allclose(float(mk["loss"]), float(mp["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(mk["grad_norm"]), float(mp["grad_norm"]),
                               rtol=1e-4)
    for (n, a), b in zip(sk.params.named_parameters(),
                         sp.params.parameters()):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4, msg=n)


# ---------------------------------------------------------------------------
# the mixture-of-experts, vision-language and audio families


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_on_the_card_matches_the_cpu(dtype, cuda):
    """The same weights and tokens on the card and on the CPU: the same
    routing (computed in f32 from the same inputs), the output 1e-4 (f32) /
    relative 2e-2 (bf16: other bf16 roundings of the expert products), the
    aux loss 1e-5."""
    from repro_torch.models import moe
    cfg = dataclasses.replace(ARCHS["mixtral-8x7b"].reduced(),
                              param_dtype=dtype, compute_dtype=dtype)
    tdt = getattr(torch, dtype)
    p_cpu = moe.MoE(cfg, tdt, "cpu", torch.Generator("cpu").manual_seed(0))
    p_gpu = moe.MoE(cfg, tdt, cuda, torch.Generator(cuda).manual_seed(0))
    p_gpu.load_state_dict(p_cpu.state_dict())
    x = torch.randn(2, 64, cfg.d_model,
                    generator=torch.Generator("cpu").manual_seed(1)).to(tdt)
    with torch.no_grad():
        a, aux_a = moe.moe_apply(p_gpu, x.to(cuda), cfg)
        b, aux_b = moe.moe_apply(p_cpu, x, cfg)
        ra, rb = moe.routing(p_gpu, x.to(cuda), cfg), \
            moe.routing(p_cpu, x, cfg)
    assert torch.equal(ra.experts.cpu(), rb.experts)
    assert torch.equal(ra.keep.cpu(), rb.keep)
    if dtype == "float32":
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)
    else:
        assert _rel(a.cpu(), b) <= 2e-2, _rel(a.cpu(), b)
    torch.testing.assert_close(aux_a.cpu(), aux_b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["mixtral-8x7b", "qwen2-vl-7b",
                                  "musicgen-medium"])
def test_family_forward_on_the_card_matches_the_cpu_plain_path(name, cuda):
    """A reduced f32 model of each family through the attention kernel on
    the card (one launch a layer) against the same weights on the CPU's
    plain path, 1e-4; the aux loss 1e-5."""
    cfg = dataclasses.replace(ARCHS[name].reduced(), param_dtype="float32",
                              compute_dtype="float32")
    model = transformer.init_params(cfg, seed=0)  # device defaults to cuda
    cpu = transformer.init_params(cfg, device="cpu", seed=0)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    g = torch.Generator("cpu").manual_seed(2)
    shape = (2, 48, cfg.n_input_codebooks) if cfg.n_input_codebooks > 1 \
        else (2, 48)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, shape, generator=g)}
    if cfg.vision_tokens:
        batch["vision_embeds"] = 0.02 * torch.randn(
            2, cfg.vision_tokens, cfg.d_model, generator=g)
    before = fa.flash_attention.launches
    with torch.no_grad():
        a, aux_a = transformer.forward(
            model, cfg, {k: v.to(cuda) for k, v in batch.items()})
        assert fa.flash_attention.launches == before + cfg.n_layers
        with flags.use_kernels(False):
            b, aux_b = transformer.forward(cpu, cfg, batch)
    torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(aux_a.cpu(), aux_b, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the autotuner on the card: the Python tile mirrors against the C queries,
# and block_sizes="auto" through the kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("aligned", [True, False])
def test_matmul_tile_rule_mirrors_the_c_query(dtype, aligned, cuda):
    from repro_torch.kernels import matmul as mm
    dt = getattr(torch, dtype)
    for M, N, req in ((4096, 4096, 16), (4096, 4096, 128), (8, 8, 128),
                      (64, 64, 128), (32, 32, 128), (100, 3000, 64),
                      (1024, 512, 256)):
        lda = 4096 if aligned else 4097   # rows of 4097: not 16 bytes
        t = mm.tile(M, N, 4096, req, req, req, dtype=dt, lda=lda, ldb=N)
        by = 2 if dt == torch.bfloat16 else 4
        assert t == mm.tile_rule(M, N, req, req, req, bf16=by == 2,
                                 va=lda * by % 16 == 0,
                                 vb=N * by % 16 == 0)


def test_attention_tile_mirrors_the_c_queries(cuda):
    for dh in range(4, 129, 4):
        assert fa.tile(dh) == fa.tile_rule(dh)
        for bq in fa.TILES:
            for bk in fa.TILES:
                nbytes = fa.smem_bytes(bq, bk, dh)
                if nbytes > fa.SMEM_LIMIT:
                    with pytest.raises(ValueError):
                        fa.f32_tile(bq, bk, dh)
                else:
                    assert fa.f32_tile(bq, bk, dh) == nbytes


def test_ssd_and_transpose_tile_rules_mirror_the_c_queries(cuda):
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels import transpose as tr
    for P in (16, 32, 48, 64, 80, 128, 256):
        for N in (16, 32, 64, 96, 128):
            for chunk in (16, 32, 64, 100, 128, 256):
                for variant in ssd.VARIANTS:
                    try:
                        want = ssd.tile_rule(P, N, chunk, variant)
                    except ValueError:
                        with pytest.raises(ValueError):
                            ssd.tile(P, N, chunk, variant)
                        continue
                    assert ssd.tile(P, N, chunk, variant) == want
    for dtype in (torch.float32, torch.bfloat16):
        for block in (1, 16, 31, 32, 48, 64, 256):
            for variant in tr.VARIANTS:
                if variant == "vec16" and block >= 32:
                    with pytest.raises(ValueError):
                        tr.tile(block, dtype, variant)
                    continue
                assert tr.tile(block, dtype, variant) \
                    == tr.tile_rule(block, dtype, variant)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_auto_through_every_wrapper_launches_the_kernel(dtype, cuda):
    """``block_sizes="auto"`` on CUDA tensors: the card's model picks a
    tile, the kernel runs it, and the result is the plain version's."""
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels import transpose as tr
    dt = getattr(torch, dtype)
    g = torch.Generator(cuda).manual_seed(0)
    a = torch.randn(512, 256, device=cuda, generator=g).to(dt)
    b = torch.randn(256, 384, device=cuda, generator=g).to(dt)
    before = mm.matmul.launches
    o = kops.matmul(a, b, block_sizes="auto")
    assert mm.matmul.launches == before + 1
    tol = dict(atol=1e-3, rtol=1e-5) if dt == torch.float32 \
        else dict(atol=1.0, rtol=3e-2)
    torch.testing.assert_close(o.float(), mm.matmul_reference(a, b).float(),
                               **tol)
    before = tr.transpose.launches
    assert torch.equal(kops.transpose(a, block_sizes="auto"), a.t())
    assert tr.transpose.launches == before + 1
    case = (2, 4, 2, 256, 256, 64, True, None, dtype)
    q, k, v = _qkv(case, cuda)
    before = fa.flash_attention.launches
    o = kops.flash_attention(q, k, v, block_sizes="auto")
    assert fa.flash_attention.launches == before + 1
    torch.testing.assert_close(
        o.float(), fa.attention_reference(q, k, v).float(),
        **(dict(atol=2e-2, rtol=2e-2) if dt == torch.bfloat16
           else dict(atol=1e-4, rtol=1e-4)))
    x, dt_, A, B, C = _ssd_inputs((2, 4, 1, 512, 64, 64, 128, dtype), cuda,
                                  bc_dtype=dtype)
    chunk = kops.ssd_chunk(x, B, C, block_sizes="auto")
    before = ssd.ssd_scan.launches
    y, h = kops.ssd_scan(x, dt_, A, B, C, block_sizes="auto")
    assert ssd.ssd_scan.launches == before + 1
    yp, hp = ssd.ssd_scan_reference(x, dt_, A, B, C, chunk=chunk)
    tol = dict(atol=3e-2, rtol=3e-2) if dt == torch.bfloat16 \
        else dict(atol=5e-4, rtol=5e-4)
    torch.testing.assert_close(y.float(), yp.float(), **tol)
    torch.testing.assert_close(h, hp, atol=5e-4, rtol=5e-4)
    if dt == torch.bfloat16:   # a tensor-core chunk under the card's seed
        assert ssd.pick_variant(x, B, C, chunk) == "wgmma"


# ---------------------------------------------------------------------------
# the autotuner's residency mirrors against the occupancy calculator;
# model admission


@pytest.fixture(scope="module")
def ptxas_logs():
    """Every source built once with ``-Xptxas -v``, its report written
    where ``chip_smoke.py``'s build phase writes it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no interpret mode")
    from repro_torch.kernels import _build
    logs = _build.build_all(extra_flags=("-Xptxas", "-v"), force=True)
    for name, log in logs.items():
        (_build.build_dir() / f"{name}.nvcc.log").write_text(log)
    return logs


@pytest.mark.parametrize("kernel,shape", [
    ("flash_attention", {"B": 4, "H": 24, "KVH": 24, "Sq": 2048,
                         "Skv": 2048, "dh": 64, "causal": True,
                         "window": None, "bits": 32}),
    ("flash_attention", {"B": 4, "H": 24, "KVH": 8, "Sq": 2048,
                         "Skv": 2048, "dh": 128, "causal": True,
                         "window": None, "bits": 16}),
    ("ssd_scan", {"Bz": 4, "H": 80, "L": 2048, "P": 64, "N": 64,
                  "bits": 16, "tma": True}),
    ("ssd_scan", {"Bz": 4, "H": 32, "L": 2048, "P": 64, "N": 128,
                  "bits": 32}),
    ("matmul", {"M": 4096, "N": 4096, "K": 4096, "bits": 16}),
    ("matmul", {"M": 4096, "N": 4096, "K": 4096, "bits": 32,
                "va": False}),
    ("transpose", {"M": 16384, "N": 16384, "bits": 32}),
    ("transpose", {"M": 16384, "N": 16384, "bits": 16}),
])
def test_residency_mirrors_equal_the_occupancy_calculator(kernel, shape,
                                                          cuda,
                                            ptxas_logs):
    """Every candidate's ``resident`` (the kernel modules' thread and
    register mirrors under ``kernelmodel.resident_blocks``) equals the
    CUDA occupancy calculator for the instance that runs it, and the
    registers equal this build's ``ptxas`` report."""
    import sys
    from pathlib import Path
    from repro_torch.core import kernelmodel
    from repro_torch.kernels import autotune
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    chip_smoke._PTXAS.clear()
    torch.zeros(1, device=cuda)
    km = kernelmodel.get(kernel)
    for blocks in autotune.candidate_configs(kernel, shape):
        row = chip_smoke.card_residency(
            kernel, shape, blocks, km.variant(shape, blocks),
            km.footprint(shape, blocks))
        assert row["occupancy_resident"] == blocks["resident"] >= 1
        assert row["registers"] == row["ptxas_registers"]


def test_model_admission_server_on_the_card(cuda):
    """A CUDA server admits shortest-predicted-job first through the card's
    model (``gpu-h100``, its datasheet seed from an empty registry) and
    predicts every span."""
    from repro_torch.obs import trace
    from repro_torch.runtime import server
    cfg = dataclasses.replace(ARCHS["llama3.2-3b"].reduced(),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    model = transformer.init_params(cfg, device=cuda, seed=0)
    srv = server.DecodeServer(cfg, model, slots=2, max_len=96, seed=0,
                              eos_id=-1, admission="model",
                              slo_decode_s=10.0)
    assert srv.scorer.model.device == "gpu-h100"
    rng = np.random.default_rng(0)
    for rid, plen in enumerate([24, 3, 9, 4]):
        srv.submit(server.Request(rid=rid, prompt=rng.integers(
            2, cfg.vocab_size, plen).astype(np.int32), max_new=3))
    tracer = trace.Tracer()
    prev = trace.get_tracer()
    trace.set_tracer(tracer)
    try:
        done = srv.run()
    finally:
        trace.set_tracer(prev)
    assert [r.rid for r in done][-1] == 0   # the long prompt goes last
    assert len(done) == 4 and all(len(r.out) == 3 for r in done)
    spans = [s for s in tracer.spans if s.name in ("prefill", "decode_step")]
    assert spans and all(s.predicted_s > 0 for s in spans)


def test_supervised_step_with_recovery_on_the_card(cuda, tmp_path):
    """A reduced trainer on the card under the ``Supervisor``: a device lost
    at step 4 rebuilds the trainer from the step-3 save after the old one
    was released, and the history equals an unsupervised run's at rtol
    1e-5; the attention kernel ran every step."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.runtime.faults import Fault, FaultInjector, FaultPlan
    from repro_torch.runtime.supervisor import BackoffPolicy, Supervisor
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    cfg = dataclasses.replace(ARCHS["llama3.2-3b"].reduced(),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=2,
                    seed=3)

    def tc(ckpt=None):
        return TrainerConfig(ckpt_dir=ckpt, ckpt_every=3, log_every=1000,
                             async_ckpt=False, save_on_exit=False,
                             total_steps=6)

    want = Trainer(cfg, dc, tc(), device=cuda).train(6)
    inj = FaultInjector(FaultPlan(faults=(Fault("device_loss", 4),)))
    before = fa.flash_attention.launches
    sup = Supervisor(lambda mesh: Trainer(cfg, dc, tc(str(tmp_path)),
                                          injector=inj, device=cuda),
                     6, injector=inj, sleep=lambda s: None,
                     backoff=BackoffPolicy(base_s=0.0, max_s=0.0))
    hist = sup.run()
    assert len(sup.recoveries) == 1 and sup.steps_run == 7
    assert fa.flash_attention.launches - before == 2 * cfg.n_layers * 7
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in want], rtol=1e-5)


def test_calibrated_decode_on_the_card(cuda):
    """A CUDA server feeds every decode iteration's synchronized seconds to
    an ``OnlineCalibrator`` warm-started from the card's model; an injected
    x5 slowdown of 8 iterations after a 20-iteration warm stretch raises a
    "slow" event and one refit."""
    from repro_torch.calibration.online import OnlineCalibrator
    from repro_torch.runtime import server
    from repro_torch.runtime.faults import Fault, FaultInjector, FaultPlan
    cfg = dataclasses.replace(ARCHS["llama3.2-3b"].reduced(),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    model = transformer.init_params(cfg, device=cuda, seed=0)
    cal = OnlineCalibrator("gpu-h100", phase="decode")
    inj = FaultInjector(FaultPlan(faults=(Fault("slowdown", 24, factor=5.0,
                                                duration=8),)))
    srv = server.DecodeServer(cfg, model, slots=2, max_len=128, seed=0,
                              eos_id=-1, calibrator=cal, injector=inj)
    rng = np.random.default_rng(0)
    for rid in range(2):
        srv.submit(server.Request(rid=rid, prompt=rng.integers(
            2, cfg.vocab_size, 4).astype(np.int32), max_new=40))
    done = srv.run()
    assert len(done) == 2 and cal.sink.stats()["n_recorded"] == 40
    assert all(s.phase == "decode" for s in cal.sink.samples())
    assert [e.direction for e in cal.events][:1] == ["slow"]
    assert cal.refits >= 1
