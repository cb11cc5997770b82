"""The port's SSM slice against the JAX package, on the CPU at reduced size:
the SSD oracle, the SSD-scan wrapper and its plain version, the Mamba2 mixer
and the ssm / hybrid models (``mamba2-370m``, ``zamba2-2.7b``).

The same numpy inputs, and the same parameters (``params_from_reference``),
go through both packages.  Tolerances: the reference's own for the SSD scan
(f32 5e-4 on outputs and states, bf16 3e-2) and 1e-4 for f32 model outputs
(two frameworks, other summation orders); bf16 model outputs 3e-2.  The JAX
side runs on its default path and under ``repro.runtime.flags.use_pallas()``
(the Pallas kernels in interpret mode).  The CUDA kernel itself has no
interpret mode: ``tests/test_torch_gpu.py`` and ``chip_smoke.py`` hold it
against the plain version on a card.
"""
from __future__ import annotations

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro.runtime import flags as jflags
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttransformer
from repro_torch.models.convert import SSM_F32, params_from_reference
from repro_torch.runtime import flags as tflags

torch.set_num_threads(1)

F32 = dict(param_dtype="float32", compute_dtype="float32")
TOL_F32 = dict(atol=1e-4, rtol=1e-4)
TOL_BF16 = dict(atol=3e-2, rtol=3e-2)
TOL_SSD = dict(atol=5e-4, rtol=5e-4)
SSM_ARCHS = ["mamba2-370m", "zamba2-2.7b"]

# the reference's table (tests/test_kernels.py)
SSD_CASES = [
    # Bz, H, G, L, P, N, chunk, dtype
    (2, 4, 1, 256, 32, 16, 64, "float32"),
    (1, 4, 2, 128, 64, 32, 32, "float32"),
    (2, 2, 2, 128, 16, 64, 128, "float32"),
    (1, 4, 1, 256, 64, 128, 64, "float32"),  # mamba2-370m-like ratios
    (2, 4, 1, 256, 32, 16, 64, "bfloat16"),
]
SSD_IDS = [f"ssd{i}" for i in range(len(SSD_CASES))]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ssd_inputs(Bz, H, G, L, P, N, dtype, seed=42):
    """numpy inputs drawn as the reference's ``_ssd_inputs`` draws them;
    x in ``dtype``, the rest f32.  -> (torch tensors, jax arrays)."""
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((Bz, H, L, P))).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bz, H, L)))).astype(np.float32)
    A = -np.exp(0.3 * rng.standard_normal(H)).astype(np.float32)
    B = (0.3 * rng.standard_normal((Bz, G, L, N))).astype(np.float32)
    C = (0.3 * rng.standard_normal((Bz, G, L, N))).astype(np.float32)
    t = [torch.from_numpy(a) for a in (x, dt, A, B, C)]
    t[0] = t[0].to(getattr(torch, dtype))
    j = [jnp.asarray(a) for a in (x, dt, A, B, C)]
    j[0] = j[0].astype(getattr(jnp, dtype))
    return t, j


def _ssd_tol(dtype):
    return TOL_BF16 if dtype == "bfloat16" else TOL_SSD


def _jax_path(pallas):
    return jflags.use_pallas() if pallas else contextlib.nullcontext()


def _cfgs(name, f32=True):
    kw = F32 if f32 else {}
    return (dataclasses.replace(JARCHS[name].reduced(), **kw),
            dataclasses.replace(TARCHS[name].reduced(), **kw))


def _both_models(jc, tc, seed=0):
    params, _ = jtransformer.init_params(jc, jax.random.PRNGKey(seed))
    model = ttransformer.init_params(tc, device="cpu", seed=seed)
    model.load_state_dict(
        params_from_reference(tc, jax.tree.map(np.asarray, params)))
    return params, model


# ---------------------------------------------------------------------------
# the SSD scan: oracle, plain version, wrapper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", SSD_CASES, ids=SSD_IDS)
def test_ssd_oracle_matches_reference_oracle(case):
    dtype = case[7]
    (x, dt, A, B, C), (jx, jdt, jA, jB, jC) = _ssd_inputs(*case[:6], dtype)
    y, h = tref.ssd(x, dt, A, B, C)
    yr, hr = jref.ssd(jx, jdt, jA, jB, jC)
    assert y.dtype == x.dtype and h.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(yr), **_ssd_tol(dtype))
    np.testing.assert_allclose(_np(h), _np(hr), **TOL_SSD)


@pytest.mark.parametrize("case", SSD_CASES, ids=SSD_IDS)
def test_ssd_wrapper_on_cpu_matches_pallas_interpret_and_oracle(case):
    chunk, dtype = case[6], case[7]
    (x, dt, A, B, C), (jx, jdt, jA, jB, jC) = _ssd_inputs(*case[:6], dtype)
    before = tssd.ssd_scan.launches
    y, h = tops.ssd_scan(x, dt, A, B, C, chunk=chunk)
    assert tssd.ssd_scan.launches == before  # plain version: no launch
    yp, hp = tssd.ssd_scan_reference(x, dt, A, B, C, chunk=chunk)
    assert torch.equal(y, yp) and torch.equal(h, hp)
    yk, hk = pallas_ssd(jx, jdt, jA, jB, jC, chunk=chunk, interpret=True)
    yr, hr = jref.ssd(jx, jdt, jA, jB, jC)
    for ry, rh in ((yk, hk), (yr, hr)):
        np.testing.assert_allclose(_np(y), _np(ry), **_ssd_tol(dtype))
        np.testing.assert_allclose(_np(h), _np(rh), **TOL_SSD)


@pytest.mark.parametrize("case", SSD_CASES + [
    (1, 2, 1, 200, 32, 16, 100, "float32")],  # chunk not a tile multiple
    ids=SSD_IDS + ["chunk100"])
def test_ssd_chunked_matches_reference_chunked(case):
    """The port's chunked plain path (the model's, under
    ``use_kernels(False)`` or on the CPU) against the reference's XLA path
    ``_ssd_chunked``, in the model's (B, L, H, ·) layout handed over as
    views."""
    chunk, dtype = case[6], case[7]
    (x, dt, A, B, C), (jx, jdt, jA, jB, jC) = _ssd_inputs(*case[:6], dtype)
    xm, dtm, Bm, Cm = (t.transpose(1, 2).contiguous() for t in (x, dt, B, C))
    y, h = tssd.ssd_scan_reference(xm.transpose(1, 2), dtm.transpose(1, 2),
                                   A, Bm.transpose(1, 2), Cm.transpose(1, 2),
                                   chunk=chunk)
    yr, hr = jssm._ssd_chunked(jx.transpose(0, 2, 1, 3),
                               jdt.transpose(0, 2, 1), jA,
                               jB.transpose(0, 2, 1, 3),
                               jC.transpose(0, 2, 1, 3), chunk)
    assert y.dtype == x.dtype and h.dtype == torch.float32
    np.testing.assert_allclose(_np(y.transpose(1, 2)), _np(yr),
                               **_ssd_tol(dtype))
    np.testing.assert_allclose(_np(h), _np(hr), **TOL_SSD)


def test_ssd_chunk_invariance():
    (x, dt, A, B, C), _ = _ssd_inputs(1, 2, 1, 256, 16, 16, "float32")
    outs = [tssd.ssd_scan_reference(x, dt, A, B, C, chunk=c)[0]
            for c in (32, 64, 128, 256)]
    for o in outs[1:]:
        np.testing.assert_allclose(_np(outs[0]), _np(o), atol=1e-4,
                                   rtol=1e-4)


def test_ref_module_exports_the_oracles():
    # every oracle of the reference's kernels/ref.py
    assert set(tref.__all__) == {"attention", "ssd", "matmul", "transpose"}


@pytest.mark.parametrize("case", SSD_CASES, ids=SSD_IDS)
def test_ssd_block_sizes_auto_matches_the_reference_auto(case):
    """``"auto"`` on a CPU tensor runs the plain version at the chunk the
    autotuner picks (the v5e seed over the CUDA grid, ``ops.ssd_chunk``),
    within the reference's tolerance of the reference's ``"auto"`` kernel
    in interpret mode."""
    Bz, H, G, L, P, N, _, dtype = case
    (x, dt, A, B, C), (jx, jdt, jA, jB, jC) = _ssd_inputs(Bz, H, G, L, P, N,
                                                          dtype)
    y, h = tops.ssd_scan(x, dt, A, B, C, block_sizes="auto")
    chunk = tops.ssd_chunk(x, B, C, block_sizes="auto")
    assert L % chunk == 0
    yp, hp = tssd.ssd_scan_reference(x, dt, A, B, C, chunk=chunk)
    assert torch.equal(y, yp) and torch.equal(h, hp)
    yr, hr = jops.ssd_scan(jx, jdt, jA, jB, jC, block_sizes="auto",
                           interpret=True)
    np.testing.assert_allclose(_np(y), _np(yr), **_ssd_tol(dtype))
    np.testing.assert_allclose(_np(h), _np(hr), **TOL_SSD)


def test_ssd_block_sizes_mapping_works():
    (x, dt, A, B, C), _ = _ssd_inputs(1, 2, 1, 64, 16, 16, "float32")
    a = tops.ssd_scan(x, dt, A, B, C, block_sizes={"chunk": 32})[0]
    b = tops.ssd_scan(x, dt, A, B, C, chunk=32)[0]
    assert torch.equal(a, b)
    with pytest.raises(TypeError):
        tops.ssd_scan(x, dt, A, B, C, block_sizes=3)


@pytest.mark.parametrize("bad", ["groups", "x_dtype", "dt_dtype", "bc_dtypes",
                                 "shape", "rank", "chunk"])
def test_ssd_wrapper_rejects_what_the_kernel_does_not_take(bad):
    (x, dt, A, B, C), _ = _ssd_inputs(1, 4, 2, 64, 16, 16, "float32")
    kw = {"chunk": 32}
    if bad == "groups":
        B = C = torch.zeros(1, 3, 64, 16)
    elif bad == "x_dtype":
        x = x.half()
    elif bad == "dt_dtype":
        dt = dt.bfloat16()
    elif bad == "bc_dtypes":
        C = C.bfloat16()
    elif bad == "shape":
        C = torch.zeros(1, 2, 64, 8)
    elif bad == "rank":
        x = x[0]
    elif bad == "chunk":
        kw["chunk"] = 48
    with pytest.raises((ValueError, TypeError)):
        tops.ssd_scan(x, dt, A, B, C, **kw)


def test_ssd_wrapper_on_a_cuda_tensor_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU")
    with pytest.raises((RuntimeError, AssertionError)):
        torch.zeros(1, device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        ttransformer.init_params(TARCHS["mamba2-370m"].reduced())
    with pytest.raises((RuntimeError, AssertionError)):
        tssm.init_ssm_state(TARCHS["zamba2-2.7b"].reduced(), 1,
                            torch.float32)  # device defaults to "cuda"


def test_wrappers_take_the_cost_model_argument():
    """``model=`` (a registry name or an in-memory model) is what
    ``"auto"`` scores through, as in the reference; without ``"auto"``
    nothing reads it."""
    from repro_torch.calibration.seeds import ANALYTIC_SEEDS
    (x, dt, A, B, C), _ = _ssd_inputs(1, 2, 1, 64, 16, 16, "float32")
    plain = tops.ssd_scan(x, dt, A, B, C, chunk=32)[0]
    for model in ("gpu-h100", ANALYTIC_SEEDS["gpu-h100"]()):
        c = tops.ssd_chunk(x, B, C, block_sizes="auto", model=model)
        y = tops.ssd_scan(x, dt, A, B, C, block_sizes="auto", model=model)[0]
        assert torch.equal(y, tssd.ssd_scan_reference(x, dt, A, B, C,
                                                      chunk=c)[0])
        assert torch.equal(tops.ssd_scan(x, dt, A, B, C, chunk=32,
                                         model=model)[0], plain)
        o = tops.flash_attention(x, x, x, block_sizes="auto", model=model)
        assert torch.equal(o, tops.flash_attention(x, x, x))


def test_kernel_source_is_in_the_package_and_not_built_on_import():
    from repro_torch.kernels import _build
    assert "ssd_scan" in _build.sources()
    assert (_build.CSRC / "ssd_scan.cu").exists()
    assert "ssd_scan" not in _build._libs or torch.cuda.is_available()


# ---------------------------------------------------------------------------
# the tensor-core kernel's variant rule and arithmetic (the kernel itself runs
# only on a card: tests/test_torch_gpu.py, chip_smoke.py)
# ---------------------------------------------------------------------------


def _main_path_views(cfg, S, *, offset=0, pad=0, dtype=torch.bfloat16):
    """x, B, C as ``ssm_apply`` hands them to the scan: column slices of the
    conv output (B, S, d_inner + 2·G·N), viewed as (B, H, S, P) and
    (B, G, S, N), on the meta device (nothing allocated); ``offset``
    elements past the start of their storage, rows ``pad`` elements wider."""
    s = cfg.ssm
    Bsz, din, G, N = 2, cfg.d_inner, s.n_groups, s.d_state
    width = din + 2 * G * N
    flat = torch.empty(Bsz * S * (width + pad) + offset, device="meta",
                       dtype=dtype)
    xbc = flat[offset:].view(Bsz, S, width + pad)[..., :width]
    xin, Bm, Cm = xbc.split([din, G * N, G * N], dim=-1)
    return (xin.reshape(Bsz, S, cfg.ssm_heads, s.head_dim).transpose(1, 2),
            Bm.reshape(Bsz, S, G, N).transpose(1, 2),
            Cm.reshape(Bsz, S, G, N).transpose(1, 2))


def _variant(views, chunk):
    # a meta tensor has no address: its base is the storage offset, from an
    # allocation that is itself aligned
    return tssd.pick_variant(*views, chunk, bases=[
        t.storage_offset() * t.element_size() for t in views])


@pytest.mark.parametrize("name", SSM_ARCHS)
def test_wgmma_variant_rule_takes_the_main_path_views(name):
    cfg = TARCHS[name]
    x, B, C = _main_path_views(cfg, 2048)
    assert x.stride()[2] == cfg.d_inner + 2 * cfg.ssm.n_groups \
        * cfg.ssm.d_state   # strided rows, handed over without a copy
    assert _variant((x, B, C), cfg.ssm.chunk) == "wgmma"
    assert _variant((x, B, C), 64) == "wgmma"
    # the training step's chunk under autograd: halves of 128 rows
    assert _variant((x, B, C), 256) == "wgmma"


@pytest.mark.parametrize("name", SSM_ARCHS)
@pytest.mark.parametrize("why", ["odd_base", "odd_stride", "float32",
                                 "mixed", "chunk100", "chunk32",
                                 "reduced_chunk16"])
def test_wgmma_variant_rule_sends_the_rest_to_the_fp32_kernel(name, why):
    cfg = TARCHS[name]
    chunk = cfg.ssm.chunk
    if why == "odd_base":        # 8 bytes past a 16-byte boundary
        views = _main_path_views(cfg, 2048, offset=4)
    elif why == "odd_stride":    # rows of a multiple of 4 elements, not 8
        views = _main_path_views(cfg, 2048, pad=4)
    elif why == "float32":
        views = _main_path_views(cfg, 2048, dtype=torch.float32)
    elif why == "mixed":         # x bf16, B and C f32
        x = _main_path_views(cfg, 2048)[0]
        views = (x,) + _main_path_views(cfg, 2048, dtype=torch.float32)[1:]
    elif why == "reduced_chunk16":
        cfg = cfg.reduced()
        views, chunk = _main_path_views(cfg, 64), cfg.ssm.chunk
    else:
        views = _main_path_views(cfg, 2000 if why == "chunk100" else 2048)
        chunk = int(why[5:])
    assert _variant(views, chunk) == "fma"


def _bf16_split(v: torch.Tensor):
    """An f32 tensor as the kernel feeds it to bf16 products: hi = bf16(v),
    lo = bf16(v - hi), both returned as f32 values."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def _emulate_wgmma_kernel(x, dt, A, B, C, chunk):
    """The tensor-core kernel's arithmetic on the CPU: x, B, C exact in bf16;
    S = C Bᵀ formed once; W, the state h and x·w_end each fed to a product
    as hi + lo bf16; every sum in f32; y = exp(cum) (C hᵀ) + W x; the chunk
    walked in the rows of its instance (``wgmma_rows``: 256 in halves of
    128).  -> (y f32, h_final f32)."""
    chunk = tssd.wgmma_rows(chunk)
    Bz, H, L, P = x.shape
    rep = H // B.shape[1]
    xf = x.float()
    Bf = B.float().repeat_interleave(rep, dim=1)
    Cf = C.float().repeat_interleave(rep, dim=1)
    tri = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    h = torch.zeros((Bz, H, P, B.shape[3]))
    ys = []
    for c0 in range(0, L, chunk):
        sl = slice(c0, c0 + chunk)
        xq, Bq, Cq, dtq = xf[:, :, sl], Bf[:, :, sl], Cf[:, :, sl], \
            dt[:, :, sl].float()
        cum = torch.cumsum(dtq * A[None, :, None], dim=-1)
        diff = torch.where(tri, cum[..., :, None] - cum[..., None, :],
                           torch.full_like(cum[..., None], -1e30))
        W = (Cq @ Bq.transpose(-1, -2)) * torch.exp(diff) * dtq[..., None, :]
        w_hi, w_lo = _bf16_split(W)
        h_hi, h_lo = _bf16_split(h)
        y = (Cq @ h_hi.transpose(-1, -2) + Cq @ h_lo.transpose(-1, -2)) \
            * torch.exp(cum)[..., None] + w_hi @ xq + w_lo @ xq
        wend = dtq * torch.exp(cum[..., -1:] - cum)
        xw_hi, xw_lo = _bf16_split(xq * wend[..., None])
        h = h * torch.exp(cum[..., -1])[..., None, None] \
            + xw_hi.transpose(-1, -2) @ Bq + xw_lo.transpose(-1, -2) @ Bq
        ys.append(y)
    return torch.cat(ys, dim=2), h


# the reference's cases the tensor-core kernel takes (chunk 64 or 128, P and
# N multiples of 16), in bf16: x, B and C rounded to bf16 for both packages
WGMMA_CASES = [c[:7] for i, c in enumerate(SSD_CASES) if c[6] in (64, 128)]
WGMMA_IDS = [SSD_IDS[i] for i, c in enumerate(SSD_CASES)
             if c[6] in (64, 128)]


def _bf16_inputs(case):
    (x, dt, A, B, C), _ = _ssd_inputs(*case[:6], "float32")
    x, B, C = (t.bfloat16() for t in (x, B, C))
    j = [jnp.asarray(_np(t)) for t in (x, dt, A, B, C)]
    j[0] = j[0].astype(jnp.bfloat16)
    return (x, dt, A, B, C), j


@pytest.mark.parametrize("case", WGMMA_CASES, ids=WGMMA_IDS)
def test_wgmma_arithmetic_matches_pallas_interpret_and_oracle(case):
    """The kernel's rounding (hi + lo bf16 operands) against the reference's
    Pallas kernel in interpret mode and its sequential oracle, at the
    reference's bf16 tolerances: y 3e-2, h_final 5e-4."""
    (x, dt, A, B, C), (jx, jdt, jA, jB, jC) = _bf16_inputs(case)
    assert tssd.pick_variant(x, B, C, case[6]) == "wgmma"
    y, h = _emulate_wgmma_kernel(x, dt, A, B, C, case[6])
    yk, hk = pallas_ssd(jx, jdt, jA, jB, jC, chunk=case[6], interpret=True)
    yr, hr = jref.ssd(jx, jdt, jA, jB, jC)
    for ry, rh in ((yk, hk), (yr, hr)):
        np.testing.assert_allclose(_np(y.bfloat16()), _np(ry), **TOL_BF16)
        np.testing.assert_allclose(_np(h), _np(rh), **TOL_SSD)


@pytest.mark.parametrize("case", WGMMA_CASES, ids=WGMMA_IDS)
def test_wgmma_arithmetic_matches_the_plain_version_in_f32(case):
    """The same against the port's plain version on the same bf16 values in
    f32, before any output rounding: 1e-4, the class of f32 arithmetic.  The
    hi + lo split stays within 7 % of it; a single bf16 rounding of W, h or
    x·w_end instead misses it by about 70×, 40× and 20× on these cases."""
    (x, dt, A, B, C), _ = _bf16_inputs(case)
    y, h = _emulate_wgmma_kernel(x, dt, A, B, C, case[6])
    yp, hp = tssd.ssd_scan_reference(x.float(), dt, A, B.float(), C.float(),
                                     chunk=case[6])
    torch.testing.assert_close(y, yp, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(h, hp, atol=1e-4, rtol=1e-4)


# chunk 256, the training step's under autograd, at the reduced configs'
# SSM shape (both SSM architectures reduce to H 8, P 16, N 16, G 1)
CHUNK256_CASE = (2, 8, 1, 512, 16, 16, 256)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_plain_version_at_chunk_256_matches_the_reference(dtype):
    """The port's plain version at chunk 256 against the reference's
    ``_ssd_chunked`` and its Pallas kernel in interpret mode at chunk 256,
    at the reference's tolerances (y f32 5e-4, bf16 3e-2; h_final 5e-4)."""
    cfg = TARCHS["zamba2-2.7b"].reduced()
    s = cfg.ssm
    assert CHUNK256_CASE[1:6] == (cfg.ssm_heads, s.n_groups, 512, s.head_dim,
                                  s.d_state)
    (x, dt, A, B, C), (jx, jdt, jA, jB, jC) = _ssd_inputs(*CHUNK256_CASE[:6],
                                                          dtype)
    y, h = tssd.ssd_scan_reference(x, dt, A, B, C, chunk=256)
    yc, hc = jssm._ssd_chunked(jx.transpose(0, 2, 1, 3),
                               jdt.transpose(0, 2, 1), jA,
                               jB.transpose(0, 2, 1, 3),
                               jC.transpose(0, 2, 1, 3), 256)
    yk, hk = pallas_ssd(jx, jdt, jA, jB, jC, chunk=256, interpret=True)
    for ry, rh in ((yc.transpose(0, 2, 1, 3), hc), (yk, hk)):
        np.testing.assert_allclose(_np(y), _np(ry), **_ssd_tol(dtype))
        np.testing.assert_allclose(_np(h), _np(rh), **TOL_SSD)


def test_wgmma_halves_at_chunk_256_match_pallas_interpret_and_oracle():
    """The tensor-core kernel's arithmetic at chunk 256 (two halves of 128
    rows, the hi + lo operands) against the reference's Pallas kernel in
    interpret mode at chunk 256 and its sequential oracle, at the
    reference's bf16 tolerances: y 3e-2, h_final 5e-4."""
    (x, dt, A, B, C), (jx, jdt, jA, jB, jC) = _bf16_inputs(CHUNK256_CASE)
    assert tssd.pick_variant(x, B, C, 256) == "wgmma"
    y, h = _emulate_wgmma_kernel(x, dt, A, B, C, 256)
    yk, hk = pallas_ssd(jx, jdt, jA, jB, jC, chunk=256, interpret=True)
    yr, hr = jref.ssd(jx, jdt, jA, jB, jC)
    for ry, rh in ((yk, hk), (yr, hr)):
        np.testing.assert_allclose(_np(y.bfloat16()), _np(ry), **TOL_BF16)
        np.testing.assert_allclose(_np(h), _np(rh), **TOL_SSD)


def test_wgmma_halves_match_the_plain_version_at_chunk_256_in_f32():
    """The halves against the port's plain version at chunk 256 (one
    256-step chunk) on the same bf16 values in f32: 1e-4, the class of f32
    arithmetic; the chunked recurrence is exact for any chunk."""
    (x, dt, A, B, C), _ = _bf16_inputs(CHUNK256_CASE)
    y, h = _emulate_wgmma_kernel(x, dt, A, B, C, 256)
    yp, hp = tssd.ssd_scan_reference(x.float(), dt, A, B.float(), C.float(),
                                     chunk=256)
    torch.testing.assert_close(y, yp, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(h, hp, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the Mamba2 mixer
# ---------------------------------------------------------------------------


def test_causal_conv():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    w = (0.3 * rng.standard_normal((4, 24))).astype(np.float32)
    b = (0.1 * rng.standard_normal(24)).astype(np.float32)
    o = tssm._causal_conv(*(torch.from_numpy(a) for a in (x, w, b)))
    r = jssm._causal_conv(*(jnp.asarray(a) for a in (x, w, b)))
    np.testing.assert_allclose(_np(o), _np(r), **TOL_F32)


def _mixers(name, f32, seed=4):
    jc, tc = _cfgs(name, f32)
    params, model = _both_models(jc, tc, seed)
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["mixer"])
    return jc, tc, jp, model.blocks[0].mixer


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_ssm_apply_prefill(f32, pallas):
    jc, tc, jp, tp = _mixers("mamba2-370m", f32)
    dt = torch.float32 if f32 else torch.bfloat16
    x = np.random.default_rng(5).standard_normal((2, 32, 64)) \
        .astype(np.float32)
    with torch.no_grad():
        o, st = tssm.ssm_apply(tp, torch.from_numpy(x).to(dt), tc)
        with tflags.use_kernels(False):
            o_plain, _ = tssm.ssm_apply(tp, torch.from_numpy(x).to(dt), tc)
    with _jax_path(pallas):
        r, _ = jssm.ssm_apply(jp, jnp.asarray(x).astype(jc.param_dtype), jc)
    assert st is None and o.dtype == dt
    tol = TOL_F32 if f32 else TOL_BF16
    np.testing.assert_allclose(_np(o), _np(r), **tol)
    np.testing.assert_allclose(_np(o_plain), _np(r), **tol)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_ssm_apply_decode_step_updates_the_state_in_place(f32):
    jc, tc, jp, tp = _mixers("zamba2-2.7b", f32)
    dt = torch.float32 if f32 else torch.bfloat16
    rng = np.random.default_rng(6)
    cd = tssm.conv_dim(tc)
    conv = (0.5 * rng.standard_normal((2, 3, cd))).astype(np.float32)
    h = (0.5 * rng.standard_normal((2, tc.ssm_heads, 16, 16))) \
        .astype(np.float32)
    x = rng.standard_normal((2, 1, 64)).astype(np.float32)
    # copies: the step updates the state in place
    st = tssm.SSMState(torch.tensor(conv).to(dt), torch.tensor(h))
    with torch.no_grad():
        o, new = tssm.ssm_apply(tp, torch.from_numpy(x).to(dt), tc, state=st)
    jst = jssm.SSMState(jnp.asarray(conv).astype(jc.compute_dtype),
                        jnp.asarray(h))
    r, jnew = jssm.ssm_apply(jp, jnp.asarray(x).astype(jc.param_dtype), jc,
                             state=jst)
    assert new is st  # in place
    assert o.dtype == st.conv.dtype == dt and st.h.dtype == torch.float32
    assert str(jnew.conv.dtype) == str(st.conv.dtype).replace("torch.", "")
    tol = TOL_F32 if f32 else TOL_BF16
    np.testing.assert_allclose(_np(o), _np(r), **tol)
    np.testing.assert_allclose(_np(st.conv), _np(jnew.conv), **tol)
    np.testing.assert_allclose(_np(st.h), _np(jnew.h), **tol)


def test_prefill_length_not_a_multiple_of_the_chunk_raises_in_both():
    """Watch-point: ``chunk = min(cfg.ssm.chunk, S)`` must divide S; the
    reference asserts it, the port raises."""
    jc, tc, jp, tp = _mixers("mamba2-370m", True)
    x = np.zeros((1, 24, 64), np.float32)  # reduced chunk is 16
    with pytest.raises(AssertionError):
        jssm.ssm_apply(jp, jnp.asarray(x), jc)
    for kernels in (True, False):
        with torch.no_grad(), tflags.use_kernels(kernels), \
                pytest.raises(ValueError, match="chunk"):
            tssm.ssm_apply(tp, torch.from_numpy(x), tc)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("name", SSM_ARCHS)
def test_forward_logits_f32(name, pallas):
    jc, tc = _cfgs(name)
    params, model = _both_models(jc, tc)
    tok = np.random.default_rng(8).integers(0, tc.vocab_size, (2, 32))
    with torch.no_grad():
        logits, aux = ttransformer.forward(
            model, tc, {"tokens": torch.from_numpy(tok)})
    with _jax_path(pallas):
        ref, _ = jtransformer.forward(params, jc, {"tokens": jnp.asarray(tok)})
    assert tuple(logits.shape) == (2, 32, tc.vocab_size)
    assert float(aux) == 0.0
    np.testing.assert_allclose(_np(logits), _np(ref), **TOL_F32)


@pytest.mark.parametrize("name", SSM_ARCHS)
def test_forward_logits_bf16(name):
    jc, tc = _cfgs(name, f32=False)
    params, model = _both_models(jc, tc)
    assert model.embed.weight.dtype == torch.bfloat16
    tok = np.random.default_rng(9).integers(0, tc.vocab_size, (2, 32))
    with torch.no_grad():
        logits, _ = ttransformer.forward(
            model, tc, {"tokens": torch.from_numpy(tok)})
    ref, _ = jtransformer.forward(params, jc, {"tokens": jnp.asarray(tok)})
    assert logits.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(logits), _np(ref), **TOL_BF16)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", SSM_ARCHS)
def test_decode_chain_matches_reference_and_own_forward(name, f32):
    jc, tc = _cfgs(name, f32)
    params, model = _both_models(jc, tc)
    B, T = 2, 16
    tok = np.random.default_rng(10).integers(0, tc.vocab_size, (B, T))
    jstate = jtransformer.init_decode_state(jc, B, T)
    tstate = ttransformer.init_decode_state(tc, B, T, device="cpu")
    for key in ("ssm", "kv"):
        assert (key in tstate) == (key in jstate)
        if key in jstate:
            for a, b in zip(tstate[key], jstate[key]):
                assert tuple(a.shape) == tuple(b.shape)
                assert str(a.dtype).replace("torch.", "") == str(b.dtype)
    jstep = jax.jit(lambda s, t: jtransformer.decode_step(params, jc, s, t))
    tol = TOL_F32 if f32 else TOL_BF16
    chain = []
    for t in range(T):
        with torch.no_grad():
            lt, tstate = ttransformer.decode_step(
                model, tc, tstate, torch.from_numpy(tok[:, t:t + 1]))
        lj, jstate = jstep(jstate, jnp.asarray(tok[:, t:t + 1]))
        np.testing.assert_allclose(_np(lt), _np(lj), **tol,
                                   err_msg=f"step {t}")
        chain.append(lt)
    assert tstate["pos"] == int(jstate["pos"]) == T
    np.testing.assert_allclose(_np(tstate["ssm"].h), _np(jstate["ssm"].h),
                               **tol)
    np.testing.assert_allclose(_np(tstate["ssm"].conv),
                               _np(jstate["ssm"].conv), **tol)
    # decode ≡ prefill on the port's own side
    with torch.no_grad():
        full, _ = ttransformer.forward(model, tc,
                                       {"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(_np(torch.cat(chain, dim=1)), _np(full), **tol)


def test_hybrid_keeps_one_kv_cache_per_site_of_the_shared_block():
    cfg = dataclasses.replace(TARCHS["zamba2-2.7b"].reduced(), n_layers=6,
                              hybrid=dataclasses.replace(
                                  TARCHS["zamba2-2.7b"].hybrid, attn_every=3))
    model = ttransformer.init_params(cfg, device="cpu")
    state = ttransformer.init_decode_state(cfg, 2, 8, device="cpu")
    assert state["kv"].k.shape[0] == 2 and state["ssm"].h.shape[0] == 6
    assert len(model.blocks) == 6 and not hasattr(model.blocks[0], "attn")
    tok = torch.tensor([[3], [4]])
    with torch.no_grad():
        ttransformer.decode_step(model, cfg, state, tok)
    # both sites wrote their row 0, nothing else
    assert bool(state["kv"].k[:, :, 0].abs().sum(dim=(1, 2, 3)).gt(0).all())
    assert float(state["kv"].k[:, :, 1:].abs().sum()) == 0.0


@pytest.mark.parametrize("name", SSM_ARCHS)
def test_params_keep_ssm_scalars_in_f32_under_bf16(name):
    jc, tc = _cfgs(name, f32=False)
    params, _ = jtransformer.init_params(jc, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    sd = params_from_reference(tc, tree)
    model = ttransformer.init_params(tc, device="cpu")
    model.load_state_dict(sd)
    for i in range(tc.n_layers):
        for leaf in SSM_F32:
            key = f"blocks.{i}.mixer.{leaf}"
            want = tree["blocks"]["mixer"][leaf][i]
            assert want.dtype == np.float32
            assert sd[key].dtype == torch.float32
            # exact: a bf16 round trip on the way would change these values
            np.testing.assert_array_equal(sd[key].numpy(), want)
            np.testing.assert_array_equal(
                model.state_dict()[key].numpy(), want)
    assert sd["blocks.0.mixer.conv_w"].dtype == torch.bfloat16
    assert tuple(sd["blocks.0.mixer.conv_w"].shape) == \
        (tc.ssm.d_conv, tssm.conv_dim(tc))


@pytest.mark.parametrize("name", SSM_ARCHS)
def test_param_count_equals_closed_form(name):
    for cfg in (TARCHS[name].reduced(), dataclasses.replace(
            TARCHS[name], n_layers=TARCHS[name].hybrid.attn_every
            if TARCHS[name].hybrid else 1, d_model=256, vocab_size=512)):
        model = ttransformer.init_params(cfg, device="cpu")
        assert ttransformer.param_count(model) == cfg.n_params()


def test_recompute_dispatches_per_chunk_are_the_plain_versions():
    """The training path's backward recomputes ``ssd_scan_reference`` under
    autograd chunk by chunk; the kernel model prices each chunk's
    operators (forward and backward), counted here on meta tensors."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    def count(L):
        x, dt, A, B, C = (torch.empty(s, device="meta", requires_grad=True)
                          for s in ((1, 2, L, 16), (1, 2, L), (2,),
                                    (1, 1, L, 16), (1, 1, L, 16)))
        with Count() as c:
            y, _ = tssd.ssd_scan_reference(x, dt, A, B, C, chunk=16)
            torch.autograd.grad(y, (x, dt, A, B, C), torch.empty_like(y))
        return c.n
    # past the first chunk, each adds the same operators
    assert count(48) - count(32) == (count(128) - count(64)) // 4 \
        == tssd.RECOMPUTE_DISPATCHES_PER_CHUNK


# ---------------------------------------------------------------------------
# the backward: which inputs go to its kernels, and their arithmetic


def _meta_scan_inputs(Bz=2, H=80, G=1, L=4096, P=64, N=64,
                      dtype=torch.bfloat16, shift=0):
    """x, dt, A, B, C on the meta device in the training path's layout:
    column slices of one (Bz, L, width) tensor viewed as (Bz, H, L, P) /
    (Bz, G, L, N), dt a (Bz, H, L) view of (Bz, L, H); ``shift`` moves the
    slices ``shift`` elements into the row."""
    d = H * P
    xbc = torch.empty((Bz, L, shift + d + 2 * G * N), dtype=dtype,
                      device="meta")[..., shift:]
    x = xbc[..., :d].unflatten(-1, (H, P)).transpose(1, 2)
    B = xbc[..., d:d + G * N].unflatten(-1, (G, N)).transpose(1, 2)
    C = xbc[..., d + G * N:].unflatten(-1, (G, N)).transpose(1, 2)
    dt = torch.empty((Bz, L, H), device="meta").transpose(1, 2)
    A = torch.empty((H,), device="meta")
    return x, dt, A, B, C


def _bases(*ts):
    return [t.storage_offset() * t.element_size() for t in ts]


@pytest.mark.parametrize("kw,want", [
    ({}, "kernel"),                                  # zamba2-2.7b's step
    ({"N": 128, "H": 32}, "kernel"),                 # mamba2-370m's
    ({"H": 40, "Bz": 1}, "kernel"),                  # a rank's shard of it
    ({"P": 128, "N": 128, "H": 4, "G": 2}, "kernel"),
    ({"P": 48, "N": 16, "H": 6, "G": 3}, "kernel"),
    ({"dtype": torch.float32}, "plain"),             # f32 inputs
    ({"P": 16, "N": 16, "L": 96}, "plain"),          # L not a step multiple
    ({"P": 8}, "plain"), ({"N": 144}, "plain"), ({"P": 160}, "plain"),
    ({"shift": 2}, "plain"),                         # rows not 4-aligned
    ({"shift": 4}, "kernel"),
], ids=["zamba2", "mamba2", "shard", "p128n128", "p48n16", "f32", "L96",
        "P8", "N144", "P160", "shift2", "shift4"])
def test_backward_path_rule_on_meta_tensors(kw, want):
    x, dt, A, B, C = _meta_scan_inputs(**kw)
    assert tssd.backward_path(x, dt, A, B, C, _bases(x, B, C)) == want
    assert tssd.backward_rule(x.shape[3], B.shape[3], x.shape[2],
                              x.dtype == torch.bfloat16) \
        == ("kernel" if kw.get("shift") == 2 else want)


def test_backward_path_keeps_the_recompute_off_the_kernels():
    """CPU tensors, ``use_kernels(False)``, and dt or A in another type than
    f32 keep the plain recompute."""
    x, dt, A, B, C = _meta_scan_inputs()
    bases = _bases(x, B, C)
    with tflags.use_kernels(False):
        assert tssd.backward_path(x, dt, A, B, C, bases) == "plain"
    assert tssd.backward_path(x, dt.to(torch.bfloat16), A, B, C,
                              bases) == "plain"
    assert tssd.backward_path(x, dt, A.double(), B, C, bases) == "plain"
    cpu = [torch.zeros(t.shape, dtype=t.dtype) for t in (x, dt, A, B, C)]
    assert tssd.backward_path(*cpu) == "plain"
    with pytest.raises(ValueError, match="do not take"):
        tssd.ssd_scan_backward(*cpu, torch.zeros(x.shape, dtype=x.dtype))


@pytest.mark.parametrize("Bz,H,G,L,P,N,chunk,step", [
    (2, 4, 2, 256, 16, 32, 128, 64), (1, 3, 1, 192, 32, 16, 64, 64),
    (1, 2, 1, 256, 16, 16, 256, 32), (1, 2, 1, 128, 64, 128, 128, 64)])
def test_backward_kernels_arithmetic_equals_autograd(Bz, H, G, L, P, N,
                                                     chunk, step):
    """The backward kernels' step decomposition in plain PyTorch
    (``ssd_scan_backward_reference``: state terms, the pass over the
    steps, each step's gradients) equals ``torch.autograd.grad`` through
    ``ssd_scan_reference``, at a step other than the forward's chunk (both
    f32: within 2e-5 relative Frobenius)."""
    g = torch.Generator().manual_seed(L + P + N)
    x = 0.5 * torch.randn(Bz, H, L, P, generator=g)
    dt = 0.05 + 0.1 * torch.rand(Bz, H, L, generator=g)
    A = -(0.5 + torch.rand(H, generator=g))
    B = 0.3 * torch.randn(Bz, G, L, N, generator=g)
    C = 0.3 * torch.randn(Bz, G, L, N, generator=g)
    dy = torch.randn(Bz, H, L, P, generator=g)
    ins = [t.clone().requires_grad_() for t in (x, dt, A, B, C)]
    y, _ = tssd.ssd_scan_reference(*ins, chunk=chunk)
    want = torch.autograd.grad(y, ins, dy)
    got = tssd.ssd_scan_backward_reference(x, dt, A, B, C, dy, step=step)
    for name, a, b in zip(("x", "dt", "A", "B", "C"), got, want):
        assert a.shape == b.shape, name
        err = float((a - b).norm() / b.norm())
        assert err < 2e-5, (name, err)


def test_ssd_backward_span_says_which_path_ran():
    """``_SSDScan``'s backward on CPU tensors keeps the recompute, and its
    span ``ssd.backward`` says so (``path="plain"``); the backward kernels'
    launch count does not move."""
    from repro_torch.obs import trace as ttrace
    g = torch.Generator().manual_seed(3)
    x, B, C = (torch.randn(1, n, 64, 16, generator=g).to(torch.bfloat16)
               .requires_grad_() for n in (2, 1, 1))
    dt = (0.1 * torch.rand(1, 2, 64, generator=g)).requires_grad_()
    A = (-torch.ones(2)).requires_grad_()
    tracer, prev = ttrace.Tracer(), ttrace.get_tracer()
    ttrace.set_tracer(tracer)
    before = tssd.ssd_scan_backward.launches
    try:
        tssm._SSDScan.apply(x, dt, A, B, C, 32).float().sum().backward()
    finally:
        ttrace.set_tracer(prev)
    spans = [s for s in tracer.spans if s.name == "ssd.backward"]
    assert len(spans) == 1 and spans[0].args["path"] == "plain"
    assert spans[0].args["chunk"] == 32
    assert tssd.ssd_scan_backward.launches == before
    assert all(t.grad is not None for t in (x, dt, A, B, C))


@pytest.mark.parametrize("kernels", [True, False], ids=["on", "off"])
def test_ssd_backward_decides_under_the_forwards_flags(kernels, monkeypatch):
    """``_SSDScan``'s backward asks ``backward_path`` under the forward's
    ``flags.use_kernels``, on another thread whose flag says the opposite
    (for CUDA tensors autograd runs the backward on a thread of its own,
    its flags at their defaults)."""
    import threading
    seen, real = [], tssm.backward_path

    def spy(*args, **kw):
        seen.append(tflags.kernels_enabled())
        return real(*args, **kw)
    monkeypatch.setattr(tssm, "backward_path", spy)
    g = torch.Generator().manual_seed(5)
    x, B, C = (torch.randn(1, n, 64, 16, generator=g).to(torch.bfloat16)
               .requires_grad_() for n in (2, 1, 1))
    dt = (0.1 * torch.rand(1, 2, 64, generator=g)).requires_grad_()
    A = (-torch.ones(2)).requires_grad_()
    with tflags.use_kernels(kernels):
        y = tssm._SSDScan.apply(x, dt, A, B, C, 32)

    def backward():
        with tflags.use_kernels(not kernels):
            y.float().sum().backward()
    t = threading.Thread(target=backward)
    t.start()
    t.join()
    assert seen == [kernels]
    assert all(v.grad is not None for v in (x, dt, A, B, C))
