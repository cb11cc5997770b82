"""The port's kernel wrappers and plain versions against the JAX package:
flash attention against ``repro.kernels.ref.attention`` and the Pallas kernel
in interpret mode, matmul and transpose against ``ref.matmul``/``ref.
transpose`` and ``ops.matmul``/``ops.transpose`` in interpret mode, on the
same numpy inputs.  Tolerances are the reference's own (attention f32 3e-5,
bf16 2e-2; matmul f32 atol 1e-3 / rtol 1e-5, bf16 atol 1.0 / rtol 3e-2;
transpose exact).  The CUDA kernel itself has no interpret mode: it is held
against the plain version on a card by ``tests/test_torch_gpu.py`` and by
``chip_smoke.py``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_fa
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels import transpose as ttr
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

FA_CASES = [
    # B, H, KVH, Sq, Skv, dh, causal, window, dtype
    (2, 4, 2, 256, 256, 64, True, None, "float32"),
    (1, 4, 4, 128, 128, 32, True, None, "float32"),   # MHA
    (1, 8, 1, 128, 128, 64, True, None, "float32"),   # MQA
    (2, 8, 2, 256, 256, 64, True, 64, "float32"),     # SWA
    (1, 2, 1, 128, 256, 64, False, None, "float32"),  # cross/bidir
    (2, 4, 2, 256, 256, 64, True, None, "bfloat16"),
    (1, 4, 2, 256, 256, 128, True, 128, "bfloat16"),
]
IDS = [f"fa{i}" for i in range(len(FA_CASES))]


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=3e-5, rtol=3e-5)


def _inputs(case, seed=42):
    B, H, KVH, Sq, Skv, dh, causal, window, dtype = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, dh)).astype(np.float32)
    k = rng.standard_normal((B, KVH, Skv, dh)).astype(np.float32)
    v = rng.standard_normal((B, KVH, Skv, dh)).astype(np.float32)
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    t = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    j = [jnp.asarray(a).astype(jdt) for a in (q, k, v)]
    return t, j


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("case", FA_CASES, ids=IDS)
def test_plain_version_matches_reference_oracle(case):
    (q, k, v), (jq, jk, jv) = _inputs(case)
    causal, window, dtype = case[6], case[7], case[8]
    o = tfa.attention_reference(q, k, v, causal=causal, window=window)
    r = jref.attention(jq, jk, jv, causal=causal, window=window)
    assert o.dtype == q.dtype and tuple(o.shape) == tuple(q.shape)
    np.testing.assert_allclose(_np(o), _np(r), **_tol(dtype))


@pytest.mark.parametrize("case", FA_CASES, ids=IDS)
def test_wrapper_on_cpu_matches_pallas_interpret(case):
    (q, k, v), (jq, jk, jv) = _inputs(case)
    causal, window, dtype = case[6], case[7], case[8]
    before = tfa.flash_attention.launches
    o = tops.flash_attention(q, k, v, causal=causal, window=window,
                             block_q=64, block_k=64)
    assert tfa.flash_attention.launches == before  # plain version: no launch
    r = pallas_fa(jq, jk, jv, causal=causal, window=window,
                  block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(_np(o), _np(r), **_tol(dtype))


def test_ref_module_reexports_plain_version():
    assert tref.attention is tfa.attention_reference


def test_block_sizes_auto_waits_for_autotuner():
    (q, k, v), _ = _inputs(FA_CASES[1])
    with pytest.raises(NotImplementedError, match="autotun"):
        tops.flash_attention(q, k, v, block_sizes="auto")


def test_block_sizes_mapping_and_bad_value():
    (q, k, v), _ = _inputs(FA_CASES[1])
    a = tops.flash_attention(q, k, v, block_sizes={"block_q": 32})
    b = tops.flash_attention(q, k, v)
    assert torch.equal(a, b)
    with pytest.raises(TypeError):
        tops.flash_attention(q, k, v, block_sizes=7)


def test_cuda_without_a_card_raises_instead_of_running_on_cpu():
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU")
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer
    cfg = get_arch("llama3.2-3b").reduced()
    with pytest.raises((RuntimeError, AssertionError)):
        transformer.init_params(cfg)  # device defaults to "cuda"
    with pytest.raises((RuntimeError, AssertionError)):
        transformer.init_decode_state(cfg, 2, 16)
    with pytest.raises((RuntimeError, AssertionError)):
        torch.zeros(1, device="cuda")


@pytest.mark.parametrize("bad", ["heads", "dtype", "shape", "window", "rank"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(1, 4, 8, 16)
    k = torch.zeros(1, 2, 8, 16)
    v = torch.zeros(1, 2, 8, 16)
    kw = {}
    if bad == "heads":
        k = v = torch.zeros(1, 3, 8, 16)
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "shape":
        v = torch.zeros(1, 2, 9, 16)
    elif bad == "window":
        kw["window"] = 0
    elif bad == "rank":
        q = q[0]
    with pytest.raises((ValueError, TypeError)):
        tfa.flash_attention(q, k, v, **kw)


@pytest.mark.parametrize("req,dh,want", [
    ((128, 128), 128, (128, 64)),   # the main path: key tile halved to fit
    ((128, 128), 64, (128, 128)),
    ((64, 64), 64, (64, 64)),
    ((256, 256), 64, (128, 128)),   # above the largest tile built
    ((16, 48), 32, (32, 32)),       # below the smallest / between two
])
def test_pick_tiles_fits_shared_memory(req, dh, want):
    got = tfa.pick_tiles(*req, dh)
    assert got == want
    assert tfa.smem_bytes(*got, dh) <= tfa.SMEM_LIMIT
    assert got[0] in tfa.TILES and got[1] in tfa.TILES


def _attention_configs():
    from repro_torch.configs.registry import ARCHS
    out = []
    for name, cfg in ARCHS.items():
        if cfg.n_heads:
            out += [(f"{name}", cfg, 2048), (f"{name}-reduced", cfg.reduced(),
                                             48)]
    return out


ATTN_CONFIGS = _attention_configs()


def _main_path_views(cfg, S, offset=0):
    """q, k, v as ``attn_apply`` hands them over: (B, S, H, dh) tensors seen
    through ``.transpose(1, 2)``, on the meta device (nothing allocated);
    ``offset`` elements past the start of their storage."""
    B, H, KVH, dh = 2, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    views = []
    for heads in (H, KVH, KVH):
        n = B * S * heads * dh
        flat = torch.empty(n + offset, device="meta", dtype=torch.bfloat16)
        views.append(flat[offset:].view(B, S, heads, dh).transpose(1, 2))
    return views


def _tma_rule(name, t):
    # a meta tensor has no address: its base is the storage offset, from an
    # allocation that is itself aligned
    tfa.check_tma_layout(name, t.shape, t.stride(),
                         t.storage_offset() * t.element_size(), t.dtype)


@pytest.mark.parametrize("name,cfg,S", ATTN_CONFIGS,
                         ids=[c[0] for c in ATTN_CONFIGS])
def test_bf16_layout_rule_accepts_every_models_views(name, cfg, S):
    for n, t in zip("qkv", _main_path_views(cfg, S)):
        _tma_rule(n, t)


@pytest.mark.parametrize("name,cfg,S", ATTN_CONFIGS,
                         ids=[c[0] for c in ATTN_CONFIGS])
def test_bf16_layout_rule_refuses_misaligned_views(name, cfg, S):
    q = _main_path_views(cfg, S, offset=1)[0]   # base 2 bytes past 16
    with pytest.raises(ValueError, match="aligned"):
        _tma_rule("q", q)
    dh = cfg.head_dim_                            # rows of dh + 4 values
    wide = torch.empty(2, S, cfg.n_heads, dh + 4, device="meta",
                       dtype=torch.bfloat16)[..., :dh].transpose(1, 2)
    with pytest.raises(ValueError, match="16 bytes"):
        _tma_rule("q", wide)
    with pytest.raises(ValueError, match="contiguous"):
        _tma_rule("q", q.transpose(2, 3))


def test_kernel_source_is_in_the_package_and_not_built_on_import():
    from repro_torch.kernels import _build
    assert "flash_attention" in _build.sources()
    assert (_build.CSRC / "flash_attention.cu").exists()
    assert _build._libs == {} or not torch.cuda.is_available()


@pytest.mark.parametrize("newest,stale", [
    (None, True),        # no library yet
    ("lib", False),      # built after its source and every header
    ("cu", True),        # the source edited since
    ("cuh", True),       # a shared header edited since
])
def test_build_is_stale_when_the_source_or_a_header_is_newer(
        newest, stale, tmp_path, monkeypatch):
    """Mtimes only: nothing is compiled."""
    import os
    from repro_torch.kernels import _build
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    out.mkdir()
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(out))
    files = {"cu": csrc / "k.cu", "cuh": csrc / "shared.cuh",
             "lib": out / "libk.so"}
    for f in files.values():
        f.write_text("")
    if newest is None:
        files["lib"].unlink()
    for i, (key, f) in enumerate(sorted(files.items(),
                                        key=lambda kv: kv[0] == newest)):
        if f.exists():
            os.utime(f, (1000 + i, 1000 + i))
    assert _build._stale("k") is stale


# ---------------------------------------------------------------------------
# matmul and transpose
# ---------------------------------------------------------------------------

MM_CASES = [
    # M, K, N, block, dtype (the reference's table)
    (256, 384, 512, 128, "float32"),
    (128, 128, 128, 128, "float32"),
    (512, 256, 256, 64, "float32"),
    (256, 2048, 256, 128, "float32"),   # skinny (n = l = m/8)
    (256, 256, 256, 128, "bfloat16"),
]


def _mm_tol(dtype):
    return dict(atol=1.0, rtol=3e-2) if dtype == "bfloat16" \
        else dict(atol=1e-3, rtol=1e-5)


def _mm_inputs(case, seed=7):
    M, K, N, _, dtype = case
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    t = [torch.from_numpy(x).to(getattr(torch, dtype)) for x in (a, b)]
    j = [jnp.asarray(x).astype(getattr(jnp, dtype)) for x in (a, b)]
    return t, j


@pytest.mark.parametrize("case", MM_CASES,
                         ids=[f"mm{i}" for i in range(len(MM_CASES))])
def test_matmul_plain_version_matches_reference(case):
    (a, b), (ja, jb) = _mm_inputs(case)
    blk, dtype = case[3], case[4]
    before = tmm.matmul.launches
    o = tops.matmul(a, b, block_m=blk, block_n=blk, block_k=blk)
    assert tmm.matmul.launches == before  # plain version: no launch
    assert o.dtype == a.dtype and tuple(o.shape) == (case[0], case[2])
    assert tref.matmul is tmm.matmul_reference
    for r in (jref.matmul(ja, jb),
              jops.matmul(ja, jb, block_m=blk, block_n=blk, block_k=blk,
                          interpret=True)):
        np.testing.assert_allclose(_np(o), _np(r), **_mm_tol(dtype))


@pytest.mark.parametrize("shape,blk", [((256, 256), 128), ((512, 256), 128),
                                       ((128, 384), 64)])
def test_transpose_plain_version_matches_reference(shape, blk):
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    o = tops.transpose(torch.from_numpy(x), block=blk)
    assert o.is_contiguous()
    np.testing.assert_array_equal(o.numpy(), np.asarray(
        jops.transpose(jnp.asarray(x), block=blk, interpret=True)))
    np.testing.assert_array_equal(tref.transpose(torch.from_numpy(x)).numpy(),
                                  np.asarray(jref.transpose(jnp.asarray(x))))


@pytest.mark.parametrize("kernel", ["matmul", "transpose"])
def test_matmul_and_transpose_block_sizes(kernel):
    a = torch.randn(32, 48)
    if kernel == "matmul":
        def call(**kw):
            return tops.matmul(a, a.t().contiguous(), **kw)
        mapping = {"block_m": 16}
    else:
        def call(**kw):
            return tops.transpose(a, **kw)
        mapping = {"block": 16}
    assert torch.equal(call(block_sizes=mapping), call())
    with pytest.raises(NotImplementedError, match="autotun"):
        call(block_sizes="auto")
    with pytest.raises(TypeError):
        call(block_sizes=7)


@pytest.mark.parametrize("bad", ["inner", "dtype", "mixed", "rank", "empty"])
def test_matmul_and_transpose_reject_what_the_kernels_do_not_take(bad):
    a, b = torch.zeros(8, 4), torch.zeros(4, 6)
    if bad == "inner":
        b = torch.zeros(5, 6)
    elif bad == "dtype":
        a, b = a.half(), b.half()
    elif bad == "mixed":
        b = b.bfloat16()
    elif bad == "rank":
        a = a[None]
    elif bad == "empty":
        a = torch.zeros(0, 4)
    with pytest.raises((ValueError, TypeError)):
        tmm.matmul(a, b)
    if bad in ("dtype", "rank", "empty"):
        with pytest.raises((ValueError, TypeError)):
            ttr.transpose(a)
