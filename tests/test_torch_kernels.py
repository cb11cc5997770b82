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


@pytest.mark.parametrize("case", FA_CASES, ids=IDS)
def test_block_sizes_auto_matches_the_reference_auto(case):
    """``"auto"`` on a CPU tensor: the plain version (no launch), equal to
    the reference's ``block_sizes="auto"`` kernel in interpret mode."""
    (q, k, v), (jq, jk, jv) = _inputs(case)
    causal, window, dtype = case[6], case[7], case[8]
    before = tfa.flash_attention.launches
    o = tops.flash_attention(q, k, v, causal=causal, window=window,
                             block_sizes="auto")
    assert tfa.flash_attention.launches == before
    assert torch.equal(o, tfa.attention_reference(q, k, v, causal=causal,
                                                  window=window))
    r = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                             block_sizes="auto", interpret=True)
    np.testing.assert_allclose(_np(o), _np(r), **_tol(dtype))


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


@pytest.mark.parametrize("dhp", range(16, 129, 16))
def test_bf16_tile_fits_shared_memory_with_its_p_tiles(dhp):
    """``tile_rule`` at every padded head width: 128 queries x 128 keys, a
    two-stage K/V ring and each consumer's 64 x 128 bf16 P tiles (P_lo, and
    P_hi above a head of 80), within one block's shared memory; a third
    stage would not fit at heads above 64."""
    bq, bk, stages, smem = tfa.tile_rule(dhp)
    chunks = -(-dhp // 64)                   # 128-byte row chunks of a row
    q_bytes, kv_bytes = chunks * bq * 128, chunks * bk * 128
    p_tiles = 2 * (2 if dhp > 80 else 1) * 64 * bk * 2
    assert (bq, bk, stages) == (128, 128, 2)
    assert smem == 1024 + q_bytes + 2 * stages * kv_bytes + p_tiles \
        + 8 * (1 + 4 * stages)
    assert smem <= tfa.SMEM_LIMIT
    assert (smem + 2 * kv_bytes + 32 > tfa.SMEM_LIMIT) == (dhp > 64)
    for dh in range(dhp - 12, dhp + 1, 4):   # every dh that pads to dhp
        assert tfa.tile_rule(dh) == (bq, bk, stages, smem)


def _p_emulation(q, k, v, causal, window, *, split):
    """The bf16 kernel's arithmetic, in f32 on the CPU: key tiles of 128
    (from key 0, so lengths that are not a multiple of it end in a ragged
    tile), the online softmax (running max, sums of the f32 P, rescale of
    the accumulator), P V summed in f32 from P_hi = bf16(P) and P_lo =
    bf16(P - P_hi) (``split``) or from bf16(P) alone.  Returns the f32
    output before its rounding to bf16."""
    B, H, Sq, dh = q.shape
    KVH, Skv = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(H // KVH, dim=1)
    vf = v.float().repeat_interleave(H // KVH, dim=1)
    scale = 1.0 / np.sqrt(dh)
    m = torch.full((B, H, Sq, 1), tfa.NEG_INF)
    l = torch.zeros((B, H, Sq, 1))
    o = torch.zeros((B, H, Sq, dh))
    rows = torch.arange(Sq)[:, None]
    for k0 in range(0, Skv, 128):
        cols = torch.arange(k0, min(k0 + 128, Skv))[None, :]
        seen = torch.ones((Sq, cols.shape[1]), dtype=torch.bool)
        if causal:
            seen &= rows >= cols
        if window is not None:
            seen &= rows - cols < window
        s = q.float() @ kf[:, :, k0:k0 + 128].transpose(-1, -2)
        s = torch.where(seen, s, torch.full_like(s, tfa.NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp((m - m_new) * scale)
        # a row that has seen no key yet keeps P = 0
        mc = torch.where(m_new == tfa.NEG_INF, torch.zeros_like(m_new), m_new)
        p = torch.exp((s - mc) * scale)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        vt = vf[:, :, k0:k0 + 128]
        pv = hi @ vt
        if split:
            pv = pv + (p - hi).to(torch.bfloat16).float() @ vt
        o = o * alpha + pv
        m = m_new
    return o / l.clamp_min(1e-20)


@pytest.mark.parametrize("case", [
    # B, H, KVH, Sq, Skv, dh, causal, window: GQA at dh 64, a window at dh
    # 128, MQA without a mask; every length ragged against 128 keys
    (1, 4, 2, 192, 192, 64, True, None),
    (1, 4, 2, 320, 320, 128, True, 96),
    (1, 2, 1, 128, 320, 128, False, None),
], ids=["gqa_dh64", "gqa_window_dh128", "mqa_noncausal_dh128"])
def test_hi_lo_p_emulation_holds_the_references(case):
    """The numerics the bf16 kernel keeps (P_hi and P_lo, the same two
    roundings, wherever the kernel keeps them), emulated in f32, against the
    reference's Pallas kernel in interpret mode and the port's plain
    version at the reference's bf16 tolerance 2e-2; against the f32 result
    on the same bf16 inputs, hi + lo lands more than 10x closer than one
    bf16 rounding of P, which is why the lo product stays."""
    (q, k, v), (jq, jk, jv) = _inputs(case + ("bfloat16",))
    causal, window = case[6], case[7]
    emu = _p_emulation(q, k, v, causal, window, split=True)
    one = _p_emulation(q, k, v, causal, window, split=False)
    out = emu.to(torch.bfloat16)
    pallas = pallas_fa(jq, jk, jv, causal=causal, window=window,
                       block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(_np(out), _np(pallas), **_tol("bfloat16"))
    plain = tfa.attention_reference(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(_np(out), _np(plain), **_tol("bfloat16"))
    exact = tfa.attention_reference(q.float(), k.float(), v.float(),
                                    causal=causal, window=window)

    def rel(a):
        return float((a - exact).norm() / exact.norm())

    assert rel(one) > 10 * rel(emu), (rel(one), rel(emu))


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
    # "auto" on a CPU tensor: the autotuner picks a tile, the plain version
    # runs
    assert torch.equal(call(block_sizes="auto"), call())
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


# ---------------------------------------------------------------------------
# transpose: the choice of kernel, and vec16's thread map
# ---------------------------------------------------------------------------

def _meta(shape, dtype=torch.float32, ld=None, offset=0):
    """A meta (M, N) view with leading stride ``ld`` at a storage offset of
    ``offset`` elements (nothing allocated)."""
    M, N = shape
    ld = N if ld is None else ld
    flat = torch.empty(offset + M * ld, dtype=dtype, device="meta")
    return flat[offset:].view(M, ld)[:, :N]


@pytest.mark.parametrize("shape,dtype,block,ld,offset,want", [
    ((256, 512), torch.float32, 16, None, 0, "vec16"),     # aligned f32
    ((384, 256), torch.bfloat16, 16, None, 0, "vec16"),    # aligned bf16
    ((16384, 16384), torch.float32, 16, None, 0, "vec16"),  # calibration's
    ((2048, 2048), torch.float32, 8, None, 0, "vec16"),    # 8 gets tile 16
    ((256, 512), torch.float32, 16, 520, 4, "vec16"),      # padded, aligned
    ((256, 512), torch.float32, 16, None, 1, "scalar"),    # base + 4 bytes
    ((384, 256), torch.bfloat16, 16, None, 2, "scalar"),   # base + 4 bytes
    ((384, 256), torch.bfloat16, 16, None, 4, "scalar"),   # base + 8 bytes
    ((256, 512), torch.float32, 16, 515, 0, "scalar"),     # odd stride
    ((256, 512), torch.float32, 16, 514, 0, "scalar"),     # stride % 4 == 2
    ((384, 256), torch.bfloat16, 16, 260, 0, "scalar"),    # stride % 8 == 4
    ((256, 77), torch.float32, 16, None, 0, "scalar"),     # N = 77
    ((100, 77), torch.float32, 16, None, 0, "scalar"),     # ragged 100 x 77
    ((100, 64), torch.bfloat16, 16, None, 0, "scalar"),    # M = 100, bf16
    ((100, 64), torch.float32, 16, None, 0, "vec16"),      # 100 = 25 f32 x 4
    ((102, 64), torch.float32, 16, None, 0, "scalar"),     # M % 4 == 2
    ((256, 512), torch.float32, 32, None, 0, "scalar"),    # tile 32
    ((256, 512), torch.float32, 64, None, 0, "scalar"),    # tile 64
    ((256, 512), torch.float32, 256, None, 0, "scalar"),   # the default
])
def test_transpose_pick_variant(shape, dtype, block, ld, offset, want):
    x = _meta(shape, dtype, ld, offset)
    assert ttr.pick_variant(x, block) == want
    # an explicit base decides alignment alone
    assert ttr.pick_variant(x, block, base=offset * x.element_size()) == want
    if want == "vec16":
        assert ttr.pick_variant(x, block, base=4 * 1024 + 8) == "scalar"


def test_transpose_vec_widths_match_the_cuda_source():
    import re
    from repro_torch.kernels import _build
    src = (_build.CSRC / "transpose.cu").read_text()
    widths = dict(re.findall(r"struct VecWidth<unsigned (\w+)> "
                             r"\{ static constexpr int V = (\d+);", src))
    assert {torch.float32: int(widths["int"]),
            torch.bfloat16: int(widths["short"])} == ttr.VEC_ELEMS


def _vec_map(esize, V, swizzle=True):
    """csrc/transpose.cu's VecMap for elements of ``esize`` bytes and
    accesses of ``V`` elements, emulated: which X element each thread loads
    and where it lands in shared memory, and which Y element each thread
    stores.  Returns Y's tile of X element ids (row * 16 + column), how many
    times each shared and Y element was written, and the bank conflicts
    (extra wavefronts) of the shared stores and of the gathers."""
    C, VB = 16 // V, V * esize
    NC, threads = 128 // VB, 16 * (16 // V)

    def slot(a, c):
        f = a * C + c
        return (f & ~(NC - 1)) | ((f & (NC - 1))
                                  ^ ((2 * (a // V)) if swizzle else 0))

    t = np.arange(threads)
    row, acc = t // C, t % C
    smem, s_writes = np.full(256, -1), np.zeros(256, int)
    store_slots = np.array([slot(r, c) for r, c in zip(row, acc)])
    for s, r, c in zip(store_slots, row, acc):
        for i in range(V):
            smem[s * V + i] = r * 16 + c * V + i
            s_writes[s * V + i] += 1
    y, y_writes = np.full((16, 16), -1), np.zeros((16, 16), int)
    gathers = []   # per k: the shared element index each thread reads
    for k in range(V):
        a = acc * V + k
        idx = np.array([slot(ai, j // V) * V + j % V
                        for ai, j in zip(a, row)])
        gathers.append(idx)
        y[row, a] = smem[idx]
        y_writes[row, a] += 1

    def extra_wavefronts(words_per_thread, phase_threads):
        n = 0
        for p in range(0, threads, phase_threads):
            banks = {}
            for words in words_per_thread[p:p + phase_threads]:
                for w in words:
                    banks.setdefault(w % 32, set()).add(w)
            n += max(len(ws) for ws in banks.values()) - 1
        return n

    # stores: VB bytes a thread, 128 / VB threads a phase; gathers: one
    # element a thread, the whole warp at once (two threads on one word
    # share it)
    store_conf = extra_wavefronts(
        [range(s * VB // 4, (s + 1) * VB // 4) for s in store_slots],
        128 // VB)
    gather_conf = sum(extra_wavefronts([[i * esize // 4] for i in idx],
                                       32) for idx in gathers)
    return y, s_writes, y_writes, store_conf, gather_conf


@pytest.mark.parametrize("esize,V", [(4, 4), (2, 8), (4, 2), (2, 4)],
                         ids=["f32_16B", "bf16_16B", "f32_8B", "bf16_8B"])
def test_transpose_vec16_thread_map(esize, V):
    y, s_writes, y_writes, store_conf, gather_conf = _vec_map(esize, V)
    ids = np.arange(256).reshape(16, 16)
    np.testing.assert_array_equal(y, ids.T)     # every element transposed
    assert (s_writes == 1).all() and (y_writes == 1).all()  # once each
    assert (store_conf, gather_conf) == (0, 0)  # as the source's note says


def test_transpose_vec16_swizzle_is_what_removes_the_conflicts():
    """Without the XOR the f32 gathers meet 4 to a bank (3 extra wavefronts
    per gather and warp: 4 gathers x 2 warps x 3)."""
    y, *_, store_conf, gather_conf = _vec_map(4, 4, swizzle=False)
    np.testing.assert_array_equal(y, np.arange(256).reshape(16, 16).T)
    assert (store_conf, gather_conf) == (0, 24)


def test_transpose_variant_argument_on_the_cpu():
    x = torch.randn(32, 48)
    assert torch.equal(ttr.transpose(x, block=16, variant="vec16"), x.t())
    with pytest.raises(ValueError, match="variant"):
        ttr.transpose(x, variant="vec32")
