"""The port's flash-attention wrapper and plain version against the JAX
package: ``repro.kernels.ref.attention`` and the Pallas kernel in interpret
mode, on the same numpy inputs.  Tolerances are the reference's own (f32
3e-5, bf16 2e-2).  The CUDA kernel itself has no interpret mode: it is held
against the plain version on a card by ``tests/test_torch_gpu.py`` and by
``chip_smoke.py``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_fa
from repro_torch.kernels import flash_attention as tfa
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


def test_kernel_source_is_in_the_package_and_not_built_on_import():
    from repro_torch.kernels import _build
    assert "flash_attention" in _build.sources()
    assert (_build.CSRC / "flash_attention.cu").exists()
    assert _build._libs == {} or not torch.cuda.is_available()
