"""The port's model code against the JAX package, module by module: the same
numpy inputs and the same parameters (``params_from_reference``) go through
both, on the CPU, at reduced size.

Tolerances: f32 configurations 1e-4 (two frameworks, other summation
orders); bf16 3e-2 on logits (the two frameworks round bf16 products at
different places).  The JAX side runs both on its default path and under
``repro.runtime.flags.use_pallas()`` (the Pallas kernel in interpret mode).
"""
from __future__ import annotations

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.configs.registry import ARCHS as JARCHS
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.runtime import flags as jflags
from repro_torch.configs import base as tcfg
from repro_torch.configs.registry import ARCHS as TARCHS, get_arch
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttransformer
from repro_torch.models.convert import params_from_reference
from repro_torch.runtime import flags as tflags

torch.set_num_threads(1)

F32 = dict(param_dtype="float32", compute_dtype="float32")
TOL_F32 = dict(atol=1e-4, rtol=1e-4)
TOL_BF16 = dict(atol=3e-2, rtol=3e-2)
DENSE = ["llama3.2-3b", "smollm-360m"]


def _cfgs(name, f32=True, **kw):
    """The same reduced configuration from both packages."""
    if f32:
        kw = {**F32, **kw}
    jc = dataclasses.replace(JARCHS[name].reduced(), **kw)
    tc = dataclasses.replace(TARCHS[name].reduced(), **kw)
    return jc, tc


def _both_models(jc, tc, seed=0):
    params, _ = jtransformer.init_params(jc, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    model = ttransformer.init_params(tc, device="cpu", seed=seed)
    model.load_state_dict(params_from_reference(tc, tree))
    return params, model


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jax_path(pallas):
    return jflags.use_pallas() if pallas else contextlib.nullcontext()


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def _as_reference(cfg) -> dict:
    """The port's config as the reference's fields: the fields the port
    adds (the pattern family's) at their defaults, and left out."""
    out, added = dataclasses.asdict(cfg), {}
    for group, cls in (("", type(cfg)), ("moe", tcfg.MoEConfig),
                       ("ssm", tcfg.SSMConfig)):
        have = out.get(group) if group else out
        ref = {f.name for f in dataclasses.fields(
            getattr(jcfg, cls.__name__))}
        for f in dataclasses.fields(cls):
            if have is not None and f.name not in ref:
                added[f"{group}.{f.name}"] = (have.pop(f.name), f.default)
    assert all(v == default for v, default in added.values()), added
    return out


def test_configs_are_equal_copies():
    """The reference's registry is the port's but Nemotron, which the
    reference has not; its configs are the port's, the port's added
    fields at their defaults."""
    assert sorted(TARCHS) == sorted([*JARCHS, "nemotron-3-nano-30b-a3b"])
    for name in JARCHS:
        assert _as_reference(TARCHS[name]) == \
            dataclasses.asdict(JARCHS[name])
        assert _as_reference(TARCHS[name].reduced()) == \
            dataclasses.asdict(JARCHS[name].reduced())
        assert TARCHS[name].n_params() == JARCHS[name].n_params()
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    o = tlayers.rmsnorm(torch.from_numpy(scale).to(tdt),
                        torch.from_numpy(x).to(tdt), 1e-5)
    r = jlayers.rmsnorm({"scale": jnp.asarray(scale, jdt)},
                        jnp.asarray(x, jdt), 1e-5)
    assert o.dtype == tdt
    tol = TOL_F32 if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(_np(o), _np(r), **tol)


def test_ffn_swiglu():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = {n: (0.05 * rng.standard_normal(s)).astype(np.float32)
         for n, s in (("gate", (64, 128)), ("up", (64, 128)),
                      ("down", (128, 64)))}
    o = tlayers.ffn(*(torch.from_numpy(w[n].T.copy())
                      for n in ("gate", "up", "down")), torch.from_numpy(x))
    r = jlayers.ffn({n: {"w": jnp.asarray(a)} for n, a in w.items()},
                    jnp.asarray(x))
    np.testing.assert_allclose(_np(o), _np(r), **TOL_F32)


def test_embed_and_heads():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((256, 64)).astype(np.float32)
    tok = rng.integers(0, 256, (2, 7))
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(tlayers.embed(torch.from_numpy(w), torch.from_numpy(tok))),
        _np(jlayers.embed({"w": jnp.asarray(w)}, jnp.asarray(tok))))
    np.testing.assert_allclose(
        _np(tlayers.tied_lm_head(torch.from_numpy(w), torch.from_numpy(x))),
        _np(jlayers.tied_lm_head({"w": jnp.asarray(w)}, jnp.asarray(x))),
        atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(
        _np(tlayers.lm_head(torch.from_numpy(w), torch.from_numpy(x))),
        _np(jlayers.lm_head({"w": jnp.asarray(w.T)}, jnp.asarray(x))),
        atol=1e-4, rtol=1e-4)
    # the audio family's four codebooks in, four heads out
    w4 = rng.standard_normal((4, 256, 64)).astype(np.float32)
    tok4 = rng.integers(0, 256, (2, 7, 4))
    np.testing.assert_array_equal(
        _np(tlayers.embed(torch.from_numpy(w4), torch.from_numpy(tok4))),
        _np(jlayers.embed({"w": jnp.asarray(w4)}, jnp.asarray(tok4))))
    np.testing.assert_allclose(
        _np(tlayers.lm_head(torch.from_numpy(w4), torch.from_numpy(x))),
        _np(jlayers.lm_head({"w": jnp.asarray(w4.transpose(0, 2, 1))},
                            jnp.asarray(x))),
        atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_apply_rope(theta):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(37 + np.arange(9), (2, 9)).copy()
    o = tattn.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    r = jattn.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(_np(o), _np(r), **TOL_F32)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _attn_params(jc, tc, seed=4):
    """One attention block's parameters on both sides, from numpy."""
    params, model = _both_models(jc, tc, seed)
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["attn"])
    return jp, model.blocks[0].attn


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
def test_attn_apply_prefill(window, pallas):
    jc, tc = _cfgs("llama3.2-3b", sliding_window=window)
    jp, tp = _attn_params(jc, tc)
    x = np.random.default_rng(5).standard_normal((2, 32, 64)) \
        .astype(np.float32)
    with torch.no_grad():
        o, cache = tattn.attn_apply(tp, torch.from_numpy(x), tc)
        with tflags.use_kernels(False):
            o_plain, _ = tattn.attn_apply(tp, torch.from_numpy(x), tc)
    with _jax_path(pallas):
        r, _ = jattn.attn_apply(jp, jnp.asarray(x), jc)
    assert cache is None
    np.testing.assert_allclose(_np(o), _np(r), **TOL_F32)
    np.testing.assert_allclose(_np(o_plain), _np(r), **TOL_F32)


def test_attn_apply_stubbed_matches_reference_stub():
    jc, tc = _cfgs("llama3.2-3b")
    jp, tp = _attn_params(jc, tc)
    x = np.random.default_rng(6).standard_normal((1, 8, 64)) \
        .astype(np.float32)
    with torch.no_grad(), tflags.stub_attention():
        o, _ = tattn.attn_apply(tp, torch.from_numpy(x), tc)
    with jflags.stub_attention():
        r, _ = jattn.attn_apply(jp, jnp.asarray(x), jc)
    np.testing.assert_allclose(_np(o), _np(r), **TOL_F32)


@pytest.mark.parametrize("window,max_len,steps", [
    (None, 24, 24),   # plain cache, filled to its last row
    (16, 40, 40),     # SWA ring: cache capped at 16 rows, wraps twice
], ids=["full", "swa_ring"])
def test_attn_apply_decode_with_cache(window, max_len, steps):
    jc, tc = _cfgs("llama3.2-3b", sliding_window=window)
    jp, tp = _attn_params(jc, tc)
    B = 2
    xs = np.random.default_rng(7).standard_normal((steps, B, 1, 64)) \
        .astype(np.float32)
    jcache = jattn.init_cache(jc, B, max_len, jnp.float32)
    tcache = tattn.init_cache(tc, B, max_len, torch.float32, device="cpu")
    assert tuple(tcache.k.shape) == tuple(jcache.k.shape)
    if window is not None:
        assert tcache.k.shape[1] == window < max_len
    jstep = jax.jit(lambda c, x, t: jattn.attn_apply(
        jp, x, jc, cache=c, cache_pos=t))
    for t in range(steps):
        with torch.no_grad():
            o, tcache = tattn.attn_apply(tp, torch.from_numpy(xs[t]), tc,
                                         cache=tcache, cache_pos=t)
        r, jcache = jstep(jcache, jnp.asarray(xs[t]), jnp.int32(t))
        np.testing.assert_allclose(_np(o), _np(r), **TOL_F32,
                                   err_msg=f"step {t}")
    np.testing.assert_allclose(_np(tcache.k), _np(jcache.k), **TOL_F32)
    np.testing.assert_allclose(_np(tcache.v), _np(jcache.v), **TOL_F32)


def test_cache_write_beyond_last_row_raises():
    _, tc = _cfgs("llama3.2-3b")
    _, tp = _attn_params(*_cfgs("llama3.2-3b"))
    cache = tattn.init_cache(tc, 1, 4, torch.float32, device="cpu")
    x = torch.zeros(1, 1, 64)
    with torch.no_grad():
        tattn.attn_apply(tp, x, tc, cache=cache, cache_pos=3)
        with pytest.raises(ValueError, match="cache is full"):
            tattn.attn_apply(tp, x, tc, cache=cache, cache_pos=4)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("name", DENSE)
def test_forward_logits_f32(name, pallas):
    jc, tc = _cfgs(name)
    params, model = _both_models(jc, tc)
    tok = np.random.default_rng(8).integers(0, tc.vocab_size, (2, 32))
    with torch.no_grad():
        logits, aux = ttransformer.forward(
            model, tc, {"tokens": torch.from_numpy(tok)})
    with _jax_path(pallas):
        ref, _ = jtransformer.forward(params, jc,
                                      {"tokens": jnp.asarray(tok)})
    assert tuple(logits.shape) == (2, 32, tc.vocab_size)
    assert float(aux) == 0.0
    np.testing.assert_allclose(_np(logits), _np(ref), **TOL_F32)


@pytest.mark.parametrize("name", DENSE)
def test_forward_logits_bf16(name):
    jc, tc = _cfgs(name, f32=False)
    assert tc.param_dtype == "bfloat16"
    params, model = _both_models(jc, tc)
    assert model.embed.weight.dtype == torch.bfloat16
    tok = np.random.default_rng(9).integers(0, tc.vocab_size, (2, 32))
    with torch.no_grad():
        logits, _ = ttransformer.forward(
            model, tc, {"tokens": torch.from_numpy(tok)})
    ref, _ = jtransformer.forward(params, jc, {"tokens": jnp.asarray(tok)})
    assert logits.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(logits), _np(ref), **TOL_BF16)


@pytest.mark.parametrize("name", DENSE)
def test_decode_step_logits_f32(name):
    jc, tc = _cfgs(name)
    params, model = _both_models(jc, tc)
    B, T = 2, 12
    tok = np.random.default_rng(10).integers(0, tc.vocab_size, (B, T))
    jstate = jtransformer.init_decode_state(jc, B, 16)
    tstate = ttransformer.init_decode_state(tc, B, 16, device="cpu")
    assert tuple(tstate["kv"].k.shape) == tuple(jstate["kv"].k.shape)
    jstep = jax.jit(lambda s, t: jtransformer.decode_step(params, jc, s, t))
    chain = []
    for t in range(T):
        with torch.no_grad():
            lt, tstate = ttransformer.decode_step(
                model, tc, tstate, torch.from_numpy(tok[:, t:t + 1]))
        lj, jstate = jstep(jstate, jnp.asarray(tok[:, t:t + 1]))
        np.testing.assert_allclose(_np(lt), _np(lj), **TOL_F32,
                                   err_msg=f"step {t}")
        chain.append(lt)
    assert tstate["pos"] == int(jstate["pos"]) == T
    # decode ≡ prefill on the port's own side
    with torch.no_grad():
        full, _ = ttransformer.forward(model, tc,
                                       {"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(_np(torch.cat(chain, dim=1)), _np(full),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", DENSE)
def test_decode_step_logits_bf16(name):
    jc, tc = _cfgs(name, f32=False)
    params, model = _both_models(jc, tc)
    B, T = 2, 6
    tok = np.random.default_rng(11).integers(0, tc.vocab_size, (B, T))
    jstate = jtransformer.init_decode_state(jc, B, 8)
    tstate = ttransformer.init_decode_state(tc, B, 8, device="cpu")
    assert tstate["kv"].k.dtype == torch.bfloat16
    jstep = jax.jit(lambda s, t: jtransformer.decode_step(params, jc, s, t))
    for t in range(T):
        with torch.no_grad():
            lt, tstate = ttransformer.decode_step(
                model, tc, tstate, torch.from_numpy(tok[:, t:t + 1]))
        lj, jstate = jstep(jstate, jnp.asarray(tok[:, t:t + 1]))
        np.testing.assert_allclose(_np(lt), _np(lj), **TOL_BF16)


@pytest.mark.parametrize("name", DENSE + ["llama3-405b", "glm4-9b"])
def test_param_count_equals_closed_form(name):
    cfg = TARCHS[name].reduced()
    model = ttransformer.init_params(cfg, device="cpu")
    assert ttransformer.param_count(model) == cfg.n_params()


def test_init_is_seeded_and_scaled():
    cfg = TARCHS["llama3.2-3b"].reduced()
    a = ttransformer.init_params(cfg, device="cpu", seed=3)
    b = ttransformer.init_params(cfg, device="cpu", seed=3)
    c = ttransformer.init_params(
        cfg, torch.Generator("cpu").manual_seed(4), device="cpu")
    assert torch.equal(a.embed.weight, b.embed.weight)
    assert not torch.equal(a.embed.weight, c.embed.weight)
    std = float(a.embed.weight.detach().float().std())
    assert 0.8 * tlayers.INIT_SCALE < std < 1.2 * tlayers.INIT_SCALE
    assert torch.all(a.final_ln.scale == 1)
