"""The mixture-of-experts (mixtral-8x7b, mixtral-8x22b), vision-language
(qwen2-vl-7b) and audio (musicgen-medium) families of the port against the
JAX package, on the CPU at reduced size: ``moe_apply``, ``apply_mrope``, the
multi-codebook embedding and heads, ``forward``, ``decode_step``,
``loss_fn`` and its gradients, ``params_from_reference``, the prefill and
serve steps and the decode server.  The same numpy inputs (from a seed) and
the same parameters go through both packages.

Tolerances: f32 1e-4 (two frameworks, other summation orders); M-RoPE alone
1e-6; the multi-codebook embedding exactly; bf16 logits 3e-2, as
``tests/test_torch_models.py``.  The JAX side runs on its default path and,
for ``forward``, under ``repro.runtime.flags.use_pallas()`` (the Pallas
kernel in interpret mode).

Routing is discontinuous: in bf16 the two frameworks round the router's
input differently, and a token whose top-2 flips, or which a flip upstream
pushes past an expert's capacity, moves by O(1).  The bf16 forward of the
MoE family is therefore held to the bf16 tolerance on the tokens whose
routing (expert and kept-or-dropped, every pick of every layer) agrees
between the two packages; the f32 checks hold every token.
"""
from __future__ import annotations

import contextlib
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.runtime import flags as jflags
from repro.runtime import steps as jsteps
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer
from repro_torch.models.convert import params_from_reference
from repro_torch.runtime import server as tsrv
from repro_torch.runtime import steps as tsteps

torch.set_num_threads(1)

F32 = dict(param_dtype="float32", compute_dtype="float32")
TOL_F32 = dict(atol=1e-4, rtol=1e-4)
TOL_BF16 = dict(atol=3e-2, rtol=3e-2)
FAMILIES = ["mixtral-8x7b", "mixtral-8x22b", "qwen2-vl-7b",
            "musicgen-medium"]


def _cfgs(name, f32=True, **kw):
    """The same reduced configuration from both packages."""
    if f32:
        kw = {**F32, **kw}
    return (dataclasses.replace(JARCHS[name].reduced(), **kw),
            dataclasses.replace(TARCHS[name].reduced(), **kw))


def _both_models(jc, tc, seed=0):
    params, _ = jtransformer.init_params(jc, jax.random.PRNGKey(seed))
    model = ttransformer.init_params(tc, device="cpu", seed=seed)
    model.load_state_dict(
        params_from_reference(tc, jax.tree.map(np.asarray, params)))
    return params, model


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jax_path(pallas):
    return jflags.use_pallas() if pallas else contextlib.nullcontext()


def _batch(cfg, B=2, S=32, seed=0):
    """tokens and labels ((B, S), or (B, S, codebooks)); for the vision
    family seeded vision embeddings over the first positions and a loss
    mask that leaves them out (as ``tests/test_smoke_archs.py`` builds
    them); else a random loss mask."""
    rng = np.random.default_rng(seed)
    shape = (B, S, cfg.n_input_codebooks) if cfg.n_input_codebooks > 1 \
        else (B, S)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, shape).astype(np.int32)}
    if cfg.vision_tokens:
        batch["vision_embeds"] = (0.02 * rng.standard_normal(
            (B, cfg.vision_tokens, cfg.d_model))).astype(np.float32)
        mask = np.ones((B, S), np.float32)
        mask[:, :cfg.vision_tokens] = 0.0
    else:
        mask = (rng.random((B, S)) > 0.25).astype(np.float32)
    batch["loss_mask"] = mask
    return batch


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# models/moe.py
# ---------------------------------------------------------------------------


def _moe_pair(cfg_kw, dtype="float32", seed=0):
    jc, tc = _cfgs("mixtral-8x7b", f32=dtype == "float32", **cfg_kw)
    jdt = jnp.dtype(dtype)
    jp, _ = jmoe.moe_init(jax.random.PRNGKey(seed), jc, jdt)
    tp = tmoe.MoE(tc, getattr(torch, dtype), "cpu",
                  torch.Generator("cpu").manual_seed(seed))
    tp.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                        .to(getattr(torch, dtype)) for k, v in jp.items()})
    return jc, tc, jp, tp


MOE_CASES = {
    # B, S, capacity_factor
    "cf1.25": (2, 32, 1.25),
    "drops": (2, 32, 0.25),           # C = 8 slots for ~32 picks an expert
    "two_groups": (2, tmoe.GROUP_TOKENS, 1.25),   # B·S = 2 × GROUP_TOKENS
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_the_reference(case):
    B, S, cf = MOE_CASES[case]
    jc, tc, jp, tp = _moe_pair({"moe": dataclasses.replace(
        TARCHS["mixtral-8x7b"].reduced().moe, capacity_factor=cf)})
    x = np.random.default_rng(1).standard_normal((B, S, tc.d_model)) \
        .astype(np.float32)
    with torch.no_grad():
        out, aux = tmoe.moe_apply(tp, torch.from_numpy(x), tc)
        r = tmoe.routing(tp, torch.from_numpy(x), tc)
    rout, raux = jmoe.moe_apply(jp, jnp.asarray(x), jc)
    assert out.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(_np(out), _np(rout), **TOL_F32)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)
    G = B * S // min(tmoe.GROUP_TOKENS, B * S)
    assert tuple(r.experts.shape) == (G, B * S // G, tc.moe.top_k)
    dropped = int((~r.keep).sum())
    if case == "drops":
        assert dropped > 0
        # a dropped pick adds nothing: its gate is zero
        assert float(r.gates[~r.keep].abs().max()) == 0.0
    else:
        assert dropped == 0
    if case == "two_groups":
        assert G == 2


@pytest.mark.parametrize("case", ["cf1.25", "drops"])
def test_moe_apply_gradients_match_jax_grad(case):
    """d(Σ out·dy + aux) by the router, the experts and x, against
    ``jax.grad`` of the reference's ``moe_apply``, 1e-4."""
    B, S, cf = MOE_CASES[case]
    jc, tc, jp, tp = _moe_pair({"moe": dataclasses.replace(
        TARCHS["mixtral-8x7b"].reduced().moe, capacity_factor=cf)})
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, S, tc.d_model)).astype(np.float32)
    dy = rng.standard_normal((B, S, tc.d_model)).astype(np.float32)

    def jloss(p, xx):
        o, a = jmoe.moe_apply(p, xx, jc)
        return jnp.sum(o * dy) + a

    rgp, rgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    o, a = tmoe.moe_apply(tp, xt, tc)
    (torch.sum(o * torch.from_numpy(dy)) + a).backward()
    np.testing.assert_allclose(_np(xt.grad), _np(rgx), **TOL_F32)
    for name, p in tp.named_parameters():
        np.testing.assert_allclose(_np(p.grad), _np(rgp[name]), err_msg=name,
                                   **TOL_F32)


def test_moe_apply_bf16():
    jc, tc, jp, tp = _moe_pair({}, dtype="bfloat16")
    x = np.random.default_rng(3).standard_normal((2, 32, tc.d_model)) \
        .astype(np.float32)
    with torch.no_grad():
        out, aux = tmoe.moe_apply(tp, torch.from_numpy(x).bfloat16(), tc)
    rout, raux = jmoe.moe_apply(jp, jnp.asarray(x, jnp.bfloat16), jc)
    assert out.dtype == torch.bfloat16 and aux.dtype == torch.float32
    np.testing.assert_allclose(_np(out), _np(rout), **TOL_BF16)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)


@pytest.mark.parametrize("tokens", [1, 8, 100, 2048, 4096])
@pytest.mark.parametrize("cf", [0.25, 1.25, 4.0])
def test_capacity_matches_the_reference(tokens, cf):
    assert tmoe.GROUP_TOKENS == jmoe.GROUP_TOKENS
    for E, K in ((8, 2), (4, 2), (8, 1)):
        assert tmoe._capacity(tokens, E, K, cf) == \
            jmoe._capacity(tokens, E, K, cf)


def test_tokens_that_do_not_fill_the_groups_raise():
    _, tc, _, tp = _moe_pair({})
    with pytest.raises(ValueError, match="groups"):
        tmoe.moe_apply(tp, torch.zeros(3, 1000, tc.d_model), tc)


# ---------------------------------------------------------------------------
# M-RoPE and the vision-language attention block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("theta", [10000.0, 1000000.0])
@pytest.mark.parametrize("sections,dh", [((2, 3, 3), 16),
                                         ((16, 24, 24), 128)])
def test_apply_mrope_with_distinct_ids(theta, sections, dh):
    """(t, h, w) drawn apart, so that every section turns by its own id;
    under the stub positions (t = h = w) M-RoPE is plain RoPE and a
    whole-model test would not see the sections."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 40, 3, dh)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 40, 3))
    assert (pos[..., 0] != pos[..., 1]).any() and \
        (pos[..., 1] != pos[..., 2]).any()
    o = tattn.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), theta,
                          sections)
    r = jattn.apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta, sections)
    np.testing.assert_allclose(_np(o), _np(r), atol=1e-6, rtol=1e-6)
    same = np.broadcast_to(pos[..., :1], pos.shape).copy()
    np.testing.assert_allclose(
        _np(tattn.apply_mrope(torch.from_numpy(x), torch.from_numpy(same),
                              theta, sections)),
        _np(tattn.apply_rope(torch.from_numpy(x),
                             torch.from_numpy(same[..., 0]), theta)),
        atol=1e-6, rtol=1e-6)


def test_mrope_sections_must_cover_half_the_head():
    with pytest.raises(ValueError, match="sum"):
        tattn.apply_mrope(torch.zeros(1, 2, 1, 16),
                          torch.zeros(1, 2, 3, dtype=torch.long), 1e4,
                          (2, 3, 4))


def test_positions_for_mrope_are_the_stub():
    jc, tc = _cfgs("qwen2-vl-7b")
    o = tattn._positions_for(tc, 2, 5, offset=7)
    r = jattn._positions_for(jc, 2, 5, offset=7)
    assert tuple(o.shape) == (2, 5, 3)
    np.testing.assert_array_equal(o.numpy(), np.asarray(r))


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
def test_attn_apply_mrope_with_distinct_ids(pallas):
    """qwen2-vl's attention block (qkv bias, M-RoPE) with (t, h, w)
    positions drawn apart, on both attention paths of the port."""
    jc, tc = _cfgs("qwen2-vl-7b")
    params, model = _both_models(jc, tc, seed=4)
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["attn"])
    tp = model.blocks[0].attn
    assert tp.wq.bias is not None
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 32, tc.d_model)).astype(np.float32)
    pos = rng.integers(0, 64, (2, 32, 3))
    with torch.no_grad():
        o, _ = tattn.attn_apply(tp, torch.from_numpy(x), tc,
                                positions=torch.from_numpy(pos))
    with _jax_path(pallas):
        r, _ = jattn.attn_apply(jp, jnp.asarray(x), jc,
                                positions=jnp.asarray(pos))
    np.testing.assert_allclose(_np(o), _np(r), **TOL_F32)


# ---------------------------------------------------------------------------
# multi-codebook embedding and heads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multi_codebook_embed_is_exact(dtype):
    rng = np.random.default_rng(6)
    w = rng.standard_normal((4, 256, 64)).astype(np.float32)
    tok = rng.integers(0, 256, (2, 7, 4))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    o = tlayers.embed(torch.from_numpy(w).to(tdt), torch.from_numpy(tok))
    r = jlayers.embed({"w": jnp.asarray(w, jdt)}, jnp.asarray(tok))
    assert tuple(o.shape) == (2, 7, 64) and o.dtype == tdt
    np.testing.assert_array_equal(_np(o), _np(r))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multi_head_lm_head(dtype):
    rng = np.random.default_rng(7)
    w = rng.standard_normal((4, 64, 256)).astype(np.float32)  # (h, d, V)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    o = tlayers.lm_head(torch.from_numpy(w.transpose(0, 2, 1).copy()).to(tdt),
                        torch.from_numpy(x).to(tdt))
    r = jlayers.lm_head({"w": jnp.asarray(w, jdt)}, jnp.asarray(x, jdt))
    assert tuple(o.shape) == (2, 7, 4, 256) and o.dtype == tdt
    tol = TOL_F32 if dtype == "float32" else TOL_BF16
    np.testing.assert_allclose(_np(o), _np(r), **tol)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


def _logits_shape(cfg, B, S):
    return (B, S, cfg.n_output_heads, cfg.vocab_size) \
        if cfg.n_output_heads > 1 else (B, S, cfg.vocab_size)


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("name", FAMILIES)
def test_forward_logits_and_aux_f32(name, pallas):
    jc, tc = _cfgs(name)
    params, model = _both_models(jc, tc)
    batch = _batch(tc, seed=8)
    with torch.no_grad():
        logits, aux = ttransformer.forward(model, tc, _tb(batch))
    with _jax_path(pallas):
        ref, raux = jtransformer.forward(params, jc, _jb(batch))
    assert tuple(logits.shape) == _logits_shape(tc, 2, 32)
    np.testing.assert_allclose(_np(logits), _np(ref), **TOL_F32)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5, atol=1e-7)
    assert (float(aux) > 0) == (tc.moe is not None)


def _routing_agreement(monkeypatch, params, jc, model, tc, batch):
    """Runs both forwards, recording every MoE layer's routing; -> (port
    logits, reference logits, (B, S) bool: the tokens whose routing agrees
    in every pick of every layer).  The reference runs eagerly (no jit, no
    remat) so that the input of each of its MoE layers can be read; its
    routing is recomputed from that input with the port's ``route``."""
    B, S = batch["tokens"].shape[:2]
    seen_t, seen_j = [], []

    def rec_t(p, x, cfg, _orig=tmoe.moe_apply):
        seen_t.append(tmoe.routing(p, x, cfg))
        return _orig(p, x, cfg)

    def rec_j(p, x, cfg, _orig=jmoe.moe_apply):
        seen_j.append((np.asarray(p["router"], np.float32),
                       np.asarray(x, np.float32)))
        return _orig(p, x, cfg)

    monkeypatch.setattr(tmoe, "moe_apply", rec_t)
    monkeypatch.setattr(jmoe, "moe_apply", rec_j)
    with torch.no_grad():
        logits, _ = ttransformer.forward(model, tc, _tb(batch))
    with jax.disable_jit():
        ref, _ = jtransformer.forward(params, jc, _jb(batch), "none")
    agree = np.ones((B, S), bool)
    assert len(seen_t) == len(seen_j) == tc.n_layers * (tc.moe is not None)
    for rt, (router, x) in zip(seen_t, seen_j):
        xj = torch.from_numpy(x).to(getattr(torch, tc.compute_dtype))
        rj = tmoe.routing(types.SimpleNamespace(router=torch.from_numpy(
            router)), xj, tc)
        same = (rt.experts == rj.experts) & (rt.keep == rj.keep)
        agree &= same.all(-1).reshape(B, S).numpy()
    return logits, ref, agree


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_logits_bf16(name, monkeypatch):
    jc, tc = _cfgs(name, f32=False)
    assert tc.param_dtype == "bfloat16"
    params, model = _both_models(jc, tc)
    batch = _batch(tc, seed=9)
    logits, ref, agree = _routing_agreement(monkeypatch, params, jc, model,
                                            tc, batch)
    assert logits.dtype == torch.bfloat16
    # most tokens route alike, and those are held to the bf16 tolerance
    assert agree.mean() >= 0.75, agree.mean()
    np.testing.assert_allclose(_np(logits)[agree], _np(ref)[agree],
                               **TOL_BF16)


@pytest.mark.parametrize("name", FAMILIES)
def test_decode_step_logits_f32(name):
    jc, tc = _cfgs(name)
    params, model = _both_models(jc, tc)
    B, T = 2, 12
    tok = _batch(tc, B, T, seed=10)["tokens"]
    jstate = jtransformer.init_decode_state(jc, B, 16)
    tstate = ttransformer.init_decode_state(tc, B, 16, device="cpu")
    assert tuple(tstate["kv"].k.shape) == tuple(jstate["kv"].k.shape)
    jstep = jax.jit(lambda s, t: jtransformer.decode_step(params, jc, s, t))
    for t in range(T):
        with torch.no_grad():
            lt, tstate = ttransformer.decode_step(
                model, tc, tstate, torch.from_numpy(tok[:, t:t + 1]))
        lj, jstate = jstep(jstate, jnp.asarray(tok[:, t:t + 1]))
        assert tuple(lt.shape) == _logits_shape(tc, B, 1)
        np.testing.assert_allclose(_np(lt), _np(lj), **TOL_F32,
                                   err_msg=f"step {t}")
    assert tstate["pos"] == int(jstate["pos"]) == T


@pytest.mark.parametrize("name", FAMILIES)
def test_decode_equals_prefill(name):
    """On the port's own side, text only (decode takes no vision
    embeddings) and, for the MoE, at ``capacity_factor = E / K``: decode
    routes groups of B tokens with C = max(⌈K·B·cf/E⌉, 4) and prefill groups
    of B·S, so one token may be dropped on one path and kept on the other;
    at E / K no group can drop.  Without mixtral's sliding window, which
    masks nothing in 12 tokens: with one, the decode cache is a ring of
    ``window`` rows that the reference's decode attends whole, rows not yet
    written included (``test_torch_models.py`` holds that against it)."""
    kw = {"vision_tokens": 0, "sliding_window": None}
    if TARCHS[name].moe is not None:
        m = TARCHS[name].reduced().moe
        kw["moe"] = dataclasses.replace(
            m, capacity_factor=m.n_experts / m.top_k)
    jc, tc = _cfgs(name, **kw)
    _, model = _both_models(jc, tc)
    B, T = 2, 12
    tok = torch.from_numpy(_batch(tc, B, T, seed=11)["tokens"])
    state = ttransformer.init_decode_state(tc, B, 16, device="cpu")
    chain = []
    with torch.no_grad():
        for t in range(T):
            lt, state = ttransformer.decode_step(model, tc, state,
                                                 tok[:, t:t + 1])
            chain.append(lt)
        full, _ = ttransformer.forward(model, tc, {"tokens": tok})
    np.testing.assert_allclose(_np(torch.cat(chain, dim=1)), _np(full),
                               **TOL_F32)


@pytest.mark.parametrize("policy", ["none", "dots", "full"])
@pytest.mark.parametrize("name", FAMILIES)
def test_loss_fn_value_and_grads_match_the_reference(name, policy):
    """Mirrors ``tests/test_smoke_archs.py::test_train_grad_step``: the
    port's loss (the cross-entropy over every head, masked, plus the MoE's
    weighted aux term) and its gradients against ``jax.value_and_grad`` of
    the reference's ``loss_fn`` under the same remat policy, 1e-4."""
    jc, tc = _cfgs(name)
    params, model = _both_models(jc, tc)
    batch = _batch(tc, seed=12)
    (rl, rm), rg = jax.value_and_grad(jtransformer.loss_fn, has_aux=True)(
        params, jc, _jb(batch), policy)
    loss, metrics = ttransformer.loss_fn(model, tc, _tb(batch),
                                         remat_policy=policy)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(rl), rtol=1e-5,
                               atol=1e-6)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(metrics[k].detach()), float(rm[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    if tc.moe is not None:
        assert float(loss.detach()) == pytest.approx(
            float(metrics["ce"].detach()) + tc.moe.aux_loss_weight
            * float(metrics["aux"].detach()), rel=1e-6)
    want = params_from_reference(tc, jax.tree.map(np.asarray, rg))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_allclose(_np(got[n]), _np(want[n]), err_msg=n,
                                   **TOL_F32)


@pytest.mark.parametrize("name", FAMILIES)
def test_params_from_reference_layout(name):
    jc, tc = _cfgs(name)
    params, _ = jtransformer.init_params(jc, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    sd = params_from_reference(tc, tree)
    model = ttransformer.init_params(tc, device="cpu")
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in model.state_dict().items()}
    np.testing.assert_array_equal(sd["embed.weight"].numpy(),
                                  tree["embed"]["w"])
    np.testing.assert_array_equal(sd["head.weight"].numpy(),
                                  np.swapaxes(tree["head"]["w"], -1, -2))
    if tc.moe is not None:
        for n in ("router", "gate", "up", "down"):
            np.testing.assert_array_equal(sd[f"blocks.1.moe.{n}"].numpy(),
                                          tree["blocks"]["moe"][n][1])
    if tc.use_qkv_bias:
        np.testing.assert_array_equal(sd["blocks.1.attn.wk.bias"].numpy(),
                                      tree["blocks"]["attn"]["wk"]["b"][1])


@pytest.mark.parametrize("name", FAMILIES)
def test_param_count_equals_closed_form(name):
    cfg = TARCHS[name].reduced()
    model = ttransformer.init_params(cfg, device="cpu")
    assert ttransformer.param_count(model) == cfg.n_params()


# ---------------------------------------------------------------------------
# steps and the server
# ---------------------------------------------------------------------------


def test_prefill_step_takes_vision_embeds_and_loss_mask():
    jc, tc = _cfgs("qwen2-vl-7b")
    params, model = _both_models(jc, tc)
    batch = _batch(tc, seed=13)
    logits = tsteps.make_prefill_step(tc)(model, _tb(batch))
    ref = jsteps.make_prefill_step(jc)(params, _jb(batch))
    np.testing.assert_allclose(_np(logits), _np(ref), **TOL_F32)
    other = dict(batch, vision_embeds=batch["vision_embeds"] + 1.0)
    moved = tsteps.make_prefill_step(tc)(model, _tb(other))
    assert not torch.allclose(moved, logits)


@pytest.mark.parametrize("name", ["musicgen-medium", "mixtral-8x7b"])
def test_greedy_serve_chain_gives_the_same_tokens(name):
    """musicgen: one token per codebook head, (B, 4), each the argmax over
    its own head's logits, as the reference's serve step."""
    jc, tc = _cfgs(name)
    params, model = _both_models(jc, tc)
    B, T = 2, 8
    first = _batch(tc, B, 1, seed=14)["tokens"]
    tstep = tsteps.make_serve_step(tc, sample=False)
    jstep = jax.jit(jsteps.make_serve_step(jc, sample=False))
    tstate = ttransformer.init_decode_state(tc, B, 16, device="cpu")
    jstate = jtransformer.init_decode_state(jc, B, 16)
    ttok, jtok = torch.from_numpy(first).long(), jnp.asarray(first)
    tchain, jchain = [], []
    for _ in range(T):
        nt, tstate = tstep(model, tstate, ttok)
        nj, jstate = jstep(params, jstate, jtok, jax.random.PRNGKey(0))
        tchain.append(nt.numpy())
        jchain.append(np.asarray(nj))
        ttok, jtok = nt[:, None].long(), nj[:, None]
    assert nt.dtype == torch.int32
    assert tuple(nt.shape) == ((B, tc.n_output_heads)
                               if tc.n_output_heads > 1 else (B,))
    np.testing.assert_array_equal(np.stack(tchain), np.stack(jchain))


def test_sampled_serve_step_over_codebook_heads():
    _, tc = _cfgs("musicgen-medium")
    model = ttransformer.init_params(tc, device="cpu")
    step = tsteps.make_serve_step(tc, sample=True, temperature=0.8)
    tok = torch.full((3, 1, tc.n_input_codebooks), 5)
    outs = []
    for _ in range(2):
        state = ttransformer.init_decode_state(tc, 3, 8, device="cpu")
        nxt, state = step(model, state, tok,
                          torch.Generator("cpu").manual_seed(7))
        outs.append(nxt)
    assert torch.equal(outs[0], outs[1])
    assert tuple(nxt.shape) == (3, tc.n_output_heads) and state["pos"] == 1
    assert int(nxt.min()) >= 0 and int(nxt.max()) < tc.vocab_size


@pytest.mark.parametrize("name", ["mixtral-8x7b", "qwen2-vl-7b"])
def test_server_serves_moe_and_vlm_text_only(name):
    _, tc = _cfgs(name)
    model = ttransformer.init_params(tc, device="cpu")
    srv = tsrv.DecodeServer(tc, model, slots=2, max_len=64, seed=0,
                            device="cpu")
    rng = np.random.default_rng(0)
    for rid in range(4):
        srv.submit(tsrv.Request(rid=rid, prompt=rng.integers(
            2, 200, 5).astype(np.int32), max_new=4))
    done = srv.run()
    assert len(done) == 4 and all(r.done for r in done)
    assert all(0 <= t < tc.vocab_size for r in done for t in r.out)


def test_server_refuses_codebooks_as_the_reference():
    _, tc = _cfgs("musicgen-medium")
    model = ttransformer.init_params(tc, device="cpu")
    with pytest.raises(NotImplementedError, match="one codebook"):
        tsrv.DecodeServer(tc, model, device="cpu")


def test_launcher_serves_mixtral_reduced_on_cpu(capsys):
    tserve.main(["--arch", "mixtral-8x7b", "--reduced", "--device", "cpu",
                 "--requests", "3", "--slots", "2", "--max-new", "3",
                 "--max-len", "64"])
    out = capsys.readouterr().out
    assert "[serve] 3 requests" in out and "device=cpu" in out
