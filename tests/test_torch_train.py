"""The port's training path against the JAX package, on the CPU: the loss,
the attention and SSD-scan Functions' backwards, ``loss_fn`` under the three
remat policies, ``make_train_step`` and the ``Trainer``.

The same numpy inputs and parameters (``params_from_reference``) go through
both packages.  On the CPU the kernel wrappers run their plain versions, so
``_FlashAttention`` here is the plain forward with its row log-sum-exp under
the ported chunked backward.

Tolerances (f32): the loss 1e-6; the attention and SSD gradients, and
``loss_fn``'s gradients, 1e-4 (two frameworks, other summation orders); the
row log-sum-exp 1e-5; loss histories and final parameters of 5 steps rtol
1e-4; a resumed run replays its losses to rtol 1e-5 (mirrors
``tests/test_trainer_server.py``).
"""
from __future__ import annotations

import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.data.pipeline import DataConfig as JDataConfig
from repro.distributed.plan import Plan as JPlan
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro.optim import optimizers as jopt
from repro.runtime import steps as jsteps
from repro.runtime.trainer import Trainer as JTrainer
from repro.runtime.trainer import TrainerConfig as JTrainerConfig
from repro_torch.checkpoint import store
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.data.pipeline import DataConfig
from repro_torch.distributed.plan import Plan
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttransformer
from repro_torch.models.convert import params_from_reference
from repro_torch.optim import optimizers as topt
from repro_torch.runtime import steps as tsteps
from repro_torch.runtime.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
F32 = dict(param_dtype="float32", compute_dtype="float32")
TOL_GRAD = dict(atol=1e-4, rtol=1e-4)
ARCH3 = ["llama3.2-3b", "zamba2-2.7b", "mamba2-370m"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _cfgs(name, **kw):
    kw = {**F32, **kw}
    return (dataclasses.replace(JARCHS[name].reduced(), **kw),
            dataclasses.replace(TARCHS[name].reduced(), **kw))


def _reference_params(jc, seed=0):
    params, _ = jtransformer.init_params(jc, jax.random.PRNGKey(seed))
    return params, jax.tree.map(np.asarray, params)


def _batch(cfg, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "loss_mask": (rng.random((B, S)) > 0.25).astype(np.float32)}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True], ids=["mean", "masked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_xent_matches_the_reference(masked, dtype):
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((2, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) > 0.3).astype(np.float32) if masked else None
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    jl = jnp.asarray(logits, getattr(jnp, dtype))
    t = tlayers.softmax_xent(tl, torch.from_numpy(labels),
                             None if mask is None else torch.from_numpy(mask))
    j = jlayers.softmax_xent(jl, jnp.asarray(labels),
                             None if mask is None else jnp.asarray(mask))
    assert t.dtype == torch.float32
    np.testing.assert_allclose(float(t), float(j), rtol=1e-6, atol=1e-6)


def test_softmax_xent_with_an_empty_mask_is_zero():
    z = tlayers.softmax_xent(torch.randn(2, 3, 5), torch.zeros(2, 3,
                                                               dtype=torch.long),
                             torch.zeros(2, 3))
    assert float(z) == 0.0


# ---------------------------------------------------------------------------
# attention: the Functions' backward, the row log-sum-exp, the dispatch
# ---------------------------------------------------------------------------

# name, B, H, KVH, S, dh, window
ATTN_CASES = [("gqa", 2, 4, 2, 256, 32, None),
              ("mha", 1, 4, 4, 256, 32, None),
              ("mqa", 1, 4, 1, 256, 16, None),
              ("window", 2, 4, 2, 256, 32, 48)]


def _qkv(B, H, KVH, S, dh, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, S, KVH, dh)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, dh)).astype(np.float32)
    do = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    return q, k, v, do


def _reference_flash(q, k, v, do, causal, window, cq, ck):
    scale = 1.0 / math.sqrt(q.shape[-1])
    o, vjp = jax.vjp(
        lambda a, b, c: jattn._flash_xla(a, b, c, jnp.float32(0.0), causal,
                                         window, scale, cq, ck),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return o, vjp(jnp.asarray(do))


@pytest.mark.parametrize("fn", ["kernel", "chunked"])
@pytest.mark.parametrize("case", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
def test_flash_backward_matches_reference_flash_xla(case, fn):
    """dq, dk, dv of ``_FlashAttention`` (plain forward + lse on the CPU)
    and of ``_FlashXLA`` (the chunked forward) against ``jax.vjp`` through
    the reference's ``_flash_xla`` custom VJP, chunks 64 × 128."""
    _, B, H, KVH, S, dh, window = case
    q, k, v, do = _qkv(B, H, KVH, S, dh)
    ro, (rdq, rdk, rdv) = _reference_flash(q, k, v, do, True, window, 64, 128)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    if fn == "kernel":
        o = tattn._FlashAttention.apply(tq, tk, tv, window, 64, 128, True)
    else:
        o = tattn._FlashXLA.apply(tq, tk, tv, 0, True, window, 64, 128)
    o.backward(torch.from_numpy(do))
    np.testing.assert_allclose(_np(o), _np(ro), atol=1e-5, rtol=1e-5)
    for t, r, name in ((tq, rdq, "dq"), (tk, rdk, "dk"), (tv, rdv, "dv")):
        np.testing.assert_allclose(_np(t.grad), _np(r), err_msg=name,
                                   **TOL_GRAD)


def test_chunked_backward_without_a_causal_mask():
    q, k, v, do = _qkv(1, 4, 2, 256, 16, seed=3)
    ro, (rdq, rdk, rdv) = _reference_flash(q, k, v, do, False, None, 128, 64)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = tattn._FlashXLA.apply(tq, tk, tv, 0, False, None, 128, 64)
    o.backward(torch.from_numpy(do))
    np.testing.assert_allclose(_np(o), _np(ro), atol=1e-5, rtol=1e-5)
    for t, r in ((tq, rdq), (tk, rdk), (tv, rdv)):
        np.testing.assert_allclose(_np(t.grad), _np(r), **TOL_GRAD)


@pytest.mark.parametrize("case", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
def test_row_lse_matches_reference_chunked_attention(case):
    """The plain version's lse (what the kernels write) and the port's
    ``_chunked_attention``'s against the reference's ``_chunked_attention``:
    1e-5."""
    _, B, H, KVH, S, dh, window = case
    q, k, v, _ = _qkv(B, H, KVH, S, dh, seed=1)
    scale = 1.0 / math.sqrt(dh)
    ro, rlse = jattn._chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.arange(S),
        jnp.arange(S), True, window, scale, 64, 128)
    rlse = _np(rlse).reshape(B, S, H).transpose(0, 2, 1)     # (B, H, S)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = tfa.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                                 tv.transpose(1, 2), causal=True,
                                 window=window, return_lse=True)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(_np(lse), rlse, atol=1e-5, rtol=1e-5)
    co, clse = tattn._chunked_attention(tq, tk, tv, 0, True, window, scale,
                                        64, 128)
    np.testing.assert_allclose(_np(clse).reshape(B, S, H).transpose(0, 2, 1),
                               rlse, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(co), _np(ro), atol=1e-5, rtol=1e-5)


def test_lse_of_a_row_that_sees_no_key_is_floored():
    """A window with Sq > Skv leaves query rows with no visible key: their
    lse is the reference's floor, -1e4 + ln(1e-20)."""
    q = torch.randn(1, 1, 8, 16)
    k = v = torch.randn(1, 1, 4, 16)
    _, lse = tfa.flash_attention(q, k, v, causal=True, window=2,
                                 return_lse=True)
    assert float(lse[0, 0, -1]) == pytest.approx(-1e4 + math.log(1e-20))


@pytest.mark.parametrize("S,lowered,chunked",
                         [(512, True, True), (512, False, False),
                          (256, True, False)],
                         ids=["above", "default-threshold", "not-512"])
def test_attention_core_dispatch(monkeypatch, S, lowered, chunked):
    """Under ``use_kernels(False)`` the chunked path serves Sq·Skv above
    ``CHUNKED_ABOVE`` (lowered here so that the CPU can carry a case just
    above it) when both lengths are multiples of 512; gradients match the
    reference's ``attention_core`` with ``force_chunked`` (1e-4)."""
    if lowered:
        monkeypatch.setattr(tattn, "CHUNKED_ABOVE", S * S - 1)
    calls = []
    real = tattn._chunked_attention
    monkeypatch.setattr(tattn, "_chunked_attention",
                        lambda *a: calls.append(a[-2:]) or real(*a))
    q, k, v, do = _qkv(1, 4, 2, S, 16, seed=2)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = tattn.attention_core(tq, tk, tv, causal=True, chunk_q=256,
                             chunk_kv=128)
    o.backward(torch.from_numpy(do))
    assert bool(calls) == chunked
    if chunked:
        assert calls[0] == (256, 128)
    ro, vjp = jax.vjp(lambda a, b, c: jattn.attention_core(
        a, b, c, causal=True, chunk_q=256, chunk_kv=128, force_chunked=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(_np(o), _np(ro), atol=1e-5, rtol=1e-5)
    for t, r in zip((tq, tk, tv), vjp(jnp.asarray(do))):
        np.testing.assert_allclose(_np(t.grad), _np(r), **TOL_GRAD)


def test_attention_function_computes_lse_only_for_a_gradient(monkeypatch):
    """Without autograd the Function's forward is the prefill's one call,
    without the row log-sum-exp."""
    asked = []
    real = tattn.kops.flash_attention
    monkeypatch.setattr(tattn.kops, "flash_attention",
                        lambda *a, **kw: asked.append(kw["return_lse"])
                        or real(*a, **kw))
    q, k, v, _ = _qkv(1, 2, 1, 16, 8)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    with torch.no_grad():
        tattn._FlashAttention.apply(tq, tk, tv, None, 16, 16, False)
    tattn._FlashAttention.apply(tq, tk, tv, None, 16, 16,
                                True).sum().backward()
    assert asked == [False, True]


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------

# Bz, H, G, L, P, N, chunk
SSD_GRAD_CASES = [(2, 4, 1, 64, 8, 16, 16), (1, 4, 2, 48, 8, 8, 16),
                  (1, 2, 1, 32, 16, 8, 32)]


@pytest.mark.parametrize("case", SSD_GRAD_CASES,
                         ids=["g1", "g2", "one-chunk"])
def test_ssd_backward_matches_jax_grad_of_ssd_chunked(case):
    """Gradients of ``_SSDScan`` (plain forward on the CPU, the backward's
    recompute of ``ssd_scan_reference``) against ``jax.vjp`` through the
    reference's ``_ssd_chunked``, for x, dt, A, B, C: 1e-4."""
    Bz, H, G, L, P, N, chunk = case
    rng = np.random.default_rng(7)
    x = rng.standard_normal((Bz, L, H, P)).astype(np.float32)
    dt = (0.1 + 0.5 * rng.random((Bz, L, H))).astype(np.float32)
    A = -(0.5 + rng.random(H)).astype(np.float32)
    Bm = rng.standard_normal((Bz, L, G, N)).astype(np.float32)
    Cm = rng.standard_normal((Bz, L, G, N)).astype(np.float32)
    dy = rng.standard_normal((Bz, L, H, P)).astype(np.float32)
    (ry, _), vjp = jax.vjp(
        lambda *a: jssm._ssd_chunked(*a, chunk),
        *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)))
    rgrads = vjp((jnp.asarray(dy), jnp.zeros((Bz, H, P, N), jnp.float32)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, dt, A, Bm, Cm)]
    tx, tdt, tA, tB, tC = ts
    y = tssm._SSDScan.apply(tx.transpose(1, 2), tdt.transpose(1, 2), tA,
                            tB.transpose(1, 2), tC.transpose(1, 2), chunk)
    y.transpose(1, 2).backward(torch.from_numpy(dy))
    np.testing.assert_allclose(_np(y.transpose(1, 2)), _np(ry), **TOL_GRAD)
    for t, r, name in zip(ts, rgrads, ("x", "dt", "A", "B", "C")):
        np.testing.assert_allclose(_np(t.grad), _np(r), err_msg=name,
                                   **TOL_GRAD)


# ---------------------------------------------------------------------------
# loss_fn: value and gradients, three archs × three remat policies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["none", "dots", "full"])
@pytest.mark.parametrize("arch", ARCH3)
def test_loss_fn_value_and_grads_match_the_reference(arch, policy):
    """Mirrors ``tests/test_smoke_archs.py::test_train_grad_step``: the
    port's loss and gradients (as a ``state_dict``) against
    ``jax.value_and_grad`` of the reference's ``loss_fn`` under the same
    policy, 1e-4; the policy changes nothing."""
    jc, tc = _cfgs(arch)
    params, tree = _reference_params(jc)
    batch = _batch(jc)
    (rl, rm), rg = jax.value_and_grad(jtransformer.loss_fn, has_aux=True)(
        params, jc, _jb(batch), policy)
    model = ttransformer.init_params(tc, device="cpu", seed=0)
    model.load_state_dict(params_from_reference(tc, tree))
    loss, metrics = ttransformer.loss_fn(model, tc, _tb(batch),
                                         remat_policy=policy)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(rl), rtol=1e-5,
                               atol=1e-6)
    assert float(metrics["ce"].detach()) == float(loss.detach())
    assert float(metrics["aux"]) == 0
    want = params_from_reference(tc, jax.tree.map(np.asarray, rg))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_allclose(_np(got[n]), _np(want[n]), err_msg=n,
                                   **TOL_GRAD)


def test_remat_runs_the_kernel_forward_twice_per_layer(monkeypatch):
    """Under ``full`` the backward recomputes each block's forward, so the
    attention wrapper is called twice per layer (the count chip_smoke.py
    holds the card to), once without remat."""
    jc, tc = _cfgs("llama3.2-3b")
    model = ttransformer.init_params(tc, device="cpu", seed=0)
    calls = []
    real = tattn.kops.flash_attention
    monkeypatch.setattr(tattn.kops, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    batch = _tb(_batch(tc))
    for policy, want in (("none", 1), ("full", 2)):
        calls.clear()
        ttransformer.loss_fn(model, tc, batch, policy)[0].backward()
        assert len(calls) == want * tc.n_layers, policy


def test_unknown_remat_policy_raises():
    _, tc = _cfgs("llama3.2-3b")
    model = ttransformer.init_params(tc, device="cpu", seed=0)
    with pytest.raises(ValueError, match="remat"):
        ttransformer.loss_fn(model, tc, _tb(_batch(tc)), "everything")


# ---------------------------------------------------------------------------
# make_train_step and the Trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_history_matches_the_reference(microbatches):
    """5 steps of ``make_train_step`` (adamw, warmup_cosine, clip 1.0) from
    the same parameters and batches: loss history, gradient norms and final
    parameters at rtol 1e-4."""
    jc, tc = _cfgs("llama3.2-3b")
    lr = (3e-3, 2, 10)
    params, tree = _reference_params(jc, seed=3)
    jopt_ = jopt.adamw()
    jstate = jsteps.TrainState(params, jopt_.init(params), jnp.int32(0))
    jstep = jax.jit(jsteps.make_train_step(
        jc, jopt_, JPlan(microbatches=microbatches),
        lr_schedule=jopt.warmup_cosine(*lr)))
    topt_ = topt.adamw()
    tstate = tsteps.init_train_state(tc, torch.Generator().manual_seed(0),
                                     topt_, device="cpu")
    tstate.params.load_state_dict(params_from_reference(tc, tree))
    tstep = tsteps.make_train_step(tc, topt_, Plan(microbatches=microbatches),
                                   lr_schedule=topt.warmup_cosine(*lr))
    for i in range(5):
        batch = _batch(tc, B=4, seed=10 + i)
        jstate, jm = jstep(jstate, _jb(batch))
        tstate, tm = tstep(tstate, _tb(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
    assert tstate.step == 5 and tstate.opt_state["count"] == 5
    want = params_from_reference(tc, jax.tree.map(np.asarray, jstate.params))
    for n, p in tstate.params.named_parameters():
        np.testing.assert_allclose(_np(p), _np(want[n]), rtol=1e-4,
                                   atol=1e-5, err_msg=n)


def _mk(tmp_path, save_on_exit=True, total=30, arch="smollm-360m"):
    cfg = TARCHS[arch].reduced()
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4,
                    seed=5)
    tc = TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=5, log_every=1000,
                       total_steps=total, save_on_exit=save_on_exit)
    return Trainer(cfg, dc, tc, device="cpu")


def test_trainer_loss_finite_and_checkpoints(tmp_path):
    t = _mk(tmp_path)
    hist = t.train(8)
    assert len(hist) == 8
    assert all(np.isfinite(m["loss"]) for m in hist)
    assert store.latest_step(str(tmp_path)) == 8  # save_on_exit


def test_trainer_resume_is_exact(tmp_path):
    t1 = _mk(tmp_path, save_on_exit=False)
    t1.train(9)  # ckpts at 5; runs to 9
    ref = [m["loss"] for m in t1.history]
    del t1
    t2 = _mk(tmp_path, save_on_exit=False)
    assert t2.step == 5
    t2.train(4)  # replay 5..8
    np.testing.assert_allclose(ref[5:9],
                               [m["loss"] for m in t2.history], rtol=1e-5)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "zamba2-2.7b"])
def test_trainer_history_matches_the_reference_trainer(tmp_path, arch):
    """5 steps of both Trainers (the config's adamw and remat, the packed
    loader, warmup_cosine), the reference's initial parameters loaded into
    the port's state: loss histories at rtol 1e-4."""
    jc, tc = _cfgs(arch)
    kw = dict(vocab_size=tc.vocab_size, seq_len=32, global_batch=2, seed=5)
    jt = JTrainer(jc, JDataConfig(**kw),
                  JTrainerConfig(log_every=1000, seed=1, lr=3e-3, warmup=2))
    tree = jax.tree.map(np.asarray, jt.state.params)
    tt = Trainer(tc, DataConfig(**kw),
                 TrainerConfig(log_every=1000, seed=1, lr=3e-3, warmup=2),
                 device="cpu")
    tt.state.params.load_state_dict(params_from_reference(tc, tree))
    want = [m["loss"] for m in jt.train(5)]
    got = [m["loss"] for m in tt.train(5)]
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_trainer_defaults_to_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU")
    cfg = TARCHS["smollm-360m"].reduced()
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, dc, TrainerConfig())
    with pytest.raises(NotImplementedError, match="A13"):
        Trainer(cfg, dc, TrainerConfig(online_calibrate=True), device="cpu")
    with pytest.raises(NotImplementedError, match="A13"):
        Trainer(cfg, dc, TrainerConfig(), injector=object(), device="cpu")


def test_launch_train_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "llama3.2-3b", "--reduced", "--device", "cpu", "--steps", "3",
         "--batch", "2", "--seq", "32", "--ckpt", str(tmp_path / "ck"),
         "--metrics-json", str(tmp_path / "m.json")],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[train] done: loss" in out.stdout
    assert store.latest_step(str(tmp_path / "ck")) == 3
    assert "repro_train_step_seconds" in (tmp_path / "m.json").read_text()


def test_remat_recompute_takes_the_forward_path_on_another_thread(
        monkeypatch):
    """For CUDA tensors autograd runs the backward, and so the remat
    recompute, on a thread of its own, where the thread-local flags are at
    their defaults: the recompute must still take the forward's path (here
    the plain one, under ``use_kernels(False)``)."""
    import threading
    from repro_torch.runtime import flags
    _, tc = _cfgs("zamba2-2.7b")
    model = ttransformer.init_params(tc, device="cpu", seed=0)
    calls = []
    real_fa, real_ssd = tattn.kops.flash_attention, tattn.kops.ssd_scan
    monkeypatch.setattr(tattn.kops, "flash_attention",
                        lambda *a, **kw: calls.append(flags.kernels_enabled())
                        or real_fa(*a, **kw))
    monkeypatch.setattr(tattn.kops, "ssd_scan",
                        lambda *a, **kw: calls.append(flags.kernels_enabled())
                        or real_ssd(*a, **kw))
    with flags.use_kernels(False):
        loss, _ = ttransformer.loss_fn(model, tc, _tb(_batch(tc)), "full")
    errors = []

    def backward():
        try:
            loss.backward()
        except Exception as e:  # surfaced below
            errors.append(e)

    th = threading.Thread(target=backward)
    th.start()
    th.join(timeout=120)
    assert not th.is_alive() and not errors, errors
    # the SSD wrapper runs (its plain version) in the forward and in the
    # recompute, both with kernels off; attention takes the plain path
    assert calls and not any(calls)
