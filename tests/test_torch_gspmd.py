"""The DTensor-sharded steps on 4 gloo ranks against the reference's
unsharded steps and the port's own, on the CPU.

One 4-rank launch (``_torch_ranks.py gspmd``) on a (2, 2) ``data, model``
mesh runs, each under its ``plan_for(..., tp_size=2)`` plan (FSDP and
sequence parallelism for training): two AdamW steps of smollm-360m
reduced; the prefill of zamba2-2.7b reduced (the SSD scan and the shared
attention on each rank's heads, under ``local_map``); decode iterations of
llama3.2-3b reduced; the prefill of mixtral-8x7b reduced (4 experts) under
``moe_mode="ep"``; two steps of a llama3.2-3b reduced with one kv head,
fewer than the model axis's two ranks (each rank reads the kv head its q
heads use); two Adafactor steps of smollm-360m reduced (its factored
moments reduce over sharded dims).  The first case's model is built
straight into its shards (``init_params(mesh=, plan=)``).  The ranks meet
through a ``FileStore`` in the test's temporary directory.  Every configuration is f32, and both packages get the same
parameters (``models/convert``) and tokens (numpy, seeded).

Tolerances: against the reference's unsharded steps 1e-4 relative (the DP
bar of ``test_torch_multidevice.py``: two frameworks' summation orders);
against the port's own unsharded steps 1e-5 relative (logits, losses and
gradient norms), gradients within 1e-5 of their largest magnitude; the
sampled tokens equal.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_ranks as ranks  # noqa: E402

from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.optim import optimizers as opt  # noqa: E402
from repro_torch.runtime import steps  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RANKS = 4
B, S, N_DEC = ranks.GSPMD_B, ranks.GSPMD_S, ranks.GSPMD_DECODE_STEPS
REF_RTOL, PORT_RTOL = 1e-4, 1e-5


def _jcfg(case):
    import dataclasses
    arch, edit, _, _ = ranks.GSPMD_CASES[case]
    return dataclasses.replace(JARCHS[arch].reduced(), **ranks.DP_CFG,
                               **edit)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v, dtype=np.float32)
    return out


def _inputs(data: Path) -> dict:
    rng = np.random.default_rng(0)
    inp, params = {}, {}
    for i, case in enumerate(ranks.GSPMD_CASES):
        jcfg = _jcfg(case)
        inp[f"{case}_tokens"] = rng.integers(
            0, jcfg.vocab_size, (B, S)).astype(np.int32)
        inp[f"{case}_labels"] = rng.integers(
            0, jcfg.vocab_size, (B, S)).astype(np.int32)
        inp[f"{case}_feed"] = rng.integers(
            0, jcfg.vocab_size, (B, N_DEC)).astype(np.int32)
        p, _ = jtransformer.init_params(jcfg, jax.random.PRNGKey(i))
        params[case] = p
        np.savez(data / f"params.{case}.npz", **_flatten(p))
    np.savez(data / "inputs.npz", **inp)
    return inp, params


def _reference(inp, params) -> dict:
    """The reference's unsharded steps, in this process."""
    out = {}
    for case, (_, _, phase, _) in ranks.GSPMD_CASES.items():
        jcfg, p = _jcfg(case), params[case]
        tokens = jnp.asarray(inp[f"{case}_tokens"])
        if phase == "train":
            optimizer = jopt.get_optimizer(jcfg.optimizer)
            st = jsteps.TrainState(p, optimizer.init(p),
                                   jnp.zeros((), jnp.int32))
            fn = jax.jit(jsteps.make_train_step(jcfg, optimizer))
            batch = {"tokens": tokens,
                     "labels": jnp.asarray(inp[f"{case}_labels"])}
            ls, ns = [], []
            for _ in range(2):
                st, m = fn(st, batch)
                ls.append(float(m["loss"]))
                ns.append(float(m["grad_norm"]))
            out[f"{case}_loss"], out[f"{case}_grad_norm"] = ls, ns
        elif phase == "prefill":
            logits, _ = jtransformer.forward(p, jcfg, {"tokens": tokens})
            out[f"{case}_logits"] = np.asarray(logits)
        else:
            state = jtransformer.init_decode_state(jcfg, B, S)
            feed, lg = jnp.asarray(inp[f"{case}_feed"]), []
            for i in range(N_DEC):
                logits, state = jtransformer.decode_step(p, jcfg, state,
                                                         feed[:, i:i + 1])
                lg.append(np.asarray(logits))
            out[f"{case}_logits"] = np.stack(lg)
    return out


def _port(inp, params) -> dict:
    """The port's unsharded steps, in this process."""
    out = {}
    for case, (_, _, phase, _) in ranks.GSPMD_CASES.items():
        cfg = ranks.gspmd_cfg(case)
        flat = {k: np.asarray(v) for k, v in _flatten(params[case]).items()}
        p = ranks._unflatten(flat)
        tokens = torch.from_numpy(inp[f"{case}_tokens"])
        if phase == "train":
            optimizer = opt.get_optimizer(cfg.optimizer)
            st = ranks._state(cfg, p, optimizer)
            batch = {"tokens": tokens,
                     "labels": torch.from_numpy(inp[f"{case}_labels"])}
            named = dict(st.params.named_parameters())
            loss, _ = transformer.loss_fn(st.params, cfg, batch)
            out[f"{case}_grad"] = dict(zip(named, (g.numpy() for g in
                                                    torch.autograd.grad(
                                                        loss, list(
                                                            named.values())))))
            fn = steps.make_train_step(cfg, optimizer)
            ls, ns = [], []
            for _ in range(2):
                st, m = fn(st, batch)
                ls.append(float(m["loss"]))
                ns.append(float(m["grad_norm"]))
            out[f"{case}_loss"], out[f"{case}_grad_norm"] = ls, ns
        elif phase == "prefill":
            model = ranks._model(cfg, p)
            out[f"{case}_logits"] = steps.make_prefill_step(cfg)(
                model, {"tokens": tokens}).numpy()
        else:
            model = ranks._model(cfg, p)
            feed = torch.from_numpy(inp[f"{case}_feed"])
            state = transformer.init_decode_state(cfg, B, S, device="cpu")
            lg = []
            with torch.no_grad():
                for i in range(N_DEC):
                    logits, state = transformer.decode_step(
                        model, cfg, state, feed[:, i:i + 1])
                    lg.append(logits.numpy())
            out[f"{case}_logits"] = np.stack(lg)
            state = transformer.init_decode_state(cfg, B, S, device="cpu")
            gen = torch.Generator().manual_seed(5)
            serve = steps.make_serve_step(cfg)
            tok, toks = feed[:, :1], []
            for _ in range(N_DEC):
                nxt, state = serve(model, state, tok, gen)
                toks.append(nxt.numpy())
                tok = nxt[:, None]
            out[f"{case}_tokens"] = np.stack(toks)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's 4 ranks, and meanwhile the reference's and the port's
    unsharded steps in this process, from the same inputs."""
    data = tmp_path_factory.mktemp("gspmd")
    inp, params = _inputs(data)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_ranks.py"), "gspmd",
         str(r), str(RANKS), str(data)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(RANKS)]
    ref, port = _reference(inp, params), _port(inp, params)
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    sharded = [dict(np.load(data / f"gspmd.{r}.npz")) for r in range(RANKS)]
    return {"ref": ref, "port": port, "sharded": sharded}


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("case", ["train", "kvh", "adafactor"])
def test_sharded_train_steps_match_both_unsharded_steps(runs, case):
    """Two steps' losses and gradient norms, against the reference's
    unsharded step and the port's."""
    for out in runs["sharded"]:
        assert int(out[f"{case}_steps"]) == 2
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(out[f"{case}_{key}"],
                                       runs["ref"][f"{case}_{key}"],
                                       rtol=REF_RTOL)
            np.testing.assert_allclose(out[f"{case}_{key}"],
                                       runs["port"][f"{case}_{key}"],
                                       rtol=PORT_RTOL)


def test_parameters_and_state_are_built_sharded(runs):
    """``init_params(mesh=, plan=)`` builds the model straight into
    DTensors, and the optimizer's state comes out laid out as them."""
    for out in runs["sharded"]:
        assert int(out["train_built_sharded"]) == 1


@pytest.mark.parametrize("case", ["train", "kvh", "adafactor"])
def test_sharded_gradients_match_the_unsharded_gradients(runs, case):
    """Every gradient, gathered whole, within 1e-5 of the largest
    gradient magnitude of the port's unsharded step."""
    want = runs["port"][f"{case}_grad"]
    top = max(float(np.abs(g).max()) for g in want.values())
    for out in runs["sharded"]:
        for n, g in want.items():
            np.testing.assert_allclose(out[f"{case}_grad/{n}"], g, rtol=0,
                                       atol=PORT_RTOL * top, err_msg=n)


@pytest.mark.parametrize("case", ["hybrid", "ep"])
def test_sharded_prefill_matches_both_unsharded_prefills(runs, case):
    for out in runs["sharded"]:
        _close(out[f"{case}_logits"], runs["ref"][f"{case}_logits"],
               REF_RTOL)
        _close(out[f"{case}_logits"], runs["port"][f"{case}_logits"],
               PORT_RTOL)


def test_sharded_decode_matches_both_unsharded_decodes(runs):
    for out in runs["sharded"]:
        _close(out["decode_logits"], runs["ref"]["decode_logits"], REF_RTOL)
        _close(out["decode_logits"], runs["port"]["decode_logits"],
               PORT_RTOL)


def test_sharded_serve_step_samples_the_unsharded_tokens(runs):
    """Logits sharded on the vocabulary are made whole before sampling:
    every rank samples the port's unsharded tokens with a generator seeded
    alike."""
    for out in runs["sharded"]:
        np.testing.assert_array_equal(out["decode_tokens"],
                                      runs["port"]["decode_tokens"])


@pytest.mark.parametrize("case", ["train", "kvh", "adafactor"])
def test_no_gradient_is_left_partial(runs, case):
    """The raw gradients hold partial sums; ``constrain_like_params``
    resolves every one into its parameter's placements."""
    for out in runs["sharded"]:
        assert int(out[f"{case}_raw_partial"]) == 1
        assert int(out[f"{case}_pinned_partial"]) == 0
        assert "Partial" not in str(out[f"{case}_param_placements"])


def test_fsdp_step_gathers_and_reduce_scatters(runs):
    """The FSDP step all-gathers the sharded weights and reduce-scatters
    the gradients into their shards."""
    for out in runs["sharded"]:
        seen = json.loads(str(out["train_bytes"]))
        assert seen.get("all-gather", 0) > 0, seen
        assert seen.get("reduce-scatter", 0) > 0, seen


def test_expert_parallel_prefill_moves_bytes(runs):
    for out in runs["sharded"]:
        seen = json.loads(str(out["ep_bytes"]))
        assert sum(seen.values()) > 0, seen
