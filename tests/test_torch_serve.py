"""The serving slices as a whole against the JAX package, on the CPU at
reduced size: prefill step, greedy serve-step chain, and the decode server,
for the dense family and for the ssm (mamba2-370m) and hybrid (zamba2-2.7b)
families.

Sampling differs between the frameworks (``torch.multinomial`` against
``jax.random.categorical``), so logits and greedy chains are compared, never
sampled tokens.  f32 parameters, tolerance 1e-4.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.models import transformer as jtransformer
from repro.runtime import server as jserver
from repro.runtime import steps as jsteps
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttransformer
from repro_torch.models.convert import params_from_reference
from repro_torch.obs import trace as ttrace
from repro_torch.runtime import server as tsrv
from repro_torch.runtime import steps as tsteps

torch.set_num_threads(1)

F32 = dict(param_dtype="float32", compute_dtype="float32")
TOL = dict(atol=1e-4, rtol=1e-4)


def _setup(name="smollm-360m", seed=0):
    jc = dataclasses.replace(JARCHS[name].reduced(), **F32)
    tc = dataclasses.replace(TARCHS[name].reduced(), **F32)
    params, _ = jtransformer.init_params(jc, jax.random.PRNGKey(seed))
    model = ttransformer.init_params(tc, device="cpu", seed=seed)
    model.load_state_dict(
        params_from_reference(tc, jax.tree.map(np.asarray, params)))
    return jc, tc, params, model


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


SERVED = ["llama3.2-3b", "smollm-360m", "mamba2-370m", "zamba2-2.7b"]


@pytest.mark.parametrize("name", SERVED)
def test_prefill_step_logits(name):
    jc, tc, params, model = _setup(name)
    tok = np.random.default_rng(1).integers(0, tc.vocab_size, (2, 32))
    logits = tsteps.make_prefill_step(tc)(
        model, {"tokens": torch.from_numpy(tok)})
    ref = jsteps.make_prefill_step(jc)(params, {"tokens": jnp.asarray(tok)})
    assert not logits.requires_grad
    np.testing.assert_allclose(_np(logits), _np(ref), **TOL)


@pytest.mark.parametrize("name", SERVED)
def test_greedy_serve_chain_gives_the_same_tokens(name):
    jc, tc, params, model = _setup(name)
    B, T = 2, 16
    first = np.random.default_rng(2).integers(2, tc.vocab_size, (B, 1))
    tstep = tsteps.make_serve_step(tc, sample=False)
    jstep = jax.jit(jsteps.make_serve_step(jc, sample=False))
    tstate = ttransformer.init_decode_state(tc, B, 32, device="cpu")
    jstate = jtransformer.init_decode_state(jc, B, 32)
    ttok, jtok = torch.from_numpy(first), jnp.asarray(first)
    tchain, jchain = [], []
    for _ in range(T):
        nt, tstate = tstep(model, tstate, ttok)
        nj, jstate = jstep(params, jstate, jtok, jax.random.PRNGKey(0))
        tchain.append(nt.numpy())
        jchain.append(np.asarray(nj))
        ttok, jtok = nt[:, None].long(), nj[:, None]
    assert nt.dtype == torch.int32
    np.testing.assert_array_equal(np.stack(tchain), np.stack(jchain))


def test_sampled_serve_step_is_seeded_and_in_range():
    _, tc, _, model = _setup()
    step = tsteps.make_serve_step(tc, sample=True, temperature=0.8)
    tok = torch.full((3, 1), 5)
    outs = []
    for _ in range(2):
        state = ttransformer.init_decode_state(tc, 3, 8, device="cpu")
        nxt, state = step(model, state, tok,
                          torch.Generator("cpu").manual_seed(7))
        outs.append(nxt)
    assert torch.equal(outs[0], outs[1])
    assert tuple(nxt.shape) == (3,) and state["pos"] == 1
    assert int(nxt.min()) >= 0 and int(nxt.max()) < tc.vocab_size


def _requests(cls, n=5, plen=6, max_new=5):
    rng = np.random.default_rng(0)
    return [cls(rid=rid, prompt=rng.integers(2, 200, plen).astype(np.int32),
                max_new=max_new) for rid in range(n)]


def test_server_completes_requests():
    _, tc, _, model = _setup()
    srv = tsrv.DecodeServer(tc, model, slots=2, max_len=64, seed=0,
                            device="cpu")
    for r in _requests(tsrv.Request):
        srv.submit(r)
    done = srv.run()
    assert len(done) == 5
    assert all(r.done and 1 <= len(r.out) <= 5 for r in done)
    assert all(0 <= t < tc.vocab_size for r in done for t in r.out)
    assert not srv.queue and not any(srv.active)


def test_server_first_decode_logits_match_reference_server():
    jc, tc, params, model = _setup()
    ts = tsrv.DecodeServer(tc, model, slots=2, max_len=64, seed=0,
                           device="cpu")
    js = jserver.DecodeServer(jc, params, slots=2, max_len=64, seed=0)
    for r in _requests(tsrv.Request):
        ts.submit(r)
    for r in _requests(jserver.Request):
        js.submit(r)
    seen = []
    inner = js._decode

    def recording(p, s, t):
        logits, state = inner(p, s, t)
        seen.append(logits)
        return logits, state

    js._decode = recording
    ts._refill()
    ts.step()
    js._refill()
    js.step()
    assert len(seen) == 2 * 6 + 1  # two prompts token by token, one step
    assert ts.state["pos"] == int(js.state["pos"]) == 13
    np.testing.assert_allclose(_np(ts.last_logits), _np(seen[-1]), **TOL)
    np.testing.assert_allclose(_np(ts.state["kv"].k), _np(js.state["kv"].k),
                               **TOL)


@pytest.mark.parametrize("name", ["mamba2-370m", "zamba2-2.7b"])
def test_ssm_server_first_decode_logits_and_state_match_reference_server(
        name):
    """Whole decode state after two prompts fed token by token: every token
    fed to one slot also advances the other slot's conv window and SSM
    state (one position for all slots, the reference's design)."""
    jc, tc, params, model = _setup(name)
    ts = tsrv.DecodeServer(tc, model, slots=2, max_len=64, seed=0,
                           device="cpu")
    js = jserver.DecodeServer(jc, params, slots=2, max_len=64, seed=0)
    for r in _requests(tsrv.Request):
        ts.submit(r)
    for r in _requests(jserver.Request):
        js.submit(r)
    seen = []
    inner = js._decode

    def recording(p, s, t):
        logits, state = inner(p, s, t)
        seen.append(logits)
        return logits, state

    js._decode = recording
    ts._refill()
    ts.step()
    js._refill()
    js.step()
    assert len(seen) == 2 * 6 + 1
    assert ts.state["pos"] == int(js.state["pos"]) == 13
    np.testing.assert_allclose(_np(ts.last_logits), _np(seen[-1]), **TOL)
    for key in ("conv", "h"):
        np.testing.assert_allclose(_np(getattr(ts.state["ssm"], key)),
                                   _np(getattr(js.state["ssm"], key)), **TOL)
    assert ("kv" in ts.state) == ("kv" in js.state) == (name == "zamba2-2.7b")
    if "kv" in js.state:
        np.testing.assert_allclose(_np(ts.state["kv"].k),
                                   _np(js.state["kv"].k), **TOL)
        np.testing.assert_allclose(_np(ts.state["kv"].v),
                                   _np(js.state["kv"].v), **TOL)


def test_evict_slot_requeues_at_the_front():
    _, tc, _, model = _setup()
    srv = tsrv.DecodeServer(tc, model, slots=2, max_len=64, device="cpu")
    reqs = _requests(tsrv.Request, n=4)
    for r in reqs:
        srv.submit(r)
    srv._refill()
    srv.step()
    assert srv.active[1] is reqs[1] and len(reqs[1].out) == 1
    back = srv.evict_slot(1)
    assert back is reqs[1] and back.evictions == 1
    assert srv.queue[0] is reqs[1] and srv.active[1] is None
    assert srv.evict_slot(1) is None
    srv._refill()  # re-admitted first, owes only the missing tokens
    assert srv.active[1] is reqs[1]
    assert srv.remaining[1] == reqs[1].max_new - 1
    done = srv.run()
    assert {r.rid for r in done} == {0, 1, 2, 3}


def test_position_beyond_the_cache_raises():
    _, tc, _, model = _setup()
    srv = tsrv.DecodeServer(tc, model, slots=1, max_len=8, eos_id=-1,
                            device="cpu")
    srv.submit(tsrv.Request(rid=0, prompt=np.arange(2, 8, dtype=np.int32),
                            max_new=8))
    with pytest.raises(ValueError, match="cache is full"):
        srv.run()
    assert srv.state["pos"] == 8


@pytest.mark.parametrize("kw", [
    dict(admission="model"), dict(slo_decode_s=0.1),
    dict(calibrator=True), dict(injector=True)])
def test_unported_server_options_raise(kw):
    """Every option of the reference's server is ported now: model
    admission and the decode SLO build the scorer, a calibrator gets the
    live decode property vector, an injector is kept for the step's
    timing hook; none raises."""
    from repro_torch.calibration.online import OnlineCalibrator
    from repro_torch.runtime.faults import FaultInjector, FaultPlan
    _, tc, _, model = _setup()
    if "calibrator" in kw:
        cal = OnlineCalibrator(None, device="decode-dev")
        srv = tsrv.DecodeServer(tc, model, device="cpu", calibrator=cal)
        assert srv.calibrator is cal and srv._decode_pv
        assert srv.scorer is None
        return
    if "injector" in kw:
        inj = FaultInjector(FaultPlan())
        srv = tsrv.DecodeServer(tc, model, device="cpu", injector=inj)
        assert srv.injector is inj and srv.calibrator is None
        return
    srv = tsrv.DecodeServer(tc, model, device="cpu", **kw)
    assert isinstance(srv.scorer, tsrv.AdmissionScorer)


def test_server_refuses_a_model_on_another_device():
    _, tc, _, model = _setup()
    with pytest.raises(ValueError):
        tsrv.DecodeServer(tc, model, admission="lifo", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises((ValueError, RuntimeError, AssertionError)):
            tsrv.DecodeServer(tc, model)  # device defaults to "cuda"


def test_server_spans_and_metrics():
    _, tc, _, model = _setup()
    from repro_torch.obs import metrics
    hist = metrics.REGISTRY.histogram("repro_decode_step_seconds")
    tracer = ttrace.Tracer()
    prev = ttrace.get_tracer()
    ttrace.set_tracer(tracer)
    try:
        srv = tsrv.DecodeServer(tc, model, slots=2, max_len=64, device="cpu")
        for r in _requests(tsrv.Request, n=3, max_new=2):
            srv.submit(r)
        srv.run()
    finally:
        ttrace.set_tracer(prev)
    names = [s.name for s in tracer.spans]
    assert names.count("prefill") == 3
    assert names.count("decode_step") == srv._iters >= 2
    rendered = metrics.REGISTRY.render()
    assert "repro_decode_step_seconds" in rendered
    assert 'repro_admission_decisions_total{outcome="admit",policy="fifo"}' \
        in rendered
    assert hist is metrics.REGISTRY.histogram("repro_decode_step_seconds")


def test_launcher_runs_reduced_on_cpu(tmp_path, capsys):
    trace, mets = tmp_path / "trace.json", tmp_path / "metrics.json"
    prev = ttrace.get_tracer()
    try:
        tserve.main(["--arch", "llama3.2-3b", "--reduced", "--device", "cpu",
                     "--requests", "3", "--slots", "2", "--max-new", "3",
                     "--max-len", "64", "--trace-json", str(trace),
                     "--metrics-json", str(mets)])
    finally:
        ttrace.set_tracer(prev)
    out = capsys.readouterr().out
    assert "[serve] 3 requests" in out and "device=cpu" in out
    assert trace.exists() and mets.exists()


def test_launcher_runs_the_hybrid_reduced_on_cpu(capsys):
    tserve.main(["--arch", "zamba2-2.7b", "--reduced", "--device", "cpu",
                 "--requests", "3", "--slots", "2", "--max-new", "3",
                 "--max-len", "64"])
    out = capsys.readouterr().out
    assert "[serve] 3 requests" in out and "device=cpu" in out
