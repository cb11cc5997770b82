"""Model-scored serving of the port against the JAX package, on the CPU
(mirrors ``tests/test_workload.py``'s admission tests and
``tests/test_faults.py``'s seeded ``simulate_serving``).

``AdmissionScorer`` and ``simulate_serving`` are numpy copies of the
reference's over the port's step programs: on the reference's Pallas
blocks (``kernelmodel.PALLAS_KERNELS``) and its default model (the
analytic v5e seed) their scores equal the reference's at rtol 1e-12 and
the simulated orders and latencies match exactly / at rtol 1e-12.  The
decode server's ``admission="model"`` admits in the reference's order
(the ``[admit]`` lines), with the SLO defer, the admissions counter and
the spans' ``predicted_s``.
"""
from __future__ import annotations

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.models import transformer as jtransformer
from repro.runtime import server as jserver
from repro_torch.configs.registry import ARCHS
from repro_torch.core.kernelmodel import PALLAS_KERNELS
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttransformer
from repro_torch.models.convert import params_from_reference
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace
from repro_torch.runtime import server as tsrv

torch.set_num_threads(1)

P = PALLAS_KERNELS
RTOL = 1e-12
SCORED = ["glm4-9b", "mixtral-8x7b", "zamba2-2.7b", "mamba2-370m"]


@pytest.mark.parametrize("arch", SCORED)
def test_admission_scores_equal_the_reference(arch):
    kw = dict(slots=4, max_len=2048)
    t = tsrv.AdmissionScorer(ARCHS[arch], kernels=P, **kw)
    j = jserver.AdmissionScorer(JARCHS[arch], **kw)
    lens = [16, 200, 2048]
    np.testing.assert_allclose(t.prefill_seconds(lens),
                               j.prefill_seconds(lens), rtol=RTOL)
    act, ct = np.arange(1, 5), np.arange(1, 5) * 700.0
    np.testing.assert_allclose(t.decode_step_seconds(act, ct),
                               j.decode_step_seconds(act, ct), rtol=RTOL)
    a = t.admission_scores(lens, [32, 8, 4], active=2, cache_tokens=900.0)
    b = j.admission_scores(lens, [32, 8, 4], active=2, cache_tokens=900.0)
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("noise,seed", [(0.0, 0), (0.2, 3)])
@pytest.mark.parametrize("policy", ["fifo", "model"])
@pytest.mark.parametrize("arch", ["glm4-9b", "zamba2-2.7b"])
def test_simulate_serving_equals_the_reference(arch, policy, noise, seed):
    lens = [2048, 1024] + [16] * 8
    kw = dict(slots=4, max_len=4096, policy=policy, noise=noise, seed=seed)
    got = tsrv.simulate_serving(ARCHS[arch], lens, 32, kernels=P, **kw)
    want = jserver.simulate_serving(JARCHS[arch], lens, 32, **kw)
    assert got["order"] == want["order"]
    assert got["policy"] == want["policy"]
    assert got["n_done"] == want["n_done"] == len(lens)
    for k in ("mean_latency_s", "max_latency_s", "makespan_s"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("kernels", [P, None], ids=["pallas", "cuda"])
@pytest.mark.parametrize("model", [None, "gpu-h100"])
def test_model_admission_beats_fifo_on_mixed_prompts(model, kernels):
    cfg = ARCHS["glm4-9b"]
    scorer = tsrv.AdmissionScorer(cfg, slots=4, max_len=4096, model=model,
                                  kernels=kernels)
    lens = [2048, 1024] + [16] * 8        # adversarial arrival for FIFO
    m = tsrv.simulate_serving(cfg, lens, 32, slots=4, max_len=4096,
                              policy="model", scorer=scorer)
    f = tsrv.simulate_serving(cfg, lens, 32, slots=4, max_len=4096,
                              policy="fifo", scorer=scorer)
    assert m["n_done"] == f["n_done"] == len(lens)
    assert m["mean_latency_s"] < f["mean_latency_s"]
    assert f["order"][:2] == [0, 1] and m["order"][-2:] == [1, 0]


@pytest.mark.parametrize("kernels", [P, None], ids=["pallas", "cuda"])
def test_admission_scorer_sweeps_occupancy_as_arrays(kernels):
    sc = tsrv.AdmissionScorer(ARCHS["glm4-9b"], slots=8, max_len=2048,
                              kernels=kernels)
    secs = sc.decode_step_seconds(np.arange(1, 9), np.arange(1, 9) * 512.0)
    assert secs.shape == (8,)
    assert np.all(np.diff(secs) > 0)
    pf = sc.prefill_seconds([64, 512, 2048])
    assert pf[0] < pf[1] < pf[2]


def test_simulate_serving_seeded_noise_deterministic():
    cfg = ARCHS["smollm-360m"].reduced()
    kw = dict(slots=2, policy="model")
    a = tsrv.simulate_serving(cfg, [8, 16, 4, 12], seed=3, noise=0.2, **kw)
    b = tsrv.simulate_serving(cfg, [8, 16, 4, 12], seed=3, noise=0.2, **kw)
    c = tsrv.simulate_serving(cfg, [8, 16, 4, 12], seed=4, noise=0.2, **kw)
    assert a == b
    assert a["makespan_s"] != c["makespan_s"]
    d1 = tsrv.simulate_serving(cfg, [8, 16, 4, 12], **kw)
    d2 = tsrv.simulate_serving(cfg, [8, 16, 4, 12], seed=9, **kw)
    assert d1 == d2 and d1["n_done"] == 4
    with pytest.raises(ValueError, match="policy"):
        tsrv.simulate_serving(cfg, [8], policy="lifo")


F32 = dict(param_dtype="float32", compute_dtype="float32")


@pytest.fixture(scope="module")
def glm_reduced():
    jc = dataclasses.replace(JARCHS["glm4-9b"].reduced(), **F32)
    tc = dataclasses.replace(ARCHS["glm4-9b"].reduced(), **F32)
    params, _ = jtransformer.init_params(jc, jax.random.PRNGKey(0))
    model = ttransformer.init_params(tc, device="cpu", seed=0)
    model.load_state_dict(
        params_from_reference(tc, jax.tree.map(np.asarray, params)))
    return jc, tc, params, model


def _admit_lines(out):
    return [line for line in out.splitlines() if line.startswith("[admit]")]


def test_admission_print_line_and_slo_defer(glm_reduced, capsys):
    jc, tc, params, model = glm_reduced
    srv = tsrv.DecodeServer(tc, model, slots=2, max_len=64, seed=0,
                            admission="model", device="cpu")
    rng = np.random.default_rng(0)
    for rid, plen in enumerate([12, 3]):
        srv.submit(tsrv.Request(rid=rid, prompt=rng.integers(
            2, tc.vocab_size, plen).astype(np.int32), max_new=2))
    done = srv.run()
    assert len(done) == 2
    lines = _admit_lines(capsys.readouterr().out)
    assert len(lines) == 2 and "policy=model" in lines[0]
    assert "rid=1" in lines[0] and "rid=0" in lines[1]
    # an impossible decode SLO defers admission while slots are busy
    srv2 = tsrv.DecodeServer(tc, model, slots=2, max_len=64, seed=0,
                             admission="model", slo_decode_s=0.0,
                             device="cpu")
    srv2.submit(tsrv.Request(rid=0, prompt=np.asarray([3, 4], np.int32),
                             max_new=2))
    srv2.submit(tsrv.Request(rid=1, prompt=np.asarray([5, 6], np.int32),
                             max_new=2))
    srv2._refill()
    assert srv2._n_active() == 1 and len(srv2.queue) == 1
    rendered = tmetrics.REGISTRY.render()
    assert 'repro_admission_decisions_total{outcome="slo_defer",' \
        'policy="model"}' in rendered
    assert 'repro_admission_decisions_total{outcome="admit",' \
        'policy="model"}' in rendered


def test_model_admission_order_and_lines_equal_the_reference(glm_reduced,
                                                             capsys):
    """The same queue admits in the same order with the same scores: the
    ``[admit]`` lines of the two servers are equal."""
    jc, tc, params, model = glm_reduced
    lens = [20, 3, 9, 5, 14]
    rng = np.random.default_rng(1)
    prompts = [rng.integers(2, tc.vocab_size, n).astype(np.int32)
               for n in lens]
    ts = tsrv.DecodeServer(tc, model, slots=2, max_len=128, seed=0,
                           eos_id=-1, admission="model", device="cpu")
    # the reference's numbers: its step programs on the Pallas blocks
    ts.scorer = tsrv.AdmissionScorer(tc, slots=2, max_len=128, kernels=P)
    js = jserver.DecodeServer(jc, params, slots=2, max_len=128, seed=0,
                              eos_id=-1, admission="model")
    for rid, p in enumerate(prompts):
        ts.submit(tsrv.Request(rid=rid, prompt=p, max_new=3))
        js.submit(jserver.Request(rid=rid, prompt=p, max_new=3))
    capsys.readouterr()
    ts.run()
    t_lines = _admit_lines(capsys.readouterr().out)
    js.run()
    j_lines = _admit_lines(capsys.readouterr().out)
    assert len(t_lines) == len(lens) and t_lines == j_lines


def test_spans_carry_the_scorers_predictions(glm_reduced):
    _, tc, _, model = glm_reduced
    tracer = ttrace.Tracer()
    prev = ttrace.get_tracer()
    ttrace.set_tracer(tracer)
    try:
        srv = tsrv.DecodeServer(tc, model, slots=2, max_len=64, seed=0,
                                admission="model", device="cpu")
        for rid, plen in enumerate([4, 7, 2]):
            srv.submit(tsrv.Request(rid=rid, prompt=np.arange(
                2, 2 + plen, dtype=np.int32), max_new=2))
        srv.run()
    finally:
        ttrace.set_tracer(prev)
    pre = [s for s in tracer.spans if s.name == "prefill"]
    dec = [s for s in tracer.spans if s.name == "decode_step"]
    assert len(pre) == 3 and dec
    for s in pre:
        want = float(srv.scorer.prefill_seconds([s.args["plen"]])[0])
        assert s.predicted_s == pytest.approx(want, rel=1e-12)
    assert all(s.predicted_s is not None and s.predicted_s > 0
               for s in dec)
    # FIFO without an SLO builds no scorer and predicts nothing
    assert tsrv.DecodeServer(tc, model, device="cpu").scorer is None


def test_cpu_server_scores_through_the_reference_default(glm_reduced):
    _, tc, _, model = glm_reduced
    srv = tsrv.DecodeServer(tc, model, slots=2, max_len=64,
                            admission="model", device="cpu")
    assert srv.scorer.model.device == "tpu-v5e-analytic"
    named = tsrv.DecodeServer(tc, model, slots=2, max_len=64,
                              admission="model", device="cpu",
                              cost_model="gpu-h100")
    assert named.scorer.model.device == "gpu-h100"


def test_launcher_serves_with_model_admission(tmp_path, capsys):
    mets = tmp_path / "metrics.json"
    tserve.main(["--arch", "llama3.2-3b", "--reduced", "--device", "cpu",
                 "--requests", "4", "--slots", "2", "--max-new", "2",
                 "--max-len", "96", "--admission", "model",
                 "--slo-decode-s", "10", "--metrics-json", str(mets)])
    out = capsys.readouterr().out
    assert "[serve] 4 requests" in out
    assert len(_admit_lines(out)) == 4
    counters = json.loads(mets.read_text())
    assert "repro_admission_decisions_total" in json.dumps(counters)
