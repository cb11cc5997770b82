"""The port's basis-term attribution (``obs/explain.py``) against the JAX
package, on the CPU (mirrors ``tests/test_obs.py``'s attribution tests).

``obs/explain.py`` is a numpy copy of the reference's, so the port is held
to the reference's own numbers on the same inputs: ``score_explain`` of
every registry arch equals the reference's decomposition (total, rows,
groups) at rtol 1e-9 on the reference's Pallas blocks
(``kernelmodel.PALLAS_KERNELS``), and equals the fused ``PlanSpace.scores``
cell at rtol 1e-9 on both registries (the card's CUDA tiles too).  The
residual projections equal the reference's at rtol 1e-9 and recover an
injected single-term error.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.registry import ARCHS as JARCHS
from repro.core import predictor as jpredictor
from repro.core import workload as jwl
from repro.distributed.plan import plan_for as jplan_for
from repro.obs import explain as jexplain
from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.configs.registry import ARCHS
from repro_torch.core import planspace, predictor
from repro_torch.core import properties as props
from repro_torch.core import workload as wl
from repro_torch.core.kernelmodel import PALLAS_KERNELS
from repro_torch.core.workload import WorkloadSpec
from repro_torch.distributed.plan import plan_for
from repro_torch.obs import explain
from repro_torch.obs.explain import (attribute_residual,
                                     attribute_residual_pv, explain_program,
                                     score_explain)

torch.set_num_threads(1)

P = PALLAS_KERNELS
RTOL = 1e-9
MESH = {"data": 16, "model": 16}


def _cell(arch, shape="train_4k"):
    cfg = ARCHS[arch]
    ok, why = shape_applicable(cfg, SHAPES[shape])
    if not ok:
        pytest.skip(why)
    spec = wl.from_shape(SHAPES[shape])
    return cfg, spec, plan_for(cfg, SHAPES[shape])


@pytest.mark.parametrize("kernels", [P, None], ids=["pallas", "cuda"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_score_explain_matches_fused_scores(arch, kernels):
    cfg, spec, plan = _cell(arch)
    model = predictor.resolve_model(None)
    space = planspace.PlanSpace.from_product(cfg, spec, [plan], [MESH],
                                             kernels=kernels)
    fused = float(space.scores(model)[0])
    exp = score_explain(cfg, spec, plan, MESH, model=model, kernels=kernels)
    assert exp.total_seconds == pytest.approx(fused, rel=RTOL)
    assert sum(r.seconds for r in exp.rows) == pytest.approx(
        exp.total_seconds, rel=1e-12)
    assert sum(r.share for r in exp.rows) == pytest.approx(1.0, rel=RTOL)
    assert sum(exp.by_group().values()) == pytest.approx(fused, rel=RTOL)
    assert sum(exp.by_source().values()) == pytest.approx(fused, rel=RTOL)
    assert sum(exp.by_property().values()) == pytest.approx(fused, rel=RTOL)
    assert set(exp.by_group()) <= set(props.CATEGORIES)
    assert set(exp.by_source()) <= {"step", "collective", "launch"}
    assert exp.report()


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_score_explain_equals_the_reference(arch, shape):
    cfg, spec, plan = _cell(arch, shape)
    jcfg = JARCHS[arch]
    jplan = jplan_for(jcfg, JSHAPES[shape])
    got = score_explain(cfg, spec, plan, MESH, kernels=P)
    want = jexplain.score_explain(jcfg, jwl.from_shape(JSHAPES[shape]),
                                  jplan, MESH)
    np.testing.assert_allclose(got.total_seconds, want.total_seconds,
                               rtol=RTOL)
    assert got.phase == want.phase
    assert [(r.term, r.group, r.source, r.properties) for r in got.rows] \
        == [(r.term, r.group, r.source, r.properties) for r in want.rows]
    np.testing.assert_allclose([r.seconds for r in got.rows],
                               [r.seconds for r in want.rows], rtol=RTOL)
    for k, v in want.by_group().items():
        np.testing.assert_allclose(got.by_group()[k], v, rtol=RTOL)
    assert sorted(got.by_property()) == sorted(want.by_property())
    assert {k: v for k, v in got.meta.items() if k != "property_seconds"} \
        == {k: v for k, v in want.meta.items() if k != "property_seconds"}


def test_score_explain_entry_points_agree():
    cfg, spec, plan = _cell("glm4-9b")
    via_predictor = predictor.score_explain(cfg, SHAPES["train_4k"], plan,
                                            MESH)
    direct = score_explain(cfg, spec, plan, MESH)
    assert via_predictor.total_seconds == pytest.approx(
        direct.total_seconds, rel=1e-12)
    dspec = wl.from_shape(SHAPES["decode_32k"])
    dplan = plan_for(cfg, SHAPES["decode_32k"])
    dspace = planspace.PlanSpace.from_product(cfg, dspec, [dplan], [MESH])
    dexp = score_explain(cfg, dspec, dplan, MESH)
    assert dexp.total_seconds == pytest.approx(float(dspace.scores()[0]),
                                               rel=RTOL)
    assert dexp.phase == "decode"


def test_lazy_exports_of_the_obs_package():
    import repro_torch.obs as obs
    assert obs.explain is explain
    assert obs.score_explain is score_explain
    with pytest.raises(AttributeError):
        obs.no_such_name


@pytest.mark.parametrize("kernels", [P, None], ids=["pallas", "cuda"])
def test_basis_program_explain_method(kernels):
    cfg, spec, _ = _cell("smollm-360m")
    model = predictor.resolve_model(None)
    prog = predictor.step_program(cfg, spec, "none", kernels=kernels)
    env = spec.env(cfg)
    env["M"] = 1
    rows = prog.explain(env, model)
    assert rows == explain_program(prog, env, model)
    total = sum(sec for _, sec, _, _ in rows)
    assert total == pytest.approx(float(prog.score(env, model)), rel=RTOL)


def test_explain_program_equals_the_reference():
    cfg, spec, _ = _cell("smollm-360m")
    jspec = jwl.from_shape(JSHAPES["train_4k"])
    prog = predictor.step_program(cfg, spec, "none", kernels=P)
    jprog = jpredictor.step_program(JARCHS["smollm-360m"], jspec, "none")
    env = {**spec.env(cfg), "M": 1}
    got = explain_program(prog, env, predictor.resolve_model(None))
    want = jexplain.explain_program(jprog, env,
                                    jpredictor.resolve_model(None))
    assert [(t, g, k) for t, _, g, k in got] == \
        [(t, g, k) for t, _, g, k in want]
    np.testing.assert_allclose([s for _, s, _, _ in got],
                               [s for _, s, _, _ in want], rtol=RTOL)


def _varied_envs(cfg, n=16):
    # batch/seq values off the ceil granularities, so that the basis
    # columns of the window are not collinear (the reference's window)
    batches = (3, 5, 7, 9)
    seqs = (260, 388, 516, 644, 772, 900)
    envs = []
    for i in range(n):
        spec = WorkloadSpec(phase="train", global_batch=batches[i % 4],
                            seq_len=seqs[i % 6])
        envs.append({**spec.env(cfg), "M": 1})
    return envs


def _program(kernels):
    return predictor.step_program(ARCHS["smollm-360m"],
                                  wl.from_shape(SHAPES["train_4k"]), "none",
                                  kernels=kernels)


def test_attribute_residual_recovers_injected_term_error():
    cfg = ARCHS["smollm-360m"]
    model = predictor.resolve_model(None)
    prog = _program(P)
    envs = _varied_envs(cfg)
    per_env = [dict(((t, s) for t, s, _, _ in explain_program(
        prog, e, model))) for e in envs]
    terms = [t for t in per_env[0] if t != "1"]
    B = np.asarray([[d[t] for t in terms] for d in per_env])

    def unexplained(j):
        y = B[:, j]
        X = np.delete(B, j, axis=1)
        coef = np.linalg.lstsq(X, y, rcond=None)[0]
        return float(((y - X @ coef) ** 2).sum())

    j_target = max(range(len(terms)), key=unexplained)
    target = terms[j_target]
    assert unexplained(j_target) > 0
    eps_true = 0.2
    measured = [sum(d.values()) + eps_true * d[target] for d in per_env]
    att = attribute_residual(prog, model, envs, measured)
    assert att.n_samples == len(envs)
    assert att.shares()[target] > 0.9, att.shares()
    i = att.columns.index(target)
    assert att.epsilon[i] == pytest.approx(eps_true, abs=0.02)
    assert float(np.sum(att.miss_seconds)) == pytest.approx(
        att.residual_s, rel=1e-2)
    assert att.line().startswith("residual=")
    # the same window through the reference's program and projection
    jprog = jpredictor.step_program(
        JARCHS["smollm-360m"], jwl.from_shape(JSHAPES["train_4k"]), "none")
    jatt = jexplain.attribute_residual(
        jprog, jpredictor.resolve_model(None), envs, measured)
    assert att.columns == jatt.columns and att.groups == jatt.groups
    np.testing.assert_allclose(att.epsilon, jatt.epsilon, rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(att.residual_s, jatt.residual_s, rtol=RTOL)


def test_attribute_residual_pv_equals_the_reference():
    rng = np.random.default_rng(3)
    model = predictor.resolve_model(None)
    priced = [k for k, w in zip(model.keys, model.weights) if w][:4]
    assert len(priced) >= 2
    pvs = [{k: float(rng.uniform(1e6, 1e9)) for k in priced}
           for _ in range(16)]
    target = priced[0]
    w = dict(zip(model.keys, model.weights))
    measured = [model.predict(pv) + 0.3 * w[target] * pv[target]
                for pv in pvs]
    att = attribute_residual_pv(model, pvs, measured)
    assert att.shares()[target] > 0.9
    i = att.columns.index(target)
    assert att.epsilon[i] == pytest.approx(0.3, rel=1e-2)
    assert att.group_shares()[props.category(target)] > 0.9
    jatt = jexplain.attribute_residual_pv(jpredictor.resolve_model(None),
                                          pvs, measured)
    assert att.columns == jatt.columns
    np.testing.assert_allclose(att.epsilon, jatt.epsilon, rtol=RTOL)
    np.testing.assert_allclose(att.miss_seconds, jatt.miss_seconds,
                               rtol=RTOL)
    assert att.line() == jatt.line()


def test_attribute_residual_zero_residual_attributes_nothing():
    cfg = ARCHS["smollm-360m"]
    model = predictor.resolve_model(None)
    prog = _program(None)
    envs = _varied_envs(cfg, n=6)
    measured = [sum(s for _, s, _, _ in explain_program(prog, e, model))
                for e in envs]
    att = attribute_residual(prog, model, envs, measured)
    assert att.residual_s == pytest.approx(0.0, abs=1e-12)
