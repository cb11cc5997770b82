"""The port's workload specs, step predictor and ``make_step`` against the
JAX package, on the CPU (mirrors ``tests/test_workload.py``).

``core/workload.py``, ``archcount.py``, ``predictor.py``, ``planspace.py``
and ``distributed/elastic.py`` are numpy copies of the reference's, so the
step predictions are held to the reference's golden pins
(``tests/golden/workload_train.json``) at rtol 1e-12, and every other
prediction to the reference's own output at rtol 1e-12 (the step
programs on the reference's Pallas blocks, ``P``; the card's composition
has tests of its own at the end).  The candidate plans come from the
port's ``launch/autoshard.candidate_plans``, which
``tests/test_torch_planspace.py`` holds equal to the reference's.
``make_step`` is torch: its prefill output equals ``make_prefill_step``'s
bit for bit.
"""
from __future__ import annotations

import dataclasses
import json
import os
import warnings

import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.registry import ARCHS as JARCHS
from repro.core import predictor as jpredictor
from repro.core import workload as jwl
from repro.distributed import elastic as jelastic
from repro.distributed.plan import plan_for as jplan_for
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.core import archcount, planspace, predictor
from repro_torch.core.kernelmodel import PALLAS_KERNELS
from repro_torch.launch.autoshard import candidate_plans
from repro_torch.core import properties as props
from repro_torch.core import workload as wl
from repro_torch.core.workload import WorkloadSpec
from repro_torch.distributed import elastic
from repro_torch.distributed.plan import Plan, plan_for
from repro_torch.models import transformer
from repro_torch.optim import optimizers as opt
from repro_torch.runtime import steps

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "workload_train.json")
MESH = {"data": 16, "model": 16}
ALL_ARCHS = sorted(ARCHS)
RTOL = 1e-12
#: the reference's registry: the step programs held to the reference's
#: compose its Pallas blocks (the card's are the default)
P = PALLAS_KERNELS

with open(GOLDEN) as _f:
    GOLD = json.load(_f)


def port_plan(p) -> Plan:
    """A reference ``Plan`` carried field by field into the port's."""
    return Plan(**{f.name: getattr(p, f.name)
                   for f in dataclasses.fields(p)})


def port_plans(cfg_name: str, shape: str = "train_4k"):
    return candidate_plans(ARCHS[cfg_name], SHAPES[shape])


# ---------------------------------------------------------------------------
# spec basics
# ---------------------------------------------------------------------------


def test_spec_phase_validation_and_kind_alias():
    s = WorkloadSpec(phase="decode", global_batch=8, seq_len=512)
    assert s.kind == "decode" and s.tokens == 8 * 512
    with pytest.raises(ValueError, match="unknown phase"):
        WorkloadSpec(phase="serve")
    with pytest.raises(TypeError):
        wl.as_spec(42)


def test_structure_flags_only_when_refined():
    assert WorkloadSpec(phase="decode").structure() == ("decode",)
    assert WorkloadSpec(phase="train", spec_len=3).structure() == ("train",)
    s = WorkloadSpec(phase="decode", cache_tokens=0.0, active_slots=0,
                     spec_len=2, moe_imbalance=1.5)
    assert s.structure() == ("decode", "ct", "as", "sl", "mi")
    assert predictor._structure_key(wl.TRAIN_4K) == "train"
    assert predictor._structure_key(s) == ("decode", "ct", "as", "sl", "mi")


def test_env_defaults_fill_neutral_values():
    cfg = ARCHS["glm4-9b"]
    s = WorkloadSpec(phase="decode", global_batch=4, seq_len=1024)
    e = s.env(cfg)
    ctx = min(1024, cfg.sliding_window) if cfg.sliding_window else 1024
    assert e["AS"] == 4 and e["CT"] == 4 * ctx
    assert e["SL"] == 1 and e["MI"] == 1.0
    assert WorkloadSpec(phase="train", global_batch=2).env() == \
        {"B": 2, "S": 1, "M": 1}


SPEC_CASES = [dict(phase="train", global_batch=256, seq_len=4096),
              dict(phase="prefill", global_batch=4, seq_len=2048),
              dict(phase="decode", global_batch=8, seq_len=2048),
              dict(phase="decode", global_batch=8, seq_len=2048,
                   active_slots=5, cache_tokens=16384.0),
              dict(phase="decode", global_batch=16, seq_len=32768,
                   spec_len=3, moe_imbalance=1.7)]


@pytest.mark.parametrize("kw", SPEC_CASES,
                         ids=["train", "prefill", "decode", "decode-as-ct",
                              "decode-sl-mi"])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "zamba2-2.7b"])
def test_spec_structure_and_env_equal_the_reference(kw, arch):
    t, j = WorkloadSpec(**kw), jwl.WorkloadSpec(**kw)
    assert t.structure() == j.structure()
    assert t.env(ARCHS[arch]) == j.env(JARCHS[arch])
    assert t.env() == j.env()


def test_canonical_specs_equal_the_reference():
    assert sorted(wl.SPECS) == sorted(jwl.SPECS)
    for name, spec in wl.SPECS.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(jwl.SPECS[name])


def test_as_spec_shapeconfig_is_silent_string_warns():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        s = wl.as_spec(SHAPES["prefill_32k"])
    assert s.phase == "prefill" and s.name == "prefill_32k"
    with pytest.warns(DeprecationWarning, match="kind='decode' strings"):
        assert wl.as_spec("decode").phase == "decode"
    assert isinstance(SHAPES["train_4k"], ShapeConfig)


# ---------------------------------------------------------------------------
# golden pins: the reference's train predictions, at rtol 1e-12
# ---------------------------------------------------------------------------


def test_golden_covers_every_registry_arch():
    assert sorted(GOLD) == ALL_ARCHS


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_golden_predict_step(arch):
    g, cfg = GOLD[arch], ARCHS[arch]
    plan = plan_for(cfg, wl.TRAIN_4K)
    pred = predictor.predict_step(cfg, wl.TRAIN_4K, plan, MESH, kernels=P)
    np.testing.assert_allclose(pred.seconds, g["predict_step_seconds"],
                               rtol=RTOL)
    assert set(pred.terms) == set(g["predict_step_terms"])
    for k, v in g["predict_step_terms"].items():
        np.testing.assert_allclose(pred.terms[k], v, rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_golden_predict_plans(arch):
    g, cfg = GOLD[arch], ARCHS[arch]
    plans = port_plans(arch)[:24]
    assert len(plans) == g["n_plans"]
    secs = predictor.predict_plans(cfg, wl.TRAIN_4K, plans, MESH, kernels=P)
    np.testing.assert_allclose(secs, g["predict_plans"], rtol=RTOL)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_golden_planspace_scores(arch):
    g, cfg = GOLD[arch], ARCHS[arch]
    plans = port_plans(arch)[:8]
    space = planspace.PlanSpace.from_product(
        cfg, wl.TRAIN_4K, plans, planspace.mesh_factorizations(64), kernels=P)
    np.testing.assert_allclose(space.scores(None),
                               g["planspace_scores_64dev"], rtol=RTOL)


# ---------------------------------------------------------------------------
# every phase against the reference (the goldens pin train only)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_predict_step_every_phase_equals_the_reference(arch, shape):
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    jplan = jplan_for(jcfg, JSHAPES[shape])
    mesh = {"data": 8, "model": 4}
    got = predictor.predict_step(cfg, SHAPES[shape], port_plan(jplan), mesh,
                                 kernels=P)
    want = jpredictor.predict_step(jcfg, JSHAPES[shape], jplan, mesh)
    np.testing.assert_allclose(got.seconds, want.seconds, rtol=RTOL)
    np.testing.assert_allclose(got.model_flops, want.model_flops, rtol=RTOL)
    # the v5e seed is the reference's model: MFU keeps its peak there
    np.testing.assert_allclose(got.mfu, want.mfu, rtol=RTOL)
    for k, v in want.terms.items():
        np.testing.assert_allclose(got.terms[k], v, rtol=RTOL, err_msg=k)
    assert set(got.breakdown) == set(want.breakdown)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "zamba2-2.7b",
                                  "mixtral-8x7b"])
def test_refined_decode_spec_equals_the_reference(arch):
    """The server's decode as ``chip_smoke.py`` prices it: 8 slots of 2048
    rows, fewer occupied, the whole cache read."""
    kw = dict(phase="decode", global_batch=8, seq_len=2048, active_slots=5,
              cache_tokens=8 * 2048.0)
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    jplan = jplan_for(jcfg, JSHAPES["decode_32k"]).with_(dp_axes=())
    got = predictor.predict_step(cfg, WorkloadSpec(**kw), port_plan(jplan),
                                 {"data": 1}, kernels=P)
    want = jpredictor.predict_step(jcfg, jwl.WorkloadSpec(**kw), jplan,
                                   {"data": 1})
    np.testing.assert_allclose(got.seconds, want.seconds, rtol=RTOL)


def test_mfu_divides_by_the_models_device_peak():
    """A ``gpu-h100`` model's MFU divides by its datasheet's 989e12; the
    v5e seed keeps the reference's 197e12."""
    from repro_torch.calibration import seeds
    cfg = ARCHS["llama3.2-3b"]
    spec = WorkloadSpec(phase="prefill", global_batch=4, seq_len=2048)
    plan, mesh = Plan(dp_axes=()), {"data": 1}
    h100 = seeds.ANALYTIC_SEEDS["gpu-h100"]()
    p = predictor.predict_step(cfg, spec, plan, mesh, h100, kernels=P)
    assert predictor.peak_flops_bf16(h100) == 989e12
    np.testing.assert_allclose(p.mfu, p.model_flops / (989e12 * p.seconds),
                               rtol=RTOL)
    fitted = dataclasses.replace(h100, meta={"source": "calibrated"})
    assert predictor.peak_flops_bf16(fitted) == 989e12
    v5e = predictor.predict_step(cfg, spec, plan, mesh, kernels=P)
    assert predictor.peak_flops_bf16(predictor.resolve_model(None)) == \
        predictor.PEAK_FLOPS_BF16 == jpredictor.PEAK_FLOPS_BF16
    np.testing.assert_allclose(
        v5e.mfu, v5e.model_flops / (197e12 * v5e.seconds), rtol=RTOL)


def test_spec_equals_shape_and_legacy_string_all_phases():
    cfg = ARCHS["glm4-9b"]
    for shape_name in ("train_4k", "prefill_32k", "decode_32k"):
        shape = SHAPES[shape_name]
        plan = plan_for(cfg, shape)
        via_shape = predictor.predict_step(cfg, shape, plan, MESH,
                                           kernels=P).seconds
        via_spec = predictor.predict_step(cfg, wl.from_shape(shape), plan,
                                          MESH, kernels=P).seconds
        assert via_spec == via_shape
        env = {"B": shape.global_batch, "S": shape.seq_len, "M": 1}
        spec_cv = predictor.step_vector_fn(cfg, wl.from_shape(shape),
                                           kernels=P)
        with pytest.warns(DeprecationWarning):
            str_cv = predictor.step_vector_fn(cfg, shape.kind, kernels=P)
        a, b = spec_cv(env), str_cv(env)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=0,
                                       err_msg=f"{shape_name}:{k}")


def test_feasible_keeps_the_reference_default_and_takes_a_budget():
    cfg, jcfg = ARCHS["llama3.2-3b"], JARCHS["llama3.2-3b"]
    jplan = jplan_for(jcfg, JSHAPES["train_4k"])
    plan = port_plan(jplan)
    got = predictor.estimate_peak_bytes(cfg, wl.TRAIN_4K, plan, MESH)
    want = jpredictor.estimate_peak_bytes(jcfg, jwl.TRAIN_4K, jplan, MESH)
    assert got == want
    assert predictor.HBM_BYTES == jpredictor.HBM_BYTES
    assert predictor.feasible(cfg, wl.TRAIN_4K, plan, MESH) == \
        jpredictor.feasible(jcfg, jwl.TRAIN_4K, jplan, MESH)
    one = {"data": 1}
    peak = predictor.estimate_peak_bytes(cfg, wl.TRAIN_4K, plan, one)
    assert predictor.feasible(cfg, wl.TRAIN_4K, plan, one, budget=peak)
    assert not predictor.feasible(cfg, wl.TRAIN_4K, plan, one,
                                  budget=peak * 0.5)


def test_score_explain_waits_for_obs_explain():
    """``predictor.score_explain`` delegates to ``obs.explain`` (ported),
    and equals the reference's decomposition on the reference's blocks."""
    from repro.core import predictor as jpred
    cfg = ARCHS["smollm-360m"]
    got = predictor.score_explain(cfg, wl.TRAIN_4K,
                                  plan_for(cfg, wl.TRAIN_4K), MESH,
                                  kernels=P)
    jcfg = JARCHS["smollm-360m"]
    want = jpred.score_explain(jcfg, jwl.TRAIN_4K,
                               jplan_for(jcfg, jwl.TRAIN_4K), MESH)
    np.testing.assert_allclose(got.total_seconds, want.total_seconds,
                               rtol=1e-9)


# ---------------------------------------------------------------------------
# decode / prefill physics
# ---------------------------------------------------------------------------


def _mxu_key(cfg):
    return props.mxu_key(16 if "16" in cfg.compute_dtype else 32)


def test_decode_compute_counts_tokens_not_sequence():
    cfg = ARCHS["llama3.2-3b"]
    spec = WorkloadSpec(phase="decode", global_batch=8, seq_len=1024,
                        cache_tokens=8 * 1024.0)
    cv = predictor.step_vector_fn(cfg, spec, kernels=P)
    k = _mxu_key(cfg)
    base = {"B": 8, "M": 1, "CT": 8 * 1024.0}
    a = float(cv({**base, "S": 1024})[k])
    b = float(cv({**base, "S": 65536})[k])
    assert a == b > 0


def test_decode_cache_read_bytes_linear_in_context():
    cfg = ARCHS["llama3.2-3b"]
    spec = WorkloadSpec(phase="decode", global_batch=8, seq_len=4096,
                        cache_tokens=1.0)
    cv = predictor.step_vector_fn(cfg, spec, kernels=P)
    lk = props.mem_key("load", 16, "s1")
    env = {"B": 8, "S": 4096, "M": 1}
    l1 = float(cv({**env, "CT": 8 * 1024.0})[lk])
    l2 = float(cv({**env, "CT": 16 * 1024.0})[lk])
    l3 = float(cv({**env, "CT": 24 * 1024.0})[lk])
    assert l2 - l1 == pytest.approx(l3 - l2, rel=1e-12)
    assert l2 > l1


def test_decode_speculative_length_multiplies_compute():
    cfg = ARCHS["llama3.2-3b"]
    base = WorkloadSpec(phase="decode", global_batch=8, seq_len=1024,
                        cache_tokens=8 * 1024.0)
    spec = base.with_(spec_len=2)
    k = _mxu_key(cfg)
    env = {"B": 8, "S": 1024, "M": 1, "CT": 8 * 1024.0}
    m1 = float(predictor.step_vector_fn(cfg, base, kernels=P)(env)[k])
    m2 = float(predictor.step_vector_fn(cfg, spec, kernels=P)({**env,
                                                               "SL": 2})[k])
    assert m2 == pytest.approx(2 * m1, rel=1e-12)


def test_decode_default_spec_matches_neutral_refinements():
    cfg = ARCHS["glm4-9b"]
    spec0 = wl.from_shape(SHAPES["decode_32k"])
    spec1 = spec0.with_(active_slots=0, cache_tokens=0.0, spec_len=2,
                        moe_imbalance=2.0)
    env = spec0.env(cfg)
    env["M"] = 1
    a = predictor.step_vector_fn(cfg, spec0, kernels=P)(env)
    b = predictor.step_vector_fn(cfg, spec1, kernels=P)({**env, "SL": 1,
                                                         "MI": 1.0})
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=1e-9,
                                   err_msg=k)


def test_prefill_writes_kv_cache():
    from repro_torch.core.symcount import as_expr
    cfg = ARCHS["llama3.2-3b"]
    env = {"B": 4, "S": 2048, "M": 1}
    sk = props.mem_key("store", 16, "s1")
    pf = as_expr(archcount.prefill_counts(cfg).pv[sk]).eval(env)
    fwd = as_expr(archcount.forward_counts(cfg)[sk]).eval(env)
    kv_rows = 4 * 2048 * 2 * cfg.n_kv_heads * cfg.head_dim_ * cfg.n_layers
    assert pf - fwd == pytest.approx(kv_rows, rel=1e-12)


def test_moe_imbalance_scales_decode_expert_compute_only():
    cfg = ARCHS["mixtral-8x7b"]
    base = WorkloadSpec(phase="decode", global_batch=8, seq_len=1024)
    hot = base.with_(moe_imbalance=2.0)
    k = _mxu_key(cfg)
    env = base.env(cfg)
    env["M"] = 1
    m1 = float(predictor.step_vector_fn(cfg, base, kernels=P)(env)[k])
    m2 = float(predictor.step_vector_fn(cfg, hot, kernels=P)({**env,
                                                              "MI": 2.0})[k])
    assert m1 < m2 < 2 * m1
    assert WorkloadSpec(phase="train", moe_imbalance=2.0).structure() == \
        ("train",)


def test_moe_group_tokens_come_from_the_ports_moe():
    from repro.models import moe as jmoe
    from repro_torch.models import moe
    assert moe.GROUP_TOKENS == jmoe.GROUP_TOKENS
    cfg = ARCHS["mixtral-8x7b"]
    env = {"B": 4, "S": 4096, "M": 1}
    got = archcount._moe_dispatch_macs(cfg)
    from repro.core import archcount as jarchcount
    want = jarchcount._moe_dispatch_macs(JARCHS["mixtral-8x7b"])
    from repro_torch.core.symcount import as_expr
    from repro.core.symcount import as_expr as jas_expr
    assert float(as_expr(got).eval(env)) == float(jas_expr(want).eval(env))


# ---------------------------------------------------------------------------
# make_step
# ---------------------------------------------------------------------------


def test_make_step_dispatches_on_phase():
    cfg = ARCHS["llama3.2-3b"].reduced()
    assert steps.make_step(cfg, wl.TRAIN_4K).__name__ == "train_step"
    assert steps.make_step(cfg, wl.PREFILL_32K).__name__ == "prefill_step"
    assert steps.make_step(cfg, wl.DECODE_32K).__name__ == "serve_step"
    with pytest.warns(DeprecationWarning):
        assert steps.make_step(cfg, "decode").__name__ == "serve_step"
    assert steps.make_step(cfg, SHAPES["train_4k"]).__name__ == "train_step"


def _tokens(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))


def test_make_step_prefill_equals_make_prefill_step():
    cfg = ARCHS["llama3.2-3b"].reduced()
    model = transformer.init_params(cfg, device="cpu", seed=0)
    batch = {"tokens": _tokens(cfg, 2, 32)}
    spec = WorkloadSpec(phase="prefill", global_batch=2, seq_len=32)
    got = steps.make_step(cfg, spec)(model, batch)
    want = steps.make_prefill_step(cfg)(model, batch)
    assert torch.equal(got, want)
    assert got.shape == (2, 32, cfg.vocab_size)


def test_make_step_serve_equals_make_serve_step():
    cfg = ARCHS["llama3.2-3b"].reduced()
    model = transformer.init_params(cfg, device="cpu", seed=0)
    tok = _tokens(cfg, 2, 1, seed=1)
    spec = WorkloadSpec(phase="decode", global_batch=2, seq_len=16)
    outs = []
    for step in (steps.make_step(cfg, spec, sample=False),
                 steps.make_serve_step(cfg, sample=False)):
        state = transformer.init_decode_state(cfg, 2, 16, device="cpu")
        nxt, _ = step(model, state, tok)
        outs.append(nxt)
    assert torch.equal(outs[0], outs[1])


def test_make_step_train_takes_the_configs_optimizer():
    cfg = dataclasses.replace(ARCHS["llama3.2-3b"].reduced(),
                              param_dtype="float32", compute_dtype="float32")
    spec = WorkloadSpec(phase="train", global_batch=2, seq_len=16)
    batch = {"tokens": _tokens(cfg, 2, 16, seed=2),
             "labels": _tokens(cfg, 2, 16, seed=3),
             "loss_mask": torch.ones(2, 16)}
    losses = []
    for build in (lambda o: steps.make_step(cfg, spec),
                  lambda o: steps.make_train_step(cfg, o)):
        o = opt.get_optimizer(cfg.optimizer)
        gen = torch.Generator("cpu").manual_seed(0)
        state = steps.init_train_state(cfg, gen, o, device="cpu")
        _, metrics = build(o)(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[0] == losses[1] and np.isfinite(losses[0])


# ---------------------------------------------------------------------------
# elastic re-planning against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape,n", [("glm4-9b", "train_4k", 16),
                                          ("smollm-360m", "train_4k", 64),
                                          ("mixtral-8x7b", "prefill_32k", 32),
                                          ("zamba2-2.7b", "decode_32k", 8)])
def test_elastic_replan_equals_the_reference(arch, shape, n):
    a = elastic.replan(ARCHS[arch], SHAPES[shape], n, kernels=P)
    b = jelastic.replan(JARCHS[arch], JSHAPES[shape], n)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.shape == y.shape and x.device == y.device
        assert dataclasses.asdict(x.plan) == dataclasses.asdict(y.plan)
        np.testing.assert_allclose(x.predicted_step_s, y.predicted_step_s,
                                   rtol=RTOL)


def test_elastic_replan_accepts_spec():
    cfg = ARCHS["glm4-9b"]
    a = elastic.replan(cfg, SHAPES["train_4k"], 16, kernels=P)
    b = elastic.replan(cfg, wl.TRAIN_4K, 16, kernels=P)
    assert [o.predicted_step_s for o in a] == \
        [o.predicted_step_s for o in b]
    assert a and a[0].shape == b[0].shape


def test_elastic_on_failure_equals_the_reference():
    a = elastic.on_failure(ARCHS["smollm-360m"], SHAPES["train_4k"], 256,
                           lost=3, kernels=P)
    b = jelastic.on_failure(JARCHS["smollm-360m"], JSHAPES["train_4k"], 256,
                            lost=3)
    assert a.shape == b.shape
    assert a.shape["data"] * a.shape["model"] == 128
    np.testing.assert_allclose(a.predicted_step_s, b.predicted_step_s,
                               rtol=RTOL)


def test_elastic_heterogeneous_pools_price_each_pool(tmp_path):
    """A pool descriptor prices each pool through its own registry model:
    here the analytic seeds of two GPUs, from an empty registry."""
    cfg = ARCHS["smollm-360m"]
    pools = [("gpu-h100", 8), ("gpu-a100", 8)]
    opts = elastic.replan(cfg, SHAPES["train_4k"], pools,
                          registry_dir=str(tmp_path), kernels=P)
    jopts = jelastic.replan(JARCHS["smollm-360m"], JSHAPES["train_4k"],
                            pools, registry_dir=str(tmp_path))
    assert {o.device for o in opts} == {"gpu-h100", "gpu-a100"}
    assert [(o.device, o.shape) for o in opts] == \
        [(o.device, o.shape) for o in jopts]
    np.testing.assert_allclose([o.predicted_step_s for o in opts],
                               [o.predicted_step_s for o in jopts],
                               rtol=RTOL)


# ---------------------------------------------------------------------------
# the step composition on the card's kernels (the default registry)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("phase", ["prefill", "train"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_card_step_vectors_track_archcount_leading_term(arch, phase):
    """On the card the projections, FFN and LM head are library GEMMs:
    their products exactly, ``mxu`` at the compute type's bits, no tile of
    the port's own; the attention and SSD kernels at the main paths'
    tiles.  The mxu total equals archcount's step count in the leading
    term (the kernels' tile and wave rounding is low order)."""
    from repro_torch.core import kernelmodel
    from repro_torch.core.symcount import add_vectors, evaluate_vector
    cfg = ARCHS[arch]
    spec = WorkloadSpec(phase=phase, global_batch=8, seq_len=4096)
    vecs = kernelmodel.step_kernel_vectors(cfg, spec)
    bits = 16 if "16" in cfg.compute_dtype else 32
    key = props.mxu_key(bits)
    assert set(vecs["matmul"]) == {key}
    env = {"B": 8, "S": 4096}
    def products(names):
        pv = evaluate_vector(add_vectors(*(vecs[n] for n in names)), env)
        return pv.get(props.mxu_key(16), 0.0) + pv.get(props.mxu_key(32),
                                                       0.0)
    # the SSD scan apart: its kernels count their own products (the FP32
    # one at a P slice recomputes C·Bᵀ per slice), on the pipe they use
    step = archcount.forward_counts(cfg)[key].eval(env)
    ssd = 0.0
    if cfg.ssm is not None:
        s = cfg.ssm
        ssd = 2 * 8 * 4096 * cfg.n_layers * cfg.ssm_heads * (
            s.chunk * s.d_state + s.chunk * s.head_dim
            + 2 * s.head_dim * s.d_state)
        assert products(["ssd_scan"]) > 0
    total = products([n for n in vecs if n != "ssd_scan"])
    assert total == pytest.approx(step - ssd, rel=0.03), (total, step)
    blocks = kernelmodel.step_kernel_blocks(cfg, spec)
    assert set(blocks) == {k for k in ("flash_attention", "ssd_scan")
                           if k in vecs}
    compute = kernelmodel.step_compute_vector(cfg, spec)
    assert set(compute) <= {key, props.mxu_key(48 - bits),
                            props.local_key(bits), props.local_key(32)}


def test_card_step_vectors_count_the_tiles_the_paths_launch():
    from repro_torch.core import kernelmodel
    from repro_torch.core.symcount import evaluate_vector
    from repro_torch.kernels import flash_attention as tfa
    cfg = ARCHS["llama3.2-3b"]
    spec = WorkloadSpec(phase="prefill", global_batch=4, seq_len=2048)
    got = evaluate_vector(kernelmodel.step_kernel_vectors(
        cfg, spec)["flash_attention"], {"B": 4, "S": 2048})
    bq, bk = tfa.tile_rule(cfg.head_dim_)[:2]
    want = evaluate_vector(kernelmodel.flash_attention_vector(
        4, cfg.n_heads, cfg.n_kv_heads, 2048, 2048, cfg.head_dim_,
        block_q=bq, block_k=bk, bits=16, variant="wgmma", resident=1), {})
    assert got == {k: v * cfg.n_layers for k, v in want.items()}
    # the reference's registry keeps its composition
    pallas = kernelmodel.step_kernel_vectors(cfg, spec, P)
    assert kernelmodel.step_kernel_blocks(cfg, spec, P) is None
    assert props.BARRIER in pallas["matmul"]
    # a zamba2 step's SSD runs the chunk "auto" resolves for its shape
    z = ARCHS["zamba2-2.7b"]
    zb = kernelmodel.step_kernel_blocks(z, spec)["ssd_scan"]
    assert zb["chunk"] == 128 and zb["resident"] == 1


def test_predictions_follow_the_registry():
    """The card's and the reference's compositions are distinct programs
    (cache keys carry the card's tiles), each equal across entry points."""
    cfg = ARCHS["zamba2-2.7b"]
    spec = WorkloadSpec(phase="prefill", global_batch=4, seq_len=2048)
    plan = Plan(dp_axes=())
    mesh = {"data": 1}
    card = predictor.predict_step(cfg, spec, plan, mesh, "gpu-h100")
    ref = predictor.predict_step(cfg, spec, plan, mesh, "gpu-h100",
                                 kernels=P)
    assert card.seconds != ref.seconds
    for kernels, pred in ((None, card), (P, ref)):
        secs = predictor.predict_plans(cfg, spec, [plan], mesh, "gpu-h100",
                                       kernels=kernels)
        np.testing.assert_allclose(secs[0], pred.seconds, rtol=1e-9)
        exp = predictor.score_explain(cfg, spec, plan, mesh, "gpu-h100",
                                      kernels=kernels)
        np.testing.assert_allclose(exp.total_seconds, pred.seconds,
                                   rtol=1e-9)
