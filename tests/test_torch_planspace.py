"""The port's symbolic counts, fused basis programs and plan-space engine
against the JAX package, on the CPU (mirrors ``tests/test_planspace.py``
and ``tests/test_exprops.py``).

Every module here is a numpy copy of the reference's, so the port is held
to the reference's own output: expression trees built alike in both
packages simplify to the same canonical form, the fused step programs of
llama3.2-3b, zamba2-2.7b and mixtral-8x7b have the same keys and basis
terms and evaluate alike at rtol 1e-12, and ``step_kernel_vectors`` of every
arch and phase evaluates alike at rtol 1e-12.  Within the port the batched
engine is held to the interpreted loop at rtol 1e-9, as the reference's
tests hold theirs.  The compile cache is pointed at a temporary directory
(``tests/conftest.py`` for the session, ``monkeypatch`` here).
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.registry import ARCHS as JARCHS
from repro.core import archcount as jarchcount
from repro.core import exprops as jexprops
from repro.core import kernelmodel as jkernelmodel
from repro.core import predictor as jpredictor
from repro.core import symcount as jsym
from repro.core import workload as jwl
from repro.launch import autoshard as jautoshard
from repro.runtime import straggler as jstraggler
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCHS
from repro_torch.core import archcount, exprops, kernelmodel, planspace
from repro_torch.core import predictor
from repro_torch.core import symcount as tsym
from repro_torch.core import workload as wl
from repro_torch.core.lru import LRUCache
from repro_torch.core.model import LinearCostModel
from repro_torch.core.symcount import evaluate_vector
from repro_torch.distributed.plan import Plan
from repro_torch.launch import autoshard
from repro_torch.launch.autoshard import candidate_plans
from repro_torch.runtime import straggler

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
#: the archs both registries hold (the port's also has Nemotron, which the
#: reference has not)
ALL_ARCHS = sorted(JARCHS)
PHASES = ("train", "prefill", "decode")
RTOL = 1e-12
#: the reference's registry: the step programs held to the reference's
#: compose its Pallas blocks (the card's are the default)
P = kernelmodel.PALLAS_KERNELS
_VARS = ("x", "y", "z")


def port_plan(p) -> Plan:
    return Plan(**{f.name: getattr(p, f.name)
                   for f in dataclasses.fields(p)})


# ---------------------------------------------------------------------------
# expression trees, built alike in both packages
# ---------------------------------------------------------------------------


def random_expr(rng: random.Random, depth: int, m) -> object:
    """A random tree of ``m``'s nodes (``m``: either package's symcount).
    Divisors stay positive constants; magnitudes stay exact in int64."""
    if depth <= 0 or rng.random() < 0.25:
        r = rng.random()
        if r < 0.45:
            return m.Var(rng.choice(_VARS))
        if r < 0.75:
            return m.Const(rng.randint(1, 6))
        return m.Const(round(rng.uniform(0.25, 3.0), 3))
    op = rng.randrange(8)
    a = random_expr(rng, depth - 1, m)
    b = random_expr(rng, depth - 1, m)
    if op == 0:
        return m.Add(a, b)
    if op == 1:
        return m.Mul(a, b)
    if op == 2:
        return a - b
    if op == 3:
        return m.FloorDiv(a, m.Const(rng.randint(1, 5)))
    if op == 4:
        return m.CeilDiv(a, m.Const(rng.randint(1, 5)))
    if op == 5:
        return m.Max(a, b) if rng.random() < 0.5 else m.Min(a, b)
    if op == 6:
        return m.Piecewise([(a, b)], random_expr(rng, depth - 1, m))
    return m.Pow(a, rng.choice((0, 1, 2)))


def random_int_expr(rng: random.Random, depth: int, m) -> object:
    """Integer-constant trees over every node type (``simplify`` is exact
    on them), the reference's ``tests/test_exprops.py`` generator."""
    if depth <= 0 or rng.random() < 0.25:
        if rng.random() < 0.55:
            return m.Var(rng.choice(_VARS))
        return m.Const(rng.randint(-4, 6))
    op = rng.randrange(9)
    a = random_int_expr(rng, depth - 1, m)
    b = random_int_expr(rng, depth - 1, m)
    if op == 0:
        return m.Add(a, b)
    if op == 1:
        return m.Mul(a, b)
    if op == 2:
        return a - b
    if op == 3:
        return m.FloorDiv(a, m.Const(rng.randint(1, 5)))
    if op == 4:
        return m.CeilDiv(a, m.Const(rng.randint(1, 5)))
    if op == 5:
        return m.Max(a, b) if rng.random() < 0.5 else m.Min(a, b)
    if op == 6:
        return m.Piecewise([(a, b)], random_int_expr(rng, depth - 1, m))
    if op == 7:
        return m.Piecewise([(m.Const(rng.randint(-1, 1)), a)], b)
    return m.Pow(a, rng.choice((0, 1, 2)))


@pytest.mark.parametrize("seed", range(40))
def test_compiled_expr_matches_eval_random_trees(seed):
    rng = random.Random(seed)
    e = random_expr(rng, 3, tsym)
    envs = [{v: rng.randint(1, 24) for v in _VARS} for _ in range(32)]
    pointwise = np.asarray([float(e.eval(env)) for env in envs])
    arr_env = {v: np.asarray([env[v] for env in envs], dtype=np.int64)
               for v in _VARS}
    compiled = np.broadcast_to(
        np.asarray(e.compile()(arr_env), dtype=np.float64), (len(envs),))
    np.testing.assert_allclose(compiled, pointwise, rtol=1e-12, atol=0)
    # the same tree in the reference evaluates alike
    je = random_expr(random.Random(seed), 3, jsym)
    assert repr(je) == repr(e)
    assert [float(je.eval(env)) for env in envs] == list(pointwise)


@pytest.mark.parametrize("seed", range(30))
def test_simplify_equals_the_reference_and_eval(seed):
    e = random_int_expr(random.Random(seed), 4, tsym)
    je = random_int_expr(random.Random(seed), 4, jsym)
    s, js = exprops.simplify(e), jexprops.simplify(je)
    assert repr(s) == repr(js)
    rng = random.Random(seed + 1000)
    for _ in range(8):
        env = {v: rng.randint(-5, 12) for v in _VARS}
        assert s.eval(env) == e.eval(env), (e, s, env)


def test_simplify_canonical_rewrites():
    x, y = tsym.Var("x"), tsym.Var("y")
    C, P = tsym.Const, tsym.Piecewise
    assert repr(exprops.simplify((x + 0) * 1 + x + 2 * x + C(3) + C(4))) \
        == "(4*x + 7)"
    assert repr(exprops.simplify(tsym.Mul(C(0), x) + tsym.Pow(x, 1))) == "x"
    assert repr(exprops.simplify(2 * (x + y))) == "(2*x + 2*y)"
    m = exprops.simplify(tsym.Max(tsym.Max(x, C(2)), x, C(5)))
    assert repr(m) == "max(5, x)"
    assert repr(exprops.simplify(P([(C(0), x)], y))) == "y"
    assert repr(exprops.simplify(P([(x, y)], y))) == "y"


# ---------------------------------------------------------------------------
# fused basis programs against the reference's
# ---------------------------------------------------------------------------


def _env_rows(n: int, phase: str) -> dict:
    """``n`` environment rows over every free variable a step program may
    read, as int64 arrays (the planspace engine's form)."""
    rng = np.random.default_rng(0)
    env = {"B": rng.integers(1, 64, n), "S": rng.integers(128, 8192, n),
           "M": rng.choice([1, 2, 4], n)}
    if phase == "decode":
        env.update(AS=rng.integers(1, 64, n), CT=rng.integers(1, 2 ** 18, n),
                   SL=rng.integers(1, 4, n), MI=rng.integers(1, 3, n))
    return {k: np.asarray(v, dtype=np.int64) for k, v in env.items()}


@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("arch", ["llama3.2-3b", "zamba2-2.7b",
                                  "mixtral-8x7b"])
def test_step_program_equals_the_reference(arch, phase):
    kw = dict(phase=phase, global_batch=8, seq_len=2048)
    if phase == "decode":
        kw.update(active_slots=5, cache_tokens=1e4, spec_len=2,
                  moe_imbalance=1.5)
    prog = predictor.step_program(ARCHS[arch], wl.WorkloadSpec(**kw), "full",
                                  kernels=P)
    jprog = jpredictor.step_program(JARCHS[arch], jwl.WorkloadSpec(**kw),
                                    "full")
    assert prog.keys == jprog.keys
    assert prog.term_reprs == jprog.term_reprs
    assert prog.params == jprog.params
    np.testing.assert_allclose(prog.coeff, jprog.coeff, rtol=RTOL)
    np.testing.assert_allclose(prog.const, jprog.const, rtol=RTOL)
    n = 12
    env = _env_rows(n, phase)
    cols, jcols = prog.property_columns(env, n), jprog.property_columns(env, n)
    for k in prog.keys:
        np.testing.assert_allclose(cols[k], jcols[k], rtol=RTOL, err_msg=k)
    # scored through each package's own analytic gpu-h100 seed
    from repro.calibration import seeds as jseeds
    from repro_torch.calibration import seeds
    np.testing.assert_allclose(
        exprops.score_cells(prog, env, n, seeds.ANALYTIC_SEEDS["gpu-h100"]()),
        jexprops.score_cells(jprog, env, n,
                             jseeds.ANALYTIC_SEEDS["gpu-h100"]()), rtol=RTOL)


@pytest.mark.parametrize("seed", range(10))
def test_program_columns_match_interpreted(seed):
    rng = random.Random(seed)
    pv = {f"p{i}": random_int_expr(rng, 3, tsym) for i in range(5)}
    pv["p_const"] = 3.5
    prog = exprops.build_program(pv)
    n = 16
    env = {v: np.asarray([rng.randint(1, 24) for _ in range(n)],
                         dtype=np.int64) for v in _VARS}
    cols = prog.property_columns(env, n)
    for k, v in pv.items():
        ref = [float(v.eval({vn: int(env[vn][i]) for vn in _VARS}))
               if isinstance(v, tsym.Expr) else float(v) for i in range(n)]
        np.testing.assert_allclose(cols[k], ref, rtol=1e-9, atol=1e-9,
                                   err_msg=k)
    model = LinearCostModel.from_dict({k: rng.uniform(0.5, 2.0) for k in pv})
    ref = np.zeros(n)
    for k, w in zip(model.keys, model.weights):
        ref += w * np.asarray(cols[k])
    np.testing.assert_allclose(exprops.score_cells(prog, env, n, model), ref,
                               rtol=1e-9)
    cache = exprops.BasisCache()
    for _ in range(2):                                # cold, then warm
        np.testing.assert_allclose(
            exprops.score_cells(prog, env, n, model, cache), ref, rtol=1e-9)
    assert cache.hits > 0


def test_program_explain_waits_for_obs_explain():
    """``BasisProgram.explain`` delegates to ``obs.explain`` (ported): its
    rows are ``explain_program``'s and sum to the fused score."""
    from repro_torch.obs.explain import explain_program
    prog = exprops.build_program({"p": tsym.Var("x") * 2 + 5})
    model = LinearCostModel.from_dict({"p": 1.5})
    rows = prog.explain({"x": 3}, model)
    assert rows == explain_program(prog, {"x": 3}, model)
    assert sum(sec for _, sec, _, _ in rows) == pytest.approx(
        float(prog.score({"x": 3}, model)), rel=1e-12)


# ---------------------------------------------------------------------------
# the persistent compile cache
# ---------------------------------------------------------------------------


def test_disk_cache_round_trip(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_COMPILE_CACHE", str(tmp_path))
    calls = []

    def builder():
        calls.append(1)
        return {"p": tsym.Var("x") * 3 + 1,
                "q": tsym.CeilDiv(tsym.Var("x"), tsym.Const(4))}

    key = exprops.program_key("test-program", "v1")
    p1 = exprops.load_or_build(key, builder)
    p2 = exprops.load_or_build(key, builder)
    assert len(calls) == 1, "the second build must come from disk"
    assert os.listdir(tmp_path) == [f"{key}.json"]
    model = LinearCostModel.from_dict({"p": 2.0, "q": 0.5})
    env = {"x": np.arange(1, 9, dtype=np.int64)}
    np.testing.assert_array_equal(exprops.score_cells(p1, env, 8, model),
                                  exprops.score_cells(p2, env, 8, model))
    exprops.load_or_build(exprops.program_key("test-program", "v2"), builder)
    assert len(calls) == 2
    # a corrupt record is quarantined and rebuilt
    with open(tmp_path / f"{key}.json", "w") as f:
        f.write("{not json")
    exprops.load_or_build(key, builder)
    assert len(calls) == 3 and (tmp_path / f"{key}.json.corrupt").exists()


def test_step_program_round_trips_through_the_disk_cache(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("REPRO_COMPILE_CACHE", str(tmp_path))
    cfg = ARCHS["smollm-360m"]
    spec = wl.WorkloadSpec(phase="prefill", global_batch=4, seq_len=2048)
    predictor._STEP_PROG_CACHE.clear()
    cold = predictor.step_program(cfg, spec, None, kernels=P)
    assert len(os.listdir(tmp_path)) == 1
    predictor._STEP_PROG_CACHE.clear()
    hits = exprops.DISK_STATS["hits"]
    warm = predictor.step_program(cfg, spec, None, kernels=P)
    assert exprops.DISK_STATS["hits"] == hits + 1
    env = {k: np.asarray([v]) for k, v in spec.env(cfg).items()}
    model = predictor.resolve_model(None)
    np.testing.assert_array_equal(exprops.score_cells(cold, env, 1, model),
                                  exprops.score_cells(warm, env, 1, model))


def test_disk_cache_default_and_disabled(monkeypatch):
    monkeypatch.delenv("REPRO_COMPILE_CACHE", raising=False)
    assert exprops.compile_cache_dir() == os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch", "exprops")
    monkeypatch.setenv("REPRO_COMPILE_CACHE", "off")
    assert exprops.compile_cache_dir() is None
    assert exprops.disk_cache_report() == "compile cache: disabled"
    monkeypatch.setenv("REPRO_COMPILE_CACHE", "/tmp/somewhere")
    assert exprops.compile_cache_dir() == "/tmp/somewhere"


def test_program_keys_are_the_ports_own():
    """The epoch hashes the port's formula modules, so a key of the port
    never names a program of the reference (or the other way round)."""
    assert all(m.startswith("repro_torch.core.")
               for m in exprops._EPOCH_MODULES)
    k = exprops.program_key("step", "cfg-a", "train", "full")
    assert k != jexprops.program_key("step", "cfg-a", "train", "full")
    assert len({k, exprops.program_key("step", "cfg-a", "train", "dots"),
                exprops.program_key("step", "cfg-b", "train", "full")}) == 3


# ---------------------------------------------------------------------------
# per-kernel vectors against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_step_kernel_vectors_equal_the_reference(arch, phase):
    env = {"B": 4, "S": 2048, "M": 1, "AS": 3, "CT": 5000, "SL": 1,
           "MI": 1.0}
    got = kernelmodel.step_kernel_vectors(ARCHS[arch],
                                          wl.WorkloadSpec(phase=phase),
                                          kernels=P)
    want = jkernelmodel.step_kernel_vectors(JARCHS[arch],
                                            jwl.WorkloadSpec(phase=phase))
    assert sorted(got) == sorted(want)
    for name in want:
        a = evaluate_vector(got[name], env)
        b = jsym.evaluate_vector(want[name], env)
        assert sorted(a) == sorted(b), name
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=RTOL,
                                       err_msg=f"{name}:{k}")
    c = evaluate_vector(kernelmodel.step_compute_vector(
        ARCHS[arch], wl.WorkloadSpec(phase=phase), kernels=P), env)
    jc = jsym.evaluate_vector(jkernelmodel.step_compute_vector(
        JARCHS[arch], jwl.WorkloadSpec(phase=phase)), env)
    assert sorted(c) == sorted(jc)
    for k in jc:
        np.testing.assert_allclose(c[k], jc[k], rtol=RTOL, err_msg=k)


def test_kernel_vector_builders_equal_the_reference():
    env = {"M": 4096, "N": 1024, "K": 3072, "Sq": 2048}
    cases = [("matmul_vector", ("M", "N", "K"), {}),
             ("matmul_vector", ("M", "N", "K"), dict(block_m=64, bits=16)),
             ("flash_attention_vector", (4, 24, 8, "Sq", "Sq", 128), {}),
             ("flash_attention_vector", (4, 32, 8, "Sq", "Sq", 128),
              dict(window=512)),
             ("ssd_scan_vector", (4, 80, "Sq", 64, 64), dict(chunk=64)),
             ("transpose_vector", ("M", "N"), dict(block=16))]
    for name, args, kw in cases:
        a = evaluate_vector(getattr(kernelmodel, name)(
            *[tsym.Var(x) if isinstance(x, str) else x for x in args], **kw),
            env)
        b = jsym.evaluate_vector(getattr(jkernelmodel, name)(
            *[jsym.Var(x) if isinstance(x, str) else x for x in args], **kw),
            env)
        assert a == b, (name, kw)


# ---------------------------------------------------------------------------
# the batched engine within the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sweep_cell():
    cfg = ARCHS["smollm-360m"]
    shape = SHAPES["train_4k"]
    plans = candidate_plans(cfg, shape)
    meshes = planspace.mesh_factorizations(64)
    return cfg, shape, plans, meshes


def test_planspace_scores_match_interpreted_loop(sweep_cell):
    cfg, shape, plans, meshes = sweep_cell
    space = planspace.PlanSpace.from_product(cfg, shape, plans, meshes,
                                             kernels=P)
    assert len(space) == len(plans) * len(meshes)
    batched = space.scores(None)
    np.testing.assert_allclose(batched, space.scores_columns(None),
                               rtol=1e-9)
    loop = np.concatenate([
        predictor.predict_plans_loop(cfg, shape, plans, m,
                                     kernels=P) for m in meshes])
    np.testing.assert_allclose(
        batched.reshape(len(plans), len(meshes)),
        loop.reshape(len(meshes), len(plans)).T, rtol=1e-9)


def test_planspace_scores_equal_the_reference(sweep_cell):
    cfg, shape, plans, meshes = sweep_cell
    jplans = jautoshard.candidate_plans(JARCHS["smollm-360m"],
                                        JSHAPES["train_4k"])
    got = planspace.PlanSpace.from_product(cfg, shape, plans, meshes,
                                           kernels=P)
    from repro.core import planspace as jplanspace
    want = jplanspace.PlanSpace.from_product(
        JARCHS["smollm-360m"], JSHAPES["train_4k"], jplans,
        jplanspace.mesh_factorizations(64))
    np.testing.assert_allclose(got.scores(None), want.scores(None),
                               rtol=RTOL)
    np.testing.assert_array_equal(got.peak_bytes(), want.peak_bytes())


def test_predict_plans_routes_through_engine(sweep_cell):
    cfg, shape, plans, _ = sweep_cell
    mesh = {"data": 8, "model": 8}
    np.testing.assert_allclose(
        predictor.predict_plans(cfg, shape, plans, mesh, kernels=P),
        predictor.predict_plans_loop(cfg, shape, plans, mesh,
                                     kernels=P), rtol=1e-9)


def test_from_cells_and_subset(sweep_cell):
    cfg, shape, plans, meshes = sweep_cell
    prod_space = planspace.PlanSpace.from_product(cfg, shape, plans[:6],
                                                  meshes, kernels=P)
    cells = [(p, m) for p in plans[:6] for m in meshes]
    cell_space = planspace.PlanSpace.from_cells(cfg, shape, cells, kernels=P)
    np.testing.assert_array_equal(prod_space.dp, cell_space.dp)
    np.testing.assert_array_equal(prod_space.tp, cell_space.tp)
    np.testing.assert_allclose(prod_space.scores(None),
                               cell_space.scores(None), rtol=1e-12)
    secs = prod_space.scores(None)
    mask = np.zeros(len(prod_space), dtype=bool)
    mask[::5] = True
    sub = prod_space.subset(mask)
    assert len(sub) == int(mask.sum())
    np.testing.assert_allclose(sub.scores(None), secs[mask], rtol=1e-12)


def test_empty_candidate_set(sweep_cell):
    cfg, shape, _, _ = sweep_cell
    space = planspace.PlanSpace.from_cells(cfg, shape, [], kernels=P)
    assert len(space) == 0
    assert space.scores(None).shape == (0,)
    assert space.feasible_mask().shape == (0,)
    assert planspace.peak_bytes(cfg, shape, [], []).shape == (0,)
    assert space.rank(None) == []
    assert predictor.predict_plans(cfg, shape, [], {"data": 2},
                                   kernels=P).shape == (0,)


@pytest.mark.parametrize("chunk", [37, 10 ** 7])
def test_stream_topk_matches_rank_prefix(sweep_cell, chunk):
    cfg, shape, plans, meshes = sweep_cell
    space = planspace.PlanSpace.from_product(cfg, shape, plans, meshes,
                                             kernels=P)
    full = space.rank(None)[:10]
    streamed = planspace.stream_topk(cfg, shape, plans, meshes, None, k=10,
                                     chunk_cells=chunk, kernels=P)
    assert [s for s, _, _ in streamed] == pytest.approx(
        [s for s, _, _ in full], rel=1e-12)
    assert [(p, m) for _, p, m in streamed] == [(p, m) for _, p, m in full]


def test_incremental_rescore_matches_cold_after_device_delta(sweep_cell):
    cfg, shape, plans, _ = sweep_cell
    model = predictor.resolve_model(None)
    cache = exprops.BasisCache()
    for n_dev in (64, 63):
        cells = [(p, m) for p in plans[:10]
                 for m in planspace.mesh_factorizations(n_dev)]
        space = planspace.PlanSpace.from_cells(cfg, shape, cells, kernels=P)
        np.testing.assert_allclose(space.scores(model, cache=cache),
                                   space.scores(model), rtol=1e-12)
    assert cache.hits >= cache.misses > 0


@pytest.mark.parametrize("arch", ["glm4-9b", "mixtral-8x7b"])
@pytest.mark.parametrize("kind", PHASES)
def test_collective_symbolic_matches_scalar_and_the_reference(arch, kind):
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    env = {"B": 64, "S": 2048}
    from repro.distributed.plan import Plan as JPlan
    for fsdp in (True, False):
        for compression in (None, "int8_ef"):
            for moe_mode in (("tp", "ep") if cfg.moe else ("tp",)):
                for dp, tp in ((1, 1), (1, 16), (16, 1), (4, 8)):
                    for mb in (1, 4):
                        kw = dict(dp_axes=("data",), fsdp=fsdp,
                                  microbatches=mb, moe_mode=moe_mode,
                                  compression=compression)
                        plan, mesh = Plan(**kw), {"data": dp, "model": tp}
                        ref = evaluate_vector(
                            archcount.collective_counts(cfg, kind, plan,
                                                        mesh), env)
                        jref = jsym.evaluate_vector(
                            jarchcount.collective_counts(jcfg, kind,
                                                         JPlan(**kw), mesh),
                            env)
                        assert ref == jref
                        sym = evaluate_vector(
                            archcount.collective_counts_symbolic(
                                cfg, kind,
                                archcount.collective_topology(plan)),
                            {**env, "M": mb, "DP": dp, "TP": tp})
                        for k, v in ref.items():
                            assert sym[k] == pytest.approx(v, rel=1e-12)
                        for k, v in sym.items():
                            if k not in ref:
                                assert v == 0.0, (k, dp, tp)


@pytest.mark.parametrize("arch,shname", [
    ("glm4-9b", "train_4k"), ("glm4-9b", "prefill_32k"),
    ("mixtral-8x7b", "decode_32k"), ("mamba2-370m", "decode_32k"),
    ("zamba2-2.7b", "train_4k")])
def test_peak_bytes_batched_matches_scalar(arch, shname):
    cfg, shape = ARCHS[arch], SHAPES[shname]
    plans = candidate_plans(cfg, shape)
    meshes = planspace.mesh_factorizations(256)
    space = planspace.PlanSpace.from_product(cfg, shape, plans, meshes,
                                             kernels=P)
    batched = space.peak_bytes()
    assert batched.shape == (len(space),)
    rng = random.Random(0)
    for i in rng.sample(range(len(space)), 25):
        assert batched[i] == predictor.estimate_peak_bytes(
            cfg, shape, space.plans[i], space.mesh_shapes[i]), i
    mask = space.feasible_mask()
    assert mask.dtype == bool and mask.shape == (len(space),)


def test_mesh_factorizations_cover_all_splits():
    meshes = planspace.mesh_factorizations(64)
    assert all(m["data"] * m["model"] == 64 for m in meshes)
    assert {m["data"] for m in meshes} == {1, 2, 4, 8, 16, 32, 64}
    assert all(m["data"] * m["model"] == 48
               for m in planspace.mesh_factorizations(48))
    with pytest.raises(ValueError):
        planspace.mesh_factorizations(8, axes=("a", "b", "c"))
    from repro.core import planspace as jplanspace
    assert planspace.factor_pairs(36) == jplanspace.factor_pairs(36)


@pytest.mark.parametrize("mesh", [{"data": 8, "model": 8},
                                  {"data": 64, "model": 1}])
def test_cotune_kernel_blocks_matches_the_reference(sweep_cell, mesh):
    """At the reference's grids (``PALLAS_KERNELS``) and default model the
    co-tuning returns the reference's blocks for each plan's shard shapes;
    over the CUDA registry (the default), tiles of its grids."""
    from repro.core import planspace as jplanspace
    from repro_torch.kernels import autotune
    cfg, shape, _, _ = sweep_cell
    jcfg, jshape = JARCHS["smollm-360m"], JSHAPES["train_4k"]
    for jplan in jautoshard.candidate_plans(jcfg, jshape)[:4]:
        plan = port_plan(jplan)
        got = planspace.cotune_kernel_blocks(
            cfg, shape, plan, mesh, kernels=kernelmodel.PALLAS_KERNELS)
        assert got == jplanspace.cotune_kernel_blocks(jcfg, jshape, jplan,
                                                      mesh)
        cuda = planspace.cotune_kernel_blocks(cfg, shape, plan, mesh)
        assert cuda.keys() == got.keys()
        shapes = autotune.workload_kernel_shapes(
            cfg, shape, dp=planspace._axis_product(mesh, plan.dp_axes),
            tp=mesh.get(plan.tp_axis, 1) if plan.tp_axis else 1,
            microbatches=plan.microbatches)
        for kern, blocks in cuda.items():
            assert blocks in autotune.candidate_configs(kern, shapes[kern])


def test_rank_plans_tie_break_is_enumeration_order_free(sweep_cell):
    cfg, shape, plans, _ = sweep_cell
    flat = LinearCostModel(keys=["const1"], weights=np.array([1.0]),
                           device="flat")
    mesh = {"data": 8, "model": 8}
    a = predictor.rank_plans(cfg, shape, plans, mesh, flat, kernels=P)
    shuffled = list(plans)
    random.Random(3).shuffle(shuffled)
    b = predictor.rank_plans(cfg, shape, shuffled, mesh, flat, kernels=P)
    assert [p for _, p in a] == [p for _, p in b]


def test_rank_plans_equals_the_reference(sweep_cell):
    cfg, shape, plans, _ = sweep_cell
    jplans = jautoshard.candidate_plans(JARCHS["smollm-360m"],
                                        JSHAPES["train_4k"])
    mesh = {"data": 8, "model": 8}
    a = predictor.rank_plans(cfg, shape, plans, mesh, kernels=P)
    b = jpredictor.rank_plans(JARCHS["smollm-360m"], JSHAPES["train_4k"],
                              jplans, mesh)
    assert [dataclasses.asdict(p) for _, p in a] == \
        [dataclasses.asdict(p) for _, p in b]
    np.testing.assert_allclose([s for s, _ in a], [s for s, _ in b],
                               rtol=RTOL)


# ---------------------------------------------------------------------------
# bounded caches, the straggler monitor, the launcher
# ---------------------------------------------------------------------------


def test_lru_cache_bounds_and_recency():
    c = LRUCache(maxsize=3)
    for i in range(3):
        c[i] = i * 10
    assert c.get(0) == 0
    c[3] = 30                     # evicts 1 (least recent), not 0
    assert 0 in c and 3 in c and 1 not in c and len(c) == 3
    c[0] = 99
    assert c.get(0) == 99
    with pytest.raises(ValueError):
        LRUCache(0)
    assert isinstance(predictor._STEP_PV_CACHE, LRUCache)
    assert predictor._STEP_PV_CACHE.maxsize <= 128
    assert isinstance(planspace._COLL_CV_CACHE, LRUCache)


@pytest.mark.parametrize("arch,shape,mesh", [
    ("smollm-360m", "train_4k", {"data": 8, "model": 8}),
    ("llama3.2-3b", "prefill_32k", {"data": 1, "model": 1}),
    ("zamba2-2.7b", "decode_32k", {"data": 2, "model": 4})])
def test_straggler_from_model_equals_the_reference(arch, shape, mesh):
    jplan = jautoshard.candidate_plans(JARCHS[arch], JSHAPES[shape])[0]
    mon = straggler.StragglerMonitor.from_model(
        ARCHS[arch], SHAPES[shape], port_plan(jplan), mesh, n_hosts=4,
        k=3.0, kernels=P)
    jmon = jstraggler.StragglerMonitor.from_model(
        JARCHS[arch], JSHAPES[shape], jplan, mesh, n_hosts=4, k=3.0)
    np.testing.assert_allclose(mon.predicted_step_s, jmon.predicted_step_s,
                               rtol=RTOL)
    assert mon.k == 3.0 and mon.n_hosts == 4
    ref = predictor.predict_plans(ARCHS[arch], SHAPES[shape],
                                  [port_plan(jplan)], mesh, kernels=P)
    assert mon.predicted_step_s == pytest.approx(float(ref[0]), rel=1e-9)
    assert straggler._BASIS_CACHE.hits + straggler._BASIS_CACHE.misses > 0


def test_train_launcher_prints_the_predicted_step(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", REPRO_MODEL_REGISTRY=str(tmp_path))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "llama3.2-3b", "--reduced", "--device", "cpu", "--steps", "1",
         "--batch", "2", "--seq", "32"], env=env, cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    line = next(l for l in out.stdout.splitlines() if "predicted" in l)
    assert "predicted full-arch step" in line
    assert "model gpu-h100" in line and "source datasheet-seed" in line
    from repro_torch.calibration import seeds
    from repro_torch.distributed.plan import plan_for
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=32,
                                global_batch=2)
    want = predictor.predict_step(
        ARCHS["llama3.2-3b"], shape,
        plan_for(ARCHS["llama3.2-3b"], SHAPES["train_4k"]),
        {"data": 1, "model": 1}, seeds.ANALYTIC_SEEDS["gpu-h100"]())
    assert f"{want.seconds * 1e3:.1f}ms" in line


def test_train_launcher_names_a_fitted_model(tmp_path):
    """A fitted ``gpu-h100`` in the registry shadows the analytic seed."""
    from repro_torch.calibration import registry, seeds
    fitted = seeds.ANALYTIC_SEEDS["gpu-h100"]()
    fitted = LinearCostModel(keys=fitted.keys, weights=fitted.weights * 2,
                             device="gpu-h100",
                             meta={"source": "calibrated"})
    registry.save_model(fitted, str(tmp_path))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", REPRO_MODEL_REGISTRY=str(tmp_path))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "smollm-360m", "--reduced", "--device", "cpu", "--steps", "1",
         "--batch", "2", "--seq", "16"], env=env, cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "model gpu-h100, source calibrated" in out.stdout


# ---------------------------------------------------------------------------
# the plan search (launch/autoshard.py) against the reference's
# ---------------------------------------------------------------------------


def _plan_dicts(plans):
    return [dataclasses.asdict(p) for p in plans]


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ["glm4-9b", "mixtral-8x7b", "zamba2-2.7b",
                                  "smollm-360m"])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_candidate_plans_equal_the_reference(arch, shape, multi_pod):
    got = candidate_plans(ARCHS[arch], SHAPES[shape], multi_pod)
    want = jautoshard.candidate_plans(JARCHS[arch], JSHAPES[shape],
                                      multi_pod)
    assert got and _plan_dicts(got) == _plan_dicts(want)


@pytest.mark.parametrize("n", [None, 64, 96])
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_candidate_meshes_equal_the_reference(shape, n):
    for multi_pod in ((False, True) if n is None else (False,)):
        assert autoshard.candidate_meshes(
            SHAPES[shape], multi_pod=multi_pod, n_devices=n) \
            == jautoshard.candidate_meshes(JSHAPES[shape],
                                           multi_pod=multi_pod, n_devices=n)
    with pytest.raises(ValueError, match="multi_pod"):
        autoshard.candidate_meshes(SHAPES[shape], multi_pod=True,
                                   n_devices=64)


def _ranked_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0], w[0], rtol=RTOL)
        assert dataclasses.asdict(g[1]) == dataclasses.asdict(w[1])
        assert g[2] == w[2]
        if len(w) == 4:
            assert g[3] == w[3]


@pytest.mark.parametrize("kw", [
    dict(top_k=3),
    dict(top_k=8, n_devices=64),
    dict(top_k=1, meshes=[{"data": 8, "model": 8}]),
    dict(top_k=2, tune_kernels=True),
    dict(top_k=4, n_devices=64, stream_chunk_cells=100),
], ids=["default-mesh", "sweep-64", "meshes", "tune-kernels", "stream"])
@pytest.mark.parametrize("arch,shape", [("smollm-360m", "train_4k"),
                                        ("mixtral-8x7b", "prefill_32k")])
def test_autoshard_search_equals_the_reference(arch, shape, kw):
    got = autoshard.search(arch, shape, kernels=P, **kw)
    want = jautoshard.search(arch, shape, **kw)
    _ranked_equal(got, want)


def test_autoshard_search_default_mesh_unchanged():
    ranked = autoshard.search("smollm-360m", "train_4k", top_k=3)
    assert all(mesh == {"data": 16, "model": 16} for _, _, mesh in ranked)
    secs = [s for s, _, _ in ranked]
    assert secs == sorted(secs)


def test_autoshard_search_mesh_sweep():
    ranked = autoshard.search("smollm-360m", "train_4k", n_devices=64,
                              top_k=8)
    assert ranked
    assert all(mesh["data"] * mesh["model"] == 64 for _, _, mesh in ranked)
    assert all(SHAPES["train_4k"].global_batch % mesh["data"] == 0
               for _, _, mesh in ranked)
    secs = [s for s, _, _ in ranked]
    assert secs == sorted(secs)
    fixed = autoshard.search("smollm-360m", "train_4k",
                             meshes=[{"data": 8, "model": 8}], top_k=1)
    assert ranked[0][0] <= fixed[0][0] + 1e-12


def test_autoshard_multi_pod_rejects_device_sweep():
    with pytest.raises(ValueError, match="multi_pod"):
        autoshard.search("smollm-360m", "train_4k", multi_pod=True,
                         n_devices=64)


def test_autoshard_tune_kernels_are_the_card_tiles():
    """On the card's registry the co-tuned blocks are tiles the CUDA
    sources build, with the blocks an SM holds."""
    ranked = autoshard.search("smollm-360m", "train_4k", top_k=2,
                              model="gpu-h100", tune_kernels=True)
    for entry in ranked:
        assert len(entry) == 4
        blocks = entry[3]
        assert "matmul" in blocks and "flash_attention" in blocks
        assert set(blocks["matmul"]) == {"block_m", "block_n", "block_k",
                                         "resident"}
        assert blocks["matmul"] in autotune_candidates("matmul", entry)
        assert all(isinstance(v, int) for b in blocks.values()
                   for v in b.values())


def autotune_candidates(kernel, entry):
    from repro_torch.kernels import autotune
    shape = autotune.workload_kernel_shapes(
        ARCHS["smollm-360m"], SHAPES["train_4k"], dp=entry[2]["data"],
        tp=entry[2]["model"], microbatches=entry[1].microbatches)[kernel]
    return autotune.candidate_configs(kernel, shape)


def test_autoshard_cli_prints_the_card_model_and_explains(capsys):
    autoshard.main(["--arch", "smollm-360m", "--shape", "train_4k",
                    "--top", "2", "--explain"])
    out = capsys.readouterr().out
    assert "[autoshard] cost model: device=gpu-h100" in out
    assert "top-2 plans for smollm-360m" in out and "model=gpu-h100" in out
    assert "winning cell attribution:" in out and "predicted " in out
