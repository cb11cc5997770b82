"""The port's training substrates against the JAX package: the data
pipeline, the checkpoint store, the straggler monitor, the parallelism plan
and the optimizers, on the CPU.

Tolerances: the data pipeline and the plan are copies, held bit-equal; the
optimizers' single updates (f32 math in both packages, other summation and
fusion orders) 1e-6; a checkpoint round trip is bit-equal, bf16 included.
The checkpoint and straggler tests mirror ``tests/test_substrates.py``.
"""
from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.registry import ARCHS as JARCHS
from repro.data import pipeline as jpipe
from repro.distributed import plan as jplan
from repro.models import transformer as jtransformer
from repro.optim import optimizers as jopt
from repro_torch.checkpoint import store
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.data import pipeline as tpipe
from repro_torch.distributed import plan as tplan
from repro_torch.models import convert
from repro_torch.optim import optimizers as topt
from repro_torch.runtime.straggler import StragglerMonitor

torch.set_num_threads(1)

TOL_OPT = dict(atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# Data pipeline
# ---------------------------------------------------------------------------


def _dc(pkg, **kw):
    base = dict(vocab_size=256, seq_len=64, global_batch=8, seed=7)
    base.update(kw)
    return pkg.DataConfig(**base)


@pytest.mark.parametrize("kw", [{}, {"seed": 3, "seq_len": 96},
                                {"n_codebooks": 4},
                                {"vocab_size": 128256, "seq_len": 256,
                                 "global_batch": 2}],
                         ids=["base", "seed3", "codebooks", "llama-vocab"])
def test_packed_loader_is_bit_equal_to_the_reference(kw):
    t, j = tpipe.PackedLoader(_dc(tpipe, **kw)), \
        jpipe.PackedLoader(_dc(jpipe, **kw))
    n = _dc(tpipe, **kw).global_batch
    for step, rank, ranks in ((0, 0, 1), (5, 0, 1), (2, 1, 2), (3, 3, n)):
        a, b = t.batch(step, rank, ranks), j.batch(step, rank, ranks)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])


def test_data_deterministic_and_seekable():
    l1, l2 = tpipe.PackedLoader(_dc(tpipe)), tpipe.PackedLoader(_dc(tpipe))
    b_a = l1.batch(5)
    _ = l1.batch(0), l1.batch(3)        # call order must not matter
    b_b = l2.batch(5)
    for k in b_a:
        np.testing.assert_array_equal(b_a[k], b_b[k])


def test_data_rank_sharding_and_shift():
    cfg = _dc(tpipe)
    full = tpipe.PackedLoader(cfg).batch(2)
    parts = [tpipe.PackedLoader(cfg).batch(2, rank=r, n_ranks=4)
             for r in range(4)]
    np.testing.assert_array_equal(
        full["tokens"], np.concatenate([p["tokens"] for p in parts]))
    np.testing.assert_array_equal(full["tokens"][:, 1:],
                                  full["labels"][:, :-1])
    assert 0.2 < full["loss_mask"].mean() <= 1.0


# ---------------------------------------------------------------------------
# Parallelism plan
# ---------------------------------------------------------------------------


def test_plan_is_an_equal_copy():
    for kw in ({}, {"microbatches": 4, "remat_policy": "dots"},
               {"fsdp": False, "moe_mode": "ep"}):
        t, j = tplan.Plan(**kw), jplan.Plan(**kw)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_rules() == j.param_rules()
        assert t.act_rules() == j.act_rules()
        assert dataclasses.asdict(t.with_(microbatches=2)) == \
            dataclasses.asdict(j.with_(microbatches=2))
    for kind in ("train", "prefill", "decode"):
        for multi in (False, True):
            assert dataclasses.asdict(tplan.default_plan(kind, multi)) == \
                dataclasses.asdict(jplan.default_plan(kind, multi))


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_plan_for_matches_the_reference(arch):
    for shape in JSHAPES.values():
        for multi in (False, True):
            assert dataclasses.asdict(
                tplan.plan_for(TARCHS[arch], shape, multi_pod=multi,
                               hbm_budget=16e9)) == \
                dataclasses.asdict(
                    jplan.plan_for(JARCHS[arch], shape, multi_pod=multi))


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------


def _params_and_grads(seed):
    rng = np.random.default_rng(seed)
    shapes = {"w": (8, 16), "b": (16,), "t": (3, 6, 5)}
    p = {n: (0.5 * rng.standard_normal(s)).astype(np.float32)
         for n, s in shapes.items()}
    gs = [{n: (0.1 * rng.standard_normal(s)).astype(np.float32)
           for n, s in shapes.items()} for _ in range(3)]
    return p, gs


def _t(tree):
    return {n: torch.from_numpy(a.copy()) for n, a in tree.items()}


def _leaves_close(t_tree, j_tree, path=""):
    if isinstance(j_tree, dict):
        assert sorted(t_tree) == sorted(j_tree), path
        for k in j_tree:
            _leaves_close(t_tree[k], j_tree[k], f"{path}/{k}")
    elif isinstance(t_tree, int):
        assert t_tree == int(j_tree), path
    else:
        np.testing.assert_allclose(t_tree.float().numpy(),
                                   np.asarray(j_tree, np.float32),
                                   err_msg=path, **TOL_OPT)


@pytest.mark.parametrize("name,kw", [
    ("adamw", {}), ("adamw", {"weight_decay": 0.0, "b2": 0.999}),
    ("adafactor", {}), ("adafactor", {"momentum": 0.9}), ("sgd", {}),
    ("sgd", {"momentum": 0.5})],
    ids=["adamw", "adamw-nodecay", "adafactor", "adafactor-momentum", "sgd",
         "sgd-0.5"])
def test_optimizer_updates_match_the_reference(name, kw):
    """Three updates from the same parameters and gradients: parameters
    and the whole state (count included) at 1e-6."""
    if name == "adafactor" and "momentum" in kw:
        t_opt = topt.adafactor(momentum=0.9, momentum_dtype=torch.float32)
        j_opt = jopt.adafactor(momentum=0.9, momentum_dtype=jnp.float32)
    else:
        t_opt, j_opt = getattr(topt, name)(**kw), getattr(jopt, name)(**kw)
    p, gs = _params_and_grads(0)
    tp, jp = _t(p), {n: jnp.asarray(a) for n, a in p.items()}
    ts, js = t_opt.init(tp), j_opt.init(jp)
    for i, g in enumerate(gs):
        lr = 1e-2 * (i + 1)
        tp, ts = t_opt.update(_t(g), ts, tp, lr)
        jp, js = j_opt.update({n: jnp.asarray(a) for n, a in g.items()},
                              js, jp, jnp.float32(lr))
    _leaves_close(tp, jp)
    _leaves_close(ts, js)


def _per_name(cfg, tree, flip):
    """A reference tree of the parameters' layout (stacked) as the port's
    names: each entry's slice of its layer (``flip`` swaps a dense weight's
    last two axes), or, with ``flip=None``, the whole stacked leaf."""
    def leaf(a, layer, f32):
        if a is None:
            return None
        a = np.asarray(a, np.float32)
        return a if layer is None or flip is None else a[layer]
    return convert._convert(cfg, tree, leaf,
                            (lambda a: a) if flip is None else flip)


@pytest.mark.parametrize("momentum", [None, 0.9],
                         ids=["no-momentum", "momentum"])
@pytest.mark.parametrize("arch", ["smollm-360m", "zamba2-2.7b"])
def test_adafactor_over_a_model_tree_matches_the_stacked_reference(
        arch, momentum):
    """Adafactor over a converted model's parameters (one entry a layer)
    against the reference's over its stacked tree: three updates,
    parameters and the whole state at 1e-6.  The reference factors a
    stacked 1-D leaf's moment across the layers and clips each stacked
    leaf's update by its RMS over all layers."""
    kw = dict(n_layers=3, param_dtype="float32")
    jc = dataclasses.replace(JARCHS[arch].reduced(), **kw)
    tc = dataclasses.replace(TARCHS[arch].reduced(), **kw)
    jp, _ = jtransformer.init_params(jc, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    grads = [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32) * np.float32(rng.uniform(0.1, 3)), jp) for _ in range(3)]
    mk = {} if momentum is None else dict(momentum=momentum)
    t_opt = topt.adafactor(momentum_dtype=torch.float32, **mk)
    j_opt = jopt.adafactor(momentum_dtype=jnp.float32, **mk)
    tp = convert.params_from_reference(tc, jax.tree.map(np.asarray, jp))
    ts, js = t_opt.init(tp), j_opt.init(jp)
    for i, g in enumerate(grads):
        lr = 1e-2 * (i + 1)
        tp, ts = t_opt.update(convert.params_from_reference(tc, g), ts, tp,
                              lr)
        jp, js = j_opt.update(jax.tree.map(jnp.asarray, g), js, jp,
                              jnp.float32(lr))
    want = convert.params_from_reference(tc, jax.tree.map(np.asarray, jp))
    assert sorted(tp) == sorted(want)
    for n in tp:
        np.testing.assert_allclose(tp[n].numpy(), want[n].numpy(),
                                   err_msg=n, **TOL_OPT)
    assert ts["count"] == int(js["count"]) == 3
    if momentum is not None:
        m = _per_name(tc, js["m"], lambda a: np.swapaxes(a, -1, -2))
        for n in tp:
            np.testing.assert_allclose(ts["m"][n].numpy(), m[n],
                                       err_msg=n, **TOL_OPT)
    whole = {k: _per_name(tc, jax_map(lambda d: d.get(k), js["v"]), None)
             for k in ("v", "vr", "vc")}
    flipped = convert._convert(tc, jax.tree.map(np.asarray, jp),
                               lambda a, layer, f32: False, lambda a: True)
    groups = topt.stacked_groups(tp)
    stacked = 0
    for key, v in ts["v"].items():
        if key in groups and len(groups[key]) > 1:   # a stacked 1-D leaf
            stacked += 1
            n, layer = groups[key][0], None
            assert v["vr"].shape == (3,) and v["vc"].shape == tp[n].shape
        else:
            n = key
            layer = int(n.split(".")[1]) if n.startswith("blocks.") \
                else None
        for k, t in v.items():
            rk = {"vr": "vc", "vc": "vr"}.get(k, k) if flipped[n] else k
            ref = whole[rk][n]
            ref = ref if layer is None else ref[layer]
            np.testing.assert_allclose(t.numpy(), ref, err_msg=f"{key}/{k}",
                                       **TOL_OPT)
    assert stacked > 0


def jax_map(fn, tree):
    """``fn`` on each dict leaf of a reference Adafactor ``v`` tree."""
    if isinstance(tree, dict) and ("vr" in tree or "v" in tree) and \
            not any(isinstance(v, dict) for v in tree.values()):
        return fn(tree)
    return {k: jax_map(fn, v) for k, v in tree.items()}


def test_adamw_keeps_the_parameter_type_and_updates_in_place():
    p = {"w": torch.ones(4, 4, dtype=torch.bfloat16)}
    o = topt.adamw()
    st = o.init(p)
    assert st["m"]["w"].dtype == torch.float32 and st["count"] == 0
    ptr = p["w"].data_ptr()
    p2, st = o.update({"w": torch.full((4, 4), 0.5, dtype=torch.bfloat16)},
                      st, p, 1e-2)
    assert p2["w"] is p["w"] and p["w"].data_ptr() == ptr
    assert p["w"].dtype == torch.bfloat16 and st["count"] == 1
    assert float(p["w"][0, 0]) < 1.0
    with pytest.raises(KeyError):
        topt.get_optimizer("lion")


@pytest.mark.parametrize("max_norm", [0.1, 100.0], ids=["clips", "passes"])
def test_clip_by_global_norm_matches_the_reference(max_norm):
    _, gs = _params_and_grads(1)
    g = gs[0]
    tg, tnorm = topt.clip_by_global_norm(_t(g), max_norm)
    jg, jnorm = jopt.clip_by_global_norm(
        {n: jnp.asarray(a) for n, a in g.items()}, max_norm)
    np.testing.assert_allclose(float(tnorm), float(jnorm), **TOL_OPT)
    _leaves_close(tg, jg)


def test_warmup_cosine_matches_the_reference():
    for peak, warm, total in ((3e-4, 20, 1000), (1e-3, 1, 10), (0.5, 0, 7)):
        t, j = topt.warmup_cosine(peak, warm, total), \
            jopt.warmup_cosine(peak, warm, total)
        for step in (0, 1, 5, warm, warm + 1, total // 2, total, total + 9):
            np.testing.assert_allclose(t(step), float(j(jnp.int32(step))),
                                       rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# Checkpointing (mirrors tests/test_substrates.py)
# ---------------------------------------------------------------------------


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(4, 8, generator=g),
            "b": {"c": torch.arange(7, dtype=torch.int32),
                  "d": torch.tensor(3.5),
                  "h": torch.randn(5, 3, generator=g).to(torch.bfloat16)},
            "n": np.arange(3, dtype=np.int64), "step": 11, "lr": 0.25}


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert b.dtype == a.dtype and b.shape == a.shape
        assert torch.equal(a.view(torch.uint8) if a.dtype == torch.bfloat16
                           else a, b.view(torch.uint8)
                           if b.dtype == torch.bfloat16 else b)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b


def test_checkpoint_roundtrip_is_bit_equal(tmp_path):
    t = _tree()
    store.save(str(tmp_path), 3, t)
    restored, manifest = store.restore(str(tmp_path), _tree(seed=1))
    assert manifest["step"] == 3
    _assert_tree_equal(t, restored)
    bf = [m for m in manifest["leaves"] if m["dtype"] == "bfloat16"]
    assert len(bf) == 1 and bf[0]["stored"] == "uint16"


def test_checkpoint_load_into_writes_the_live_tensors(tmp_path):
    t = _tree()
    store.save(str(tmp_path), 4, t)
    live = _tree(seed=2)
    live["step"] = 0
    ptr = live["a"].data_ptr()
    restored, _ = store.restore(str(tmp_path), live)
    out = store.load_into(live, restored)
    assert out["a"] is live["a"] and live["a"].data_ptr() == ptr
    _assert_tree_equal(t, out)


def test_checkpoint_template_mismatch_raises(tmp_path):
    store.save(str(tmp_path), 1, _tree())
    wrong = _tree()
    wrong["b"]["h"] = wrong["b"]["h"].float()
    with pytest.raises(store.CheckpointError, match="template"):
        store.restore(str(tmp_path), wrong)
    with pytest.raises(store.CheckpointError, match="leaves"):
        store.restore(str(tmp_path), {"a": torch.zeros(4, 8)})


def test_checkpoint_latest_and_prune(tmp_path):
    t = _tree()
    for s in (1, 5, 9, 12):
        store.save(str(tmp_path), s, t)
    assert store.latest_step(str(tmp_path)) == 12
    store.prune(str(tmp_path), keep=2)
    assert store.latest_step(str(tmp_path)) == 12
    assert sorted(int(d[5:]) for d in os.listdir(tmp_path)
                  if d.startswith("step_")) == [9, 12]


def test_checkpoint_atomic_no_partial_visible(tmp_path):
    """A stale .tmp dir (simulated crash) must be invisible to latest_step."""
    os.makedirs(tmp_path / "step_00000099.tmp")
    assert store.latest_step(str(tmp_path)) is None
    store.save(str(tmp_path), 1, _tree())
    assert store.latest_step(str(tmp_path)) == 1


def test_checkpoint_corruption_detected_and_quarantined(tmp_path):
    t = _tree()
    store.save(str(tmp_path), 1, t)
    d = store.save(str(tmp_path), 2, t)
    fn = os.path.join(d, "leaf_00000.npy")   # the "a" leaf
    arr = np.load(fn)
    arr.flat[0] += 1.0
    np.save(fn, arr)
    with pytest.raises(AssertionError, match="corrupt"):
        store.restore(str(tmp_path), t)
    tree, _, step = store.restore_latest_valid(str(tmp_path), t)
    assert step == 1
    _assert_tree_equal(t, tree)
    assert store.latest_step(str(tmp_path)) == 1
    assert os.path.isdir(tmp_path / "quarantine" / "step_00000002")


def test_async_checkpointer(tmp_path):
    ck = store.AsyncCheckpointer(str(tmp_path), keep=2)
    t = _tree()
    for s in (10, 20):
        live = {"a": t["a"] + s}
        ck.save(s, live)
        live["a"].add_(100.0)      # the snapshot must not see this
    ck.wait()
    restored, _ = store.restore(str(tmp_path), {"a": t["a"]}, 20)
    np.testing.assert_array_equal(restored["a"].numpy(),
                                  (t["a"] + 20).numpy())
    assert store.latest_step(str(tmp_path)) == 20


# ---------------------------------------------------------------------------
# Straggler monitor (mirrors tests/test_substrates.py)
# ---------------------------------------------------------------------------


def test_straggler_flags_slow_host():
    m = StragglerMonitor(n_hosts=8, predicted_step_s=0.1, k=2.0, ewma=0.0)
    evs = m.observe(0, [0.1] * 7 + [0.5])
    assert len(evs) == 1 and evs[0].host == 7
    assert m.healthy_mask().sum() == 7
    assert m.rescale_weight() == pytest.approx(8 / 7)


def test_straggler_no_false_positives():
    m = StragglerMonitor(n_hosts=4, predicted_step_s=0.1, k=2.0)
    for s in range(5):
        assert m.observe(s, [0.1, 0.11, 0.09, 0.12]) == []


def test_straggler_ewma_recovers_and_reanchors():
    m = StragglerMonitor(n_hosts=4, predicted_step_s=0.1, k=2.0, ewma=0.5)
    m.observe(0, [0.1, 0.1, 0.1, 1.0])
    assert not m.healthy_mask()[3]
    for s in range(1, 10):
        m.observe(s, [0.1, 0.1, 0.1, 0.1])
    assert m.healthy_mask().all()
    m.reanchor(0.5)
    assert m.threshold() == pytest.approx(1.0)


def test_straggler_from_model_waits_for_the_predictor():
    """The predictor is ported: ``from_model`` takes its threshold from the
    batched plan scoring (``tests/test_torch_planspace.py`` holds it to the
    reference's)."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.core import predictor
    cfg, shape = TARCHS["llama3.2-3b"], SHAPES["train_4k"]
    plan = tplan.Plan(dp_axes=("data",))
    m = StragglerMonitor.from_model(cfg, shape, plan, {"data": 1}, 1)
    want = predictor.predict_plans(cfg, shape, [plan], {"data": 1})
    assert m.predicted_step_s == float(want[0]) > 0
    assert m.n_hosts == 1
