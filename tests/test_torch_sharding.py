"""The port's sharding rules against the JAX package, on the CPU and in
process: the logical axes of the parameters (``transformer.param_axes``,
``convert.axes_from_reference``), of the optimizer state and of the decode
state; ``ShardingCtx``'s specs of every parameter and decode-state leaf on
the production and test meshes under three plans; the context-parallel
factor; the DTensor placements.

The reference's ``ShardingCtx`` reads only ``mesh.axis_names`` and
``mesh.devices.shape``, and the port's only ``mesh.mesh_dim_names`` and
``mesh.shape``, so both get stand-ins of the meshes: no device and no
process group is needed.  A reference spec (a ``PartitionSpec``, a tuple per
dimension of the layer-stacked ``(in, out)`` layout) goes through
``axes_from_reference`` to the port's layout before the comparison; every
comparison is exact.
"""
from __future__ import annotations

import types
from functools import lru_cache

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.registry import ARCHS as JARCHS
from repro.distributed import plan as jplan
from repro.distributed import sharding as jsharding
from repro.models import transformer as jtransformer
from repro.optim import optimizers as jopt
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCHS
from repro_torch.distributed import plan as tplan
from repro_torch.distributed import sharding
from repro_torch.models import convert, transformer
from repro_torch.optim import optimizers as topt

torch.set_num_threads(1)

#: the archs both registries hold (the port's also has Nemotron)
NAMES = sorted(JARCHS)
#: (shape, axis names): the reference's test meshes and production meshes
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "1x8": ((1, 8), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
PLANS = ("plan_for", "no_fsdp", "ep")


def _meshes(key):
    shape, names = MESHES[key]
    ref = types.SimpleNamespace(axis_names=names,
                                devices=np.empty(shape, dtype=object))
    port = types.SimpleNamespace(mesh_dim_names=names, shape=shape)
    return ref, port


def _plans(cfg_j, cfg_t, mesh_key, kind):
    """The same plan in both packages: ``plan_for`` at the mesh's model
    width (train_4k), then without FSDP or with expert parallelism."""
    shape, names = MESHES[mesh_key]
    tp, pod = shape[-1], "pod" in names
    jp = jplan.plan_for(cfg_j, JSHAPES["train_4k"], tp_size=tp,
                        multi_pod=pod)
    tp_ = tplan.plan_for(cfg_t, SHAPES["train_4k"], tp_size=tp, multi_pod=pod)
    assert jp.__dict__ == tp_.__dict__
    edit = {"plan_for": {}, "no_fsdp": {"fsdp": False},
            "ep": {"moe_mode": "ep"}}[kind]
    return jp.with_(**edit), tp_.with_(**edit)


@lru_cache(maxsize=None)
def _reference(name):
    """The reference's axes and shapes of the full model (no allocation)."""
    cfg = JARCHS[name]
    return jtransformer.param_axes(cfg), jtransformer.param_shapes(cfg)


@lru_cache(maxsize=None)
def _port(name):
    cfg = ARCHS[name]
    return transformer.param_axes(cfg), transformer.param_shapes(cfg)


# ---------------------------------------------------------------------------
# logical axes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_param_axes_are_the_references_in_the_ports_layout(name):
    axes, shapes = _port(name)
    ref_axes, ref_shapes = _reference(name)
    assert axes == convert.axes_from_reference(ARCHS[name], ref_axes)
    assert list(axes) == list(shapes)
    for key, ax in axes.items():
        assert len(ax) == shapes[key].ndim, key
        assert shapes[key].device.type == "meta"
    # the shapes are the reference's in the port's layout too
    ref_dims = convert.axes_from_reference(
        ARCHS[name], jax.tree.map(lambda s: tuple(s.shape), ref_shapes))
    assert {k: tuple(v.shape) for k, v in shapes.items()} == ref_dims


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor", "sgd"])
@pytest.mark.parametrize("name", ["llama3.2-3b", "zamba2-2.7b",
                                  "mixtral-8x7b", "musicgen-medium"])
def test_opt_state_axes_mirror_the_optimizer_state(opt_name, name):
    """Every leaf of ``get_optimizer(name).init(params)`` has an axes tuple
    of its rank, inherited from its parameter as the reference's rule says;
    where the layouts agree (AdamW's and SGD's moments) the tree is the
    reference's in the port's layout."""
    cfg = ARCHS[name]
    p_axes, shapes = _port(name)
    axes = topt.opt_state_axes(opt_name, p_axes)
    state = topt.get_optimizer(opt_name).init(shapes)
    assert state.keys() == axes.keys() and axes["count"] == ()
    for part in [k for k in state if k != "count"]:
        assert state[part].keys() == axes[part].keys()
        for n, leaf in state[part].items():
            ax = axes[part][n]
            if isinstance(leaf, dict):        # adafactor's factored v
                assert leaf.keys() == ax.keys()
                for k, t in leaf.items():
                    assert len(ax[k]) == t.ndim, (n, k)
                if n not in p_axes:   # a stacked 1-D leaf, (L, d)
                    members = topt.stacked_groups(p_axes)[n]
                    assert len(members) == cfg.n_layers
                    assert ax == {"vr": ("layers",),
                                  "vc": p_axes[members[0]]}
                    assert len(p_axes[members[0]]) == 1
                elif "vr" in ax:
                    assert ax == {"vr": p_axes[n][:-1],
                                  "vc": p_axes[n][:-2] + p_axes[n][-1:]}
            else:
                assert ax == p_axes[n] and len(ax) == leaf.ndim
    if opt_name != "adafactor":
        ref = jopt.opt_state_axes(opt_name, _reference(name)[0])
        for part in [k for k in ref if k != "count"]:
            assert axes[part] == convert.axes_from_reference(cfg, ref[part])
    with pytest.raises(KeyError):
        topt.opt_state_axes("lion", p_axes)


@pytest.mark.parametrize("name", NAMES)
def test_decode_state_axes_mirror_the_decode_state(name):
    cfg = ARCHS[name]
    axes = transformer.decode_state_axes(cfg)
    ref = jtransformer.decode_state_axes(JARCHS[name])
    assert axes.keys() == ref.keys() and axes["pos"] == ()
    for k in axes:
        if k != "pos":
            assert tuple(axes[k]) == tuple(ref[k])
            assert axes[k]._fields == ref[k]._fields
    state = transformer.init_decode_state(cfg, 2, 64, device="meta")
    assert state.keys() == axes.keys()
    for k in ("kv", "ssm"):
        if k in state:
            for ax, t in zip(axes[k], state[k]):
                assert len(ax) == t.ndim
    assert not sharding.is_axes_leaf(axes.get("kv", axes.get("ssm")))


# ---------------------------------------------------------------------------
# specs on the meshes
# ---------------------------------------------------------------------------


def _decode_leaves(cfg, axes_tree, B, max_len):
    """(axes, shape) of every decode-state leaf."""
    state = transformer.init_decode_state(cfg, B, max_len, device="meta")
    return [(ax, tuple(t.shape)) for k in ("kv", "ssm") if k in state
            for ax, t in zip(axes_tree[k], state[k])]


#: activation annotations of the models (``logical`` calls) at a shape
def _activations(cfg, B, S):
    d = cfg.d_model
    if not cfg.n_heads:          # the ssm family has no attention
        return [(("act_batch", "act_seq", "act_embed"), (B, S, d))]
    H, KVH, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    return [(("act_batch", "act_seq", "act_embed"), (B, S, d)),
            (("act_batch", None, "act_heads", None), (B, S, H, dh)),
            (("act_batch", None, "act_kv_heads", None), (B, S, KVH, dh)),
            (("act_batch", "act_seq", "act_vocab"), (B, S, cfg.vocab_size)),
            (("act_batch", "act_cp", None, None, None), (B, 2, S // 2, H, dh))]


@pytest.mark.parametrize("kind", PLANS)
@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_specs_equal_the_references(name, mesh_key, kind):
    cfg_t, cfg_j = ARCHS[name], JARCHS[name]
    ref_mesh, mesh = _meshes(mesh_key)
    jp, tp = _plans(cfg_j, cfg_t, mesh_key, kind)
    jctx, ctx = jsharding.ShardingCtx(ref_mesh, jp), \
        sharding.ShardingCtx(mesh, tp)

    axes, shapes = _port(name)
    ref_axes, ref_shapes = _reference(name)
    ref_specs = jax.tree.map(lambda ax, s: tuple(jctx.param_spec(ax, s.shape)),
                             ref_axes, ref_shapes,
                             is_leaf=jsharding.is_axes_leaf)
    want = convert.axes_from_reference(cfg_t, ref_specs)
    got = {k: ctx.param_spec(axes[k], shapes[k].shape) for k in axes}
    assert got == want

    B, S, max_len = 256, 4096, 32768
    leaves = _decode_leaves(cfg_t, transformer.decode_state_axes(cfg_t), B,
                            max_len) + _activations(cfg_t, B, S)
    for ax, shape in leaves:
        assert ctx.act_spec(ax, shape) == tuple(jctx.act_spec(ax, shape)), \
            (ax, shape)


def test_placements_and_shardings_follow_the_specs():
    from torch.distributed.tensor import Replicate, Shard
    _, mesh = _meshes("2x16x16")
    plan = tplan.Plan()
    ctx = sharding.ShardingCtx(mesh, plan)
    assert ctx.placements((None, ("pod", "data"), "model")) == \
        (Shard(1), Shard(1), Shard(2))
    assert ctx.placements((None, None)) == (Replicate(),) * 3
    axes, shapes = _port("llama3.2-3b")
    tree = sharding.param_shardings(mesh, plan, axes, shapes)
    assert tree.keys() == axes.keys()
    for k in axes:
        assert tree[k] == ctx.placements(ctx.param_spec(axes[k],
                                                        shapes[k].shape))
    # a tree with NamedTuple containers: the decode state's
    dec = transformer.decode_state_axes(ARCHS["zamba2-2.7b"])
    state = transformer.init_decode_state(ARCHS["zamba2-2.7b"], 32, 128,
                                          device="meta")
    out = sharding.param_shardings(mesh, plan, {"kv": dec["kv"]},
                                   {"kv": state["kv"]})
    assert type(out["kv"]).__name__ == "KVCache"


def test_tree_bytes_counts_the_full_model_without_allocating():
    _, shapes = _port("llama3-405b")
    ref = jsharding.tree_bytes(_reference("llama3-405b")[1])
    assert sharding.tree_bytes(shapes) == ref
    assert ref == ARCHS["llama3-405b"].n_params() * 2


# ---------------------------------------------------------------------------
# context parallelism
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_key", list(MESHES) + [None])
def test_context_parallel_factor_reads_the_context(mesh_key):
    cases = [(h, s) for h in (3, 8, 24, 28, 32, 40, 56)
             for s in (1024, 2048, 4096, 16384, 32768)]
    if mesh_key is None:
        for h, s in cases:
            assert sharding.context_parallel_factor(h, s) == 1 \
                == jsharding.context_parallel_factor(h, s)
        return
    ref_mesh, mesh = _meshes(mesh_key)
    for plan in (tplan.Plan(), tplan.Plan(tp_axis=None)):
        jp = jplan.Plan(**plan.__dict__)
        with jsharding.use_sharding(ref_mesh, jp), \
                sharding.use_sharding(mesh, plan) as ctx:
            assert sharding.current() is ctx
            got = [sharding.context_parallel_factor(h, s) for h, s in cases]
            want = [jsharding.context_parallel_factor(h, s)
                    for h, s in cases]
        assert got == want
    assert sharding.current() is None
    tp = MESHES[mesh_key][0][-1]
    assert max(got) in (1, tp)
