"""``launch/specs.py`` against the reference's ``launch/specs.py``: for every
architecture × shape on the two production meshes, the specs of
``step_and_specs`` have the reference's shapes and types, and its
placements are the reference's ``PartitionSpec``s laid out on the mesh.

No process group is needed: both sides read only a mesh's axis names and
sizes, so a stand-in with those serves (the reference's ``NamedSharding``,
which wants a real mesh, is replaced by its spec for the comparison).  The
port's parameters are one entry per layer with dense weights ``(out, in)``;
the reference's are stacked along a leading layer axis with dense weights
``(in, out)``: ``models/convert``'s rules lay the reference's specs out as
the port's before they are compared.  Host values (the step, the decode
position, the optimizer's count) are integers in the port, 0-dim int32
arrays in the reference; the reference's rng key is the port's generator.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import pytest
import torch

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.registry import ARCHS as JARCHS
from repro.distributed.plan import plan_for as jplan_for
from repro.launch import specs as jspecs
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCHS
from repro_torch.distributed.plan import plan_for
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.launch import specs
from repro_torch.models import convert
from repro_torch.optim import optimizers as topt

torch.set_num_threads(1)

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


class _Mesh:
    """A mesh's axis names and sizes, as both packages read them."""

    def __init__(self, shape, names):
        self.shape = self.devices_shape = tuple(shape)
        self.mesh_dim_names = self.axis_names = tuple(names)
        self.devices = type("Devices", (), {"shape": tuple(shape),
                                            "size": 0})()


def _port_dtype(jdtype) -> torch.dtype:
    return {jnp.dtype("float32"): torch.float32,
            jnp.dtype("bfloat16"): torch.bfloat16,
            jnp.dtype("int32"): torch.int32}[jnp.dtype(jdtype)]


def _params_as_port(cfg, tree):
    """The reference's parameter tree of ShapeDtypeStructs -> the port's
    names: (shape, dtype) per entry."""
    def leaf(a, layer, f32):
        shape = tuple(a.shape) if layer is None else tuple(a.shape)[1:]
        return shape, _port_dtype(a.dtype)

    def flip(e):
        shape, dtype = e
        return shape[:-2] + (shape[-1], shape[-2]), dtype

    return convert._convert(cfg, tree, leaf, flip)


def _check_tensor(t, shape, dtype, placements, want_spec, ctx):
    assert tuple(t.shape) == tuple(shape)
    assert t.dtype == dtype
    assert placements == ctx.placements(tuple(want_spec))


def _check_params(cfg, t_params, t_sh, j_params, j_sh, ctx):
    want = _params_as_port(cfg, j_params)
    specs_ = convert.axes_from_reference(cfg, j_sh)
    named = dict(t_params.named_parameters())
    assert set(named) == set(want) == set(t_sh)
    for n, p in named.items():
        _check_tensor(p, *want[n], t_sh[n], specs_[n], ctx)


def _check_tree(t_tree, t_sh, j_tree, j_sh, ctx):
    """Trees of the same structure (batch, decode state): tensors against
    ShapeDtypeStructs, host integers against 0-dim int32 specs."""
    if isinstance(t_tree, dict):
        assert set(t_tree) == set(j_tree)
        for k in t_tree:
            _check_tree(t_tree[k], t_sh[k], j_tree[k], j_sh[k], ctx)
    elif isinstance(t_tree, tuple):
        assert type(t_tree).__name__ == type(j_tree).__name__
        for a, s, b, js in zip(t_tree, t_sh, j_tree, j_sh):
            _check_tree(a, s, b, js, ctx)
    elif isinstance(t_tree, torch.Tensor):
        _check_tensor(t_tree, j_tree.shape, _port_dtype(j_tree.dtype), t_sh,
                      j_sh, ctx)
    else:
        assert isinstance(t_tree, int) and t_sh is None
        assert j_tree.shape == () and jnp.dtype(j_tree.dtype) == jnp.int32
        assert tuple(j_sh) == ()


def _check_opt_state(cfg, name, t_state, t_sh, j_state, j_sh, ctx):
    assert t_state["count"] == 0 and t_sh["count"] is None
    assert tuple(j_sh["count"]) == ()
    if name in ("adamw", "sgd"):
        for k in ("m", "v") if name == "adamw" else ("m",):
            want = _params_as_port(cfg, j_state[k])
            specs_ = convert.axes_from_reference(cfg, j_sh[k])
            for n, t in t_state[k].items():
                shape, _ = want[n]
                _check_tensor(t, shape, torch.float32, t_sh[k][n],
                              specs_[n], ctx)
        return
    # Adafactor factors a weight's second moment into rows and columns:
    # the port's (out, in) weight has the reference's (in, out) rows as its
    # columns.  The reference's stacked 1-D parameters (norm scales) are
    # (L, d) there and factored over the layer axis; the port keeps that
    # moment under the group's key (``blocks.*.<rest>``), laid out as the
    # reference's whole (L,) and (d,) moments.
    def moments(key, whole=False):
        def leaf(ax, layer, f32):
            if ax is None:
                return None
            return tuple(ax) if layer is None or whole else tuple(ax)[1:]
        return convert._convert(cfg, jax_map(lambda d: d.get(key), j_sh["v"]),
                                leaf, lambda ax: ax)
    flipped = convert._convert(cfg, j_sh["v"], lambda ax, layer, f32: False,
                               lambda ax: True)
    rows, cols = moments("vc"), moments("vr")
    groups = topt.stacked_groups(flipped)
    compared = stacked = 0
    for n, t in t_state["v"].items():
        if n in groups and n not in flipped:     # a stacked 1-D leaf
            first = groups[n][0]
            for k in ("vr", "vc"):
                want = moments(k, whole=True)[first]
                assert t_sh["v"][n][k] == ctx.placements(tuple(want)[:1]), n
            stacked += 1
            continue
        if "vr" not in t or n not in rows or rows[n] is None:
            continue
        if not flipped[n]:   # the embedding: the same layout in both
            rows[n], cols[n] = cols[n], rows[n]
        assert t_sh["v"][n]["vr"] == ctx.placements(tuple(rows[n])[:1])
        assert t_sh["v"][n]["vc"] == ctx.placements(tuple(cols[n])[:1])
        compared += 1
    assert compared > 0 and stacked > 0


def jax_map(fn, tree):
    """``fn`` on each dict leaf holding the factored moments."""
    if isinstance(tree, dict) and ("vr" in tree or "v" in tree) and \
            not any(isinstance(v, dict) for v in tree.values()):
        return fn(tree)
    return {k: jax_map(fn, v) for k, v in tree.items()}


_PARAM_SPECS = functools.lru_cache(maxsize=None)(specs.param_specs)


@pytest.fixture
def ref_specs(monkeypatch):
    """The reference's ``step_and_specs`` with its ``NamedSharding``s
    replaced by their ``PartitionSpec``s (no real mesh needed).  The
    port's meta model of an architecture is built once for all its cells
    (no cell lays it out in place here)."""
    monkeypatch.setattr(jspecs, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(specs, "param_specs", _PARAM_SPECS)
    return jspecs.step_and_specs


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("shape_name", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_step_and_specs_match_the_reference(arch, shape_name, mesh_name,
                                            ref_specs):
    multi = mesh_name == "2x16x16"
    mesh = _Mesh(*MESHES[mesh_name])
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    shape, jshape = SHAPES[shape_name], JSHAPES[shape_name]
    plan = plan_for(cfg, shape, multi_pod=multi, hbm_budget=16e9)
    jplan = jplan_for(jcfg, jshape, multi_pod=multi)
    _, t_args, t_in, t_out = specs.step_and_specs(cfg, shape, mesh, plan)
    _, j_args, j_in, j_out = ref_specs(jcfg, jshape, mesh, jplan)
    ctx = ShardingCtx(mesh, plan)
    assert len(t_args) == len(j_args) and len(t_in) == len(j_in)
    if shape.kind == "train":
        (t_state, t_batch), (t_ssh, t_bsh) = t_args, t_in
        (j_state, j_batch), (j_ssh, j_bsh) = j_args, j_in
        _check_params(cfg, t_state.params, t_ssh.params, j_state.params,
                      j_ssh.params, ctx)
        _check_opt_state(cfg, cfg.optimizer, t_state.opt_state,
                         t_ssh.opt_state, j_state.opt_state, j_ssh.opt_state,
                         ctx)
        _check_tree(t_state.step, t_ssh.step, j_state.step, j_ssh.step, ctx)
        _check_tree(t_batch, t_bsh, j_batch, j_bsh, ctx)
        # the new state is pinned to the input layout; metrics replicated
        assert t_out[0] is t_in[0]
        assert set(t_out[1]) == set(j_out[1])
        for k in ("loss", "grad_norm"):
            assert t_out[1][k] == ctx.placements(tuple(j_out[1][k]))
    elif shape.kind == "prefill":
        _check_params(cfg, t_args[0], t_in[0], j_args[0], j_in[0], ctx)
        _check_tree(t_args[1], t_in[1], j_args[1], j_in[1], ctx)
        assert t_out is None and j_out is None
    else:
        _check_params(cfg, t_args[0], t_in[0], j_args[0], j_in[0], ctx)
        _check_tree(t_args[1], t_in[1], j_args[1], j_in[1], ctx)
        _check_tree(t_args[2], t_in[2], j_args[2], j_in[2], ctx)
        # the rng key's place: the generator, a host object
        assert t_args[3] is None and t_in[3] is None
        assert tuple(j_args[3].shape) == (2,) and tuple(j_in[3]) == ()
        assert t_out is None and j_out is None


def test_specs_allocate_nothing():
    """The specs are meta tensors: building llama3-405b's takes no
    memory."""
    mesh = _Mesh(*MESHES["16x16"])
    cfg = ARCHS["llama3-405b"]
    _, (state, batch), _, _ = specs.train_cell(
        cfg, SHAPES["train_4k"], mesh,
        plan_for(cfg, SHAPES["train_4k"], hbm_budget=16e9))
    tensors = list(state.params.parameters()) + list(batch.values())
    assert tensors and all(t.is_meta for t in tensors)
    assert sum(t.numel() for t in state.params.parameters()) \
        == cfg.n_params()
