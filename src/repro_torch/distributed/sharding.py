"""Logical-axis sharding rules (MaxText-style), as in the reference.

Models annotate activations with *logical* axis names (``logical``);
parameters carry logical axes in a parallel ``axes`` tree
(``transformer.param_axes``).  A thread-local ``ShardingCtx`` (mesh + Plan
rules) resolves names to mesh axes: a tuple with one entry per dimension,
``None`` or a mesh axis or a tuple of mesh axes, which is the reference's
``PartitionSpec``; ``placements`` turns it into DTensor placements.  The
context reads only the mesh's axis names and sizes (``mesh_dim_names``,
``shape``), so a stand-in with those two attributes serves where no process
group exists.

``logical`` and ``constrain_like_params`` stay identities: on plain tensors
the port has nothing to constrain (their DTensor form comes with the
GSPMD-style steps).
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.distributed.plan import Plan

Spec = Tuple[Any, ...]

_tls = threading.local()


class ShardingCtx:
    def __init__(self, mesh, plan: Plan):
        self.mesh = mesh
        self.plan = plan
        self.axis_sizes: Dict[str, int] = dict(zip(mesh.mesh_dim_names,
                                                   mesh.shape))

    # ------------------------------------------------------------------
    def _resolve(self, rule_value, dim: int) -> Optional[Tuple[str, ...]]:
        """Mesh axes for one dim, dropping axes that don't divide it or
        don't exist in this mesh."""
        if rule_value is None:
            return None
        axes = (rule_value,) if isinstance(rule_value, str) \
            else tuple(rule_value)
        out = []
        size = 1
        for ax in axes:
            if ax not in self.axis_sizes:
                continue
            s = self.axis_sizes[ax]
            if dim % (size * s) == 0:
                out.append(ax)
                size *= s
        return tuple(out) or None

    def spec(self, logical_axes: Sequence[Optional[str]],
             shape: Sequence[int], rules: dict) -> Spec:
        parts, used = [], set()
        for name, dim in zip(logical_axes, shape):
            r = self._resolve(rules.get(name), dim) if name else None
            # an axis may be used at most once per spec
            if r:
                r = tuple(ax for ax in r if ax not in used)
            if r:
                used.update(r)
                parts.append(r if len(r) > 1 else r[0])
            else:
                parts.append(None)
        return tuple(parts)

    def param_spec(self, logical_axes, shape) -> Spec:
        return self.spec(logical_axes, shape, self.plan.param_rules())

    def act_spec(self, logical_axes, shape) -> Spec:
        return self.spec(logical_axes, shape, self.plan.act_rules())

    def placements(self, spec: Spec) -> tuple:
        """DTensor placements of ``spec`` on this mesh: one per mesh axis,
        ``Shard(d)`` for the axes dim ``d`` names, ``Replicate()`` for the
        others.  Where one dim names several mesh axes, their shards nest in
        the order named, which the mesh's axis order must follow."""
        from torch.distributed.tensor import Replicate, Shard
        out = [Replicate()] * len(self.mesh.mesh_dim_names)
        for d, entry in enumerate(spec):
            if entry is None:
                continue
            for ax in (entry,) if isinstance(entry, str) else entry:
                out[self.mesh.mesh_dim_names.index(ax)] = Shard(d)
        return tuple(out)


def current() -> Optional[ShardingCtx]:
    return getattr(_tls, "ctx", None)


@contextmanager
def use_sharding(mesh, plan: Plan):
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ShardingCtx(mesh, plan)
    try:
        yield _tls.ctx
    finally:
        _tls.ctx = prev


def logical(x: torch.Tensor, names: Sequence[Optional[str]]) -> torch.Tensor:
    """Annotate an activation with logical axis names: the identity on a
    plain tensor, in a context or outside one."""
    return x


# ---------------------------------------------------------------------------
# Parameter sharding trees
# ---------------------------------------------------------------------------


def is_axes_leaf(x) -> bool:
    """A logical-axes leaf is a plain tuple of axis names (str | None) —
    NamedTuples (KVCache, SSMState, …) are containers, not leaves."""
    return (isinstance(x, tuple) and not hasattr(x, "_fields")
            and all(e is None or isinstance(e, str) for e in x))


def _map_axes(fn, axes_tree, other):
    """``fn(axes, leaf)`` over an axes tree and a tree of the same
    structure (dicts and NamedTuples of leaves)."""
    if is_axes_leaf(axes_tree):
        return fn(axes_tree, other)
    if isinstance(axes_tree, dict):
        return {k: _map_axes(fn, v, other[k]) for k, v in axes_tree.items()}
    return type(axes_tree)(*(_map_axes(fn, a, o)
                             for a, o in zip(axes_tree, other)))


def param_shardings(mesh, plan: Plan, axes_tree, shapes_tree):
    """A tree of DTensor placements for a parameter tree given its
    logical-axes tree; a leaf of ``shapes_tree`` is a shape or anything
    with ``.shape``."""
    ctx = ShardingCtx(mesh, plan)

    def one(axes, shp):
        shape = shp.shape if hasattr(shp, "shape") else shp
        return ctx.placements(ctx.param_spec(axes, shape))

    return _map_axes(one, axes_tree, shapes_tree)


def tree_bytes(shapes_tree) -> int:
    """Bytes of every tensor (meta tensors included) in a tree."""
    from torch.utils import _pytree as pytree
    return sum(math.prod(t.shape) * t.dtype.itemsize
               for t in pytree.tree_leaves(shapes_tree))


def context_parallel_factor(n_heads: int, seq_len: int,
                            min_slice: int = 1024) -> int:
    """How many ways to split the q-sequence for attention (context
    parallelism).  Used when the head dim cannot occupy the model axis
    (n_heads % tp != 0): slicing the q range over the same axis recovers
    the tp-fold division of attention compute (k/v stay replicated; the
    causal diagonal makes slices unequal work)."""
    ctx = current()
    if ctx is None or ctx.plan.tp_axis is None:
        return 1
    tp = ctx.axis_sizes.get(ctx.plan.tp_axis, 1)
    if tp <= 1 or n_heads % tp == 0:
        return 1  # head sharding already uses the axis fully
    if seq_len % (tp * min_slice) != 0:
        return 1
    return tp


def constrain_like_params(tree, axes_tree):
    """Pin a param-shaped tree to the parameter sharding rules: the
    identity on plain tensors."""
    return tree
