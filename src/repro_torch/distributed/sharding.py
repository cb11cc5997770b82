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

``logical`` and ``constrain_like_params`` act on DTensors, the port's
counterpart of ``with_sharding_constraint``: a DTensor is redistributed to
the placements its logical axes resolve to; a plain tensor passes through
unchanged, in a context or outside one.  ``distribute_params`` turns a
model's parameters into DTensors by the same rules.
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

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
        others and for an axis of one rank (a shard of one is the whole:
        the same layout, which DTensor then never has to reshape).  Where
        one dim names several mesh axes, their shards nest in the order
        named, which the mesh's axis order must follow."""
        out = [Replicate()] * len(self.mesh.mesh_dim_names)
        for d, entry in enumerate(spec):
            if entry is None:
                continue
            for ax in (entry,) if isinstance(entry, str) else entry:
                if self.axis_sizes[ax] > 1:
                    out[self.mesh.mesh_dim_names.index(ax)] = Shard(d)
        return tuple(out)


def current() -> Optional[ShardingCtx]:
    return getattr(_tls, "ctx", None)


@contextmanager
def use_sharding(mesh, plan: Plan):
    with in_context(ShardingCtx(mesh, plan)) as ctx:
        yield ctx


@contextmanager
def in_context(ctx: Optional[ShardingCtx]):
    """Make ``ctx`` (or no context) current on this thread."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    try:
        yield ctx
    finally:
        _tls.ctx = prev


def snapshot() -> tuple:
    """This thread's sharding state: the context, and whether DTensor takes
    plain tensors as replicated (``implicit_replication``, a flag of this
    thread in some PyTorch versions)."""
    return current(), bool(DTensor._op_dispatcher._allow_implicit_replication)


@contextmanager
def restored(state: tuple):
    """Run the block in a ``snapshot``'s state: a recompute in the
    backward, which autograd runs on a thread of its own for CUDA tensors,
    re-enters its forward's state so.  Each piece is set back on exit."""
    ctx, implicit = state
    dispatcher = DTensor._op_dispatcher
    prev = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = implicit
    try:
        with in_context(ctx):
            yield
    finally:
        dispatcher._allow_implicit_replication = prev


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def logical(x: torch.Tensor, names: Sequence[Optional[str]]) -> torch.Tensor:
    """Annotate an activation with logical axis names: a DTensor in a
    context is redistributed to the placements the names resolve to (the
    reference's ``with_sharding_constraint``); a plain tensor, or any tensor
    outside a context, is returned as it is."""
    ctx = current()
    if ctx is None or not is_dtensor(x):
        return x
    return x.redistribute(ctx.mesh, ctx.placements(ctx.act_spec(names,
                                                                x.shape)))


# ---------------------------------------------------------------------------
# Parameter sharding trees
# ---------------------------------------------------------------------------


def is_axes_leaf(x) -> bool:
    """A logical-axes leaf is a plain tuple of axis names (str | None) —
    NamedTuples (KVCache, SSMState, …) are containers, not leaves."""
    return (isinstance(x, tuple) and not hasattr(x, "_fields")
            and all(e is None or isinstance(e, str) for e in x))


def map_axes(fn, axes_tree, other):
    """``fn(axes, leaf)`` over an axes tree and a tree of the same
    structure (dicts and NamedTuples of leaves)."""
    if is_axes_leaf(axes_tree):
        return fn(axes_tree, other)
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, v, other[k]) for k, v in axes_tree.items()}
    return type(axes_tree)(*(map_axes(fn, a, o)
                             for a, o in zip(axes_tree, other)))


def param_shardings(mesh, plan: Plan, axes_tree, shapes_tree):
    """A tree of DTensor placements for a parameter tree given its
    logical-axes tree; a leaf of ``shapes_tree`` is a shape or anything
    with ``.shape``."""
    ctx = ShardingCtx(mesh, plan)

    def one(axes, shp):
        shape = shp.shape if hasattr(shp, "shape") else shp
        return ctx.placements(ctx.param_spec(axes, shape))

    return map_axes(one, axes_tree, shapes_tree)


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


def replicate_dims(x: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """A DTensor with its shards along ``dims`` gathered (each mesh axis
    that shards one of them made ``Replicate``), the others kept: FSDP's
    all-gather of a weight before an op that DTensor cannot propagate
    through its sharded layout.  A plain tensor is returned as it is."""
    if not is_dtensor(x):
        return x
    dims = {d % x.ndim for d in dims}
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim in dims else p
               for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(
        x.device_mesh, pl)


def axis_index(axis: Optional[str]) -> Tuple[int, int]:
    """(this rank's coordinate, size) of mesh ``axis`` in the current
    context; (0, 1) for no context, no axis or an axis the mesh lacks."""
    ctx = current()
    if ctx is None or axis is None or axis not in ctx.axis_sizes:
        return 0, 1
    return ctx.mesh.get_local_rank(axis), ctx.axis_sizes[axis]


def is_sharded_on(placements, axis: Optional[str], dim: int) -> bool:
    """Does mesh ``axis`` shard dimension ``dim`` in ``placements``?"""
    ctx = current()
    if ctx is None or axis is None or axis not in ctx.axis_sizes:
        return False
    p = placements[ctx.mesh.mesh_dim_names.index(axis)]
    return isinstance(p, Shard) and p.dim == dim


def partial_on(placements, axis: str) -> tuple:
    """``placements`` with mesh ``axis`` (of the current context) made
    ``Partial``: the gradient of an input that each rank of ``axis`` reads
    whole but uses only in part."""
    i = current().mesh.mesh_dim_names.index(axis)
    return tuple(placements[:i]) + (Partial(),) + tuple(placements[i + 1:])


def partial_over_rows(placements, rows) -> tuple:
    """``placements`` made ``Partial`` on each mesh axis that splits dim 0
    of ``rows`` (the placements of the batch an input meets): the
    gradient of an input with no batch dim (a weight used inside
    ``local_map``) is a partial sum over the ranks that split the batch."""
    return tuple(Partial() if isinstance(r, Shard) and r.dim == 0 else p
                 for p, r in zip(placements, rows))


def groups_of_local_heads(t: torch.Tensor, dim: int, n_heads: int,
                          rank: int, n_ranks: int) -> torch.Tensor:
    """The groups of ``t`` (whole along ``dim``: one entry per group of
    ``n_heads // t.shape[dim]`` heads) that rank ``rank`` of ``n_ranks``
    reads, when the heads are split evenly over the ranks and the groups
    are not (GQA's kv heads, the SSD's B/C groups, on a model axis they do
    not divide).  Where this rank's heads fill whole groups, or lie inside
    one, it is those groups; otherwise each head gets its group's copy."""
    per_group = n_heads // t.shape[dim]
    local = n_heads // n_ranks
    first, last = rank * local // per_group, ((rank + 1) * local - 1) \
        // per_group
    if local % per_group == 0 or per_group % local == 0:
        return t.narrow(dim, first, last - first + 1)
    return t.repeat_interleave(per_group, dim).narrow(dim, rank * local,
                                                      local)


def write_rows(cache: torch.Tensor, start: int,
               rows: torch.Tensor) -> None:
    """``cache[:, start:start + n] = rows`` IN PLACE (n = ``rows.shape[1]``).
    On a DTensor cache each rank writes the part of the rows that falls in
    its own shard of dim 1 (a sequence sharded over ``act_seq_dp``), from
    ``rows`` laid out as the cache is on the other dims."""
    if not is_dtensor(cache):
        cache[:, start:start + rows.shape[1]] = rows
        return
    mesh = cache.device_mesh
    # the rows travel whole along the sequence, as the cache lies otherwise
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p
               for p in cache.placements)
    shape, offset = local_shape_and_offset(cache.shape, mesh,
                                           cache.placements)
    lo = max(start, offset[1])
    hi = min(start + rows.shape[1], offset[1] + shape[1])
    with torch.no_grad():  # a cache is state, never differentiated
        src = rows.redistribute(mesh, pl).to_local() \
            if is_dtensor(rows) else rows
        if lo < hi:
            cache.to_local()[:, lo - offset[1]:hi - offset[1]] = \
                src[:, lo - start:hi - start]


def _ranks_on(x: torch.Tensor, dim: int) -> int:
    """How many ranks split dim ``dim`` of the DTensor ``x``."""
    ranks = 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim % x.ndim == dim % x.ndim:
            ranks *= x.device_mesh.size(i)
    return ranks


class _GradInLayout(torch.autograd.Function):
    """The identity, whose backward lays the gradient out as the forward
    value was laid out."""

    @staticmethod
    def forward(ctx, x):
        ctx.layout = (x.device_mesh, tuple(x.placements))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, pl = ctx.layout
        # the gradient of a partial sum is the same on every rank
        pl = tuple(Replicate() if isinstance(p, Partial) else p for p in pl)
        return g if tuple(g.placements) == pl else g.redistribute(mesh, pl)


def grad_in_layout(x: torch.Tensor) -> torch.Tensor:
    """``x``, whose gradient comes back laid out as ``x`` is: an op that
    folds dims (a projection's (B·S, d) view) then meets its gradient in
    the layout its forward folded, not in whatever layout the ops after it
    left (a residual add hands the gradient over in its own output's
    layout, say with the sequence split), which DTensor cannot fold in
    every version.  A plain tensor is returned as it is."""
    return _GradInLayout.apply(x) if is_dtensor(x) else x


def merge_last(x: torch.Tensor) -> torch.Tensor:
    """x (..., n, d) -> (..., n * d) (heads merged).  On a DTensor the
    gradient comes back laid out as the merged value is (whole heads),
    since DTensor cannot split the flat dim of a gradient sharded over more
    ranks than divide ``n`` back into heads."""
    return grad_in_layout(x.reshape(*x.shape[:-2],
                                    x.shape[-2] * x.shape[-1]))


def split_dim(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """x with dim ``dim`` split into (n, x.shape[dim] // n) (heads of
    lanes, kv heads of groups).  A DTensor whose ``dim`` is split over
    more ranks than divide ``n`` is gathered there first: DTensor cannot
    cut a head (a group) between ranks, where GSPMD pads
    (``ShardingCtx._resolve`` checks the flat width, which a head count
    such as 15 on 16 ranks passes)."""
    dim %= x.ndim
    if is_dtensor(x) and n % _ranks_on(x, dim):
        x = replicate_dims(x, (dim,))
    return x.reshape(*x.shape[:dim], n, x.shape[dim] // n,
                     *x.shape[dim + 1:])


def split_last(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """x (..., n * d) -> (..., n, d): ``split_dim`` of the last dim."""
    return split_dim(x, -1, n)


def constrain_like_params(tree, axes_tree):
    """Pin a param-shaped tree (the gradients, the f32 accumulator of the
    microbatch loop) to the parameter sharding rules.  Each DTensor leaf is
    redistributed to its parameter's placements, which is where a
    gradient's ``Partial`` placements resolve: a reduce-scatter into the
    sharded layout under FSDP, an all-reduce for a replicated parameter.
    Plain tensors, and any tree outside a context, pass through."""
    ctx = current()
    if ctx is None:
        return tree

    def one(axes, x):
        if not is_dtensor(x):
            return x
        return x.redistribute(ctx.mesh, ctx.placements(
            ctx.param_spec(axes, x.shape)))

    return map_axes(one, axes_tree, tree)


def local_shape_and_offset(shape, mesh, placements):
    """(this rank's shard shape, its offset in the whole) for a tensor of
    ``shape`` laid out by ``placements`` on ``mesh``.  The rules shard a
    dim only over mesh axes that divide it (``ShardingCtx._resolve``), so
    every shard of a dim is the same size; shards of one dim nest in mesh
    axis order.  Host arithmetic only, so it holds on fake tensors too."""
    shape, offset = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(i)
            if shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {shape} does not split "
                                 f"evenly over {n} ranks")
            shape[p.dim] //= n
            offset[p.dim] += coord[i] * shape[p.dim]
    return tuple(shape), tuple(offset)


def distribute_tensor_as(t: torch.Tensor, mesh, placements,
                         make_local=None):
    """``t`` as a DTensor of ``placements``.  Without ``make_local`` ``t``
    is the whole tensor and each rank keeps its own shard of it, with no
    communication (every rank holds the same values).  With it, ``t`` only
    gives the global shape and type (a meta tensor) and this rank's shard
    is ``make_local(local shape, dtype)``: the dry run's fake tensors,
    nothing the size of the whole tensor ever allocated."""
    from torch.distributed.tensor import distribute_tensor
    if make_local is None:
        return distribute_tensor(t, mesh, placements, src_data_rank=None)
    shape = local_shape_and_offset(t.shape, mesh, placements)[0]
    return DTensor.from_local(make_local(shape, t.dtype), mesh,
                              placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def distribute_params(model: torch.nn.Module, mesh, placements,
                      make_local=None) -> torch.nn.Module:
    """Turn every parameter of ``model`` into a DTensor, IN PLACE, at its
    entry of ``placements`` (by ``state_dict`` name; ``param_shardings`` of
    the port's ``transformer.param_axes``, the ``(out, in)`` layout), with
    the idiom of ``torch.distributed.tensor.distribute_module`` and a
    partition function.  Each parameter is replaced by its shard one
    tensor at a time; with ``make_local`` (see ``distribute_tensor_as``)
    the model may live on ``meta`` and no whole parameter is made."""
    from torch.distributed.tensor import distribute_module

    def partition(name, module, device_mesh):
        for leaf, p in list(module.named_parameters(recurse=False)):
            dt = distribute_tensor_as(p.detach(), device_mesh,
                                      placements[f"{name}.{leaf}".lstrip(".")],
                                      make_local)
            module.register_parameter(
                leaf, torch.nn.Parameter(dt, requires_grad=p.requires_grad))

    return distribute_module(model, mesh, partition)
