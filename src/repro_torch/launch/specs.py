"""Input specs and placement trees for every (arch × shape) cell: the dry
run's stand-ins, and what a sharded step distributes its arguments by.

``step_and_specs`` returns what the reference's returns for
``jax.jit(fn, in_shardings=…).lower(*specs)``, in the port's terms:

  * a spec is a ``meta`` tensor (``jax.ShapeDtypeStruct``'s counterpart: a
    shape and a type, nothing allocated); the step count, the decode
    position and the optimizer's count are host integers, as the port's
    steps keep them;
  * a sharding is a tuple of DTensor placements, one per mesh axis
    (``ShardingCtx.placements`` of the reference's ``PartitionSpec``), or
    ``None`` for a host value;
  * the parameters' spec is the model on ``meta`` (``param_specs``), their
    sharding a dict of placements by ``state_dict`` name: ``shard_args``
    turns a model's parameters into DTensors by it.

``sharded(step_fn, mesh, plan, in_shardings, out_shardings)`` is the
counterpart of ``jax.jit(fn, in_shardings=, out_shardings=)``: it lays the
arguments out by ``in_shardings`` and runs ``step_fn`` as a DTensor program
under the plan's sharding context, where ``sharding.logical`` redistributes
activations and the kernels run on each rank's shard (``local_map``).

  * train_4k      → train_step(TrainState, batch)
  * prefill_32k   → prefill_step(model, batch)
  * decode_32k / long_500k → serve_step(model, state, tokens, generator)
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import workload as wl
from repro_torch.distributed import sharding
from repro_torch.distributed.plan import Plan
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.models import layers, transformer
from repro_torch.optim import optimizers as opt
from repro_torch.runtime import steps


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# Batch specs
# ---------------------------------------------------------------------------


def batch_specs(cfg: ArchConfig, B: int, S: int) -> Dict[str, Any]:
    tok = (B, S, cfg.n_input_codebooks) if cfg.n_input_codebooks > 1 \
        else (B, S)
    out = {"tokens": _spec(tok, torch.int32),
           "labels": _spec(tok, torch.int32)}
    if cfg.vision_tokens:
        out["vision_embeds"] = _spec((B, cfg.vision_tokens, cfg.d_model),
                                     layers.to_dtype(cfg.param_dtype))
        out["loss_mask"] = _spec((B, S), torch.float32)
    return out


def batch_axes(cfg: ArchConfig) -> Dict[str, Any]:
    tok = ("act_batch", None, None) if cfg.n_input_codebooks > 1 \
        else ("act_batch", None)
    out = {"tokens": tok, "labels": tok}
    if cfg.vision_tokens:
        out["vision_embeds"] = ("act_batch", None, None)
        out["loss_mask"] = ("act_batch", None)
    return out


def param_specs(cfg: ArchConfig) -> transformer.Transformer:
    """The model on ``meta``: its parameters are the specs of the
    reference's parameter tree (shapes and types, nothing allocated), in
    the port's layout (one entry per layer, dense weights ``(out, in)``)."""
    return transformer.Transformer(cfg, torch.device("meta"), None)


# ---------------------------------------------------------------------------
# Placement trees
# ---------------------------------------------------------------------------


def _tree_shardings(mesh, plan: Plan, axes_tree, shapes_tree, kind: str):
    """Placements of every tensor leaf of ``shapes_tree`` by its logical
    axes (the parameter rules, or the activation rules for ``"act"``);
    ``None`` for a host value."""
    ctx = ShardingCtx(mesh, plan)
    fn = ctx.param_spec if kind == "param" else ctx.act_spec

    def one(axes, shp):
        if not isinstance(shp, torch.Tensor):
            return None
        return ctx.placements(fn(axes, shp.shape))

    return sharding.map_axes(one, axes_tree, shapes_tree)


def _scalar(mesh) -> tuple:
    return ShardingCtx(mesh, Plan()).placements(())


# ---------------------------------------------------------------------------
# Per-phase assembly — one helper, three thin wrappers
# ---------------------------------------------------------------------------


def phase_cell(cfg: ArchConfig, workload: wl.WorkloadLike, mesh,
               plan: Plan):
    """-> (step_fn, arg_specs tuple, in_shardings tuple, out_shardings)
    for any workload phase.

    The parameter shapes / axes / placements are computed once here; the
    phase then decides what travels next to the parameters: the
    optimizer-carrying ``TrainState`` (train), a token batch (prefill), or
    the decode caches and the sampled-token inputs (decode).

    For train cells ``out_shardings`` pins the new ``TrainState`` to the
    input layout, as the reference's does: the optimizer updates the
    DTensor parameters and state in place, so the layout holds as long as
    the gradients are pinned to it (``steps.make_train_step``'s
    ``_pin_grads``); without that they stay ``Partial`` and the update
    would materialise replicated f32 gradients.  The metrics come out
    replicated."""
    spec = wl.as_spec(workload)
    B, S = spec.global_batch, spec.seq_len
    p_shapes = param_specs(cfg)
    p_named = dict(p_shapes.named_parameters())
    p_axes = transformer.param_axes(cfg, p_named)
    p_sh = _tree_shardings(mesh, plan, p_axes, p_named, "param")

    if spec.phase == "train":
        optimizer = opt.get_optimizer(cfg.optimizer)
        step_fn = steps.make_step(cfg, spec, plan, optimizer=optimizer)
        o_shapes = optimizer.init(p_named)
        o_axes = opt.opt_state_axes(cfg.optimizer, p_axes)
        state_specs = steps.TrainState(params=p_shapes, opt_state=o_shapes,
                                       step=0)
        state_sh = steps.TrainState(
            params=p_sh,
            opt_state=_tree_shardings(mesh, plan, o_axes, o_shapes, "param"),
            step=None)
        b_specs = batch_specs(cfg, B, S)
        b_sh = _tree_shardings(mesh, plan, batch_axes(cfg), b_specs, "act")
        metrics_sh = {"loss": _scalar(mesh), "grad_norm": _scalar(mesh),
                      "lr": None}
        return (step_fn, (state_specs, b_specs), (state_sh, b_sh),
                (state_sh, metrics_sh))

    if spec.phase == "prefill":
        step_fn = steps.make_step(cfg, spec, plan)
        b_specs = batch_specs(cfg, B, S)
        b_sh = _tree_shardings(mesh, plan, batch_axes(cfg), b_specs, "act")
        return step_fn, (p_shapes, b_specs), (p_sh, b_sh), None

    step_fn = steps.make_step(cfg, spec, plan, sample=True)
    s_shapes = transformer.init_decode_state(cfg, B, S, device="meta")
    s_axes = transformer.decode_state_axes(cfg)
    s_sh = _tree_shardings(mesh, plan, s_axes, s_shapes, "act")
    tok = (B, 1, cfg.n_input_codebooks) if cfg.n_input_codebooks > 1 \
        else (B, 1)
    tok_specs = _spec(tok, torch.int32)
    tok_sh = ShardingCtx(mesh, plan).placements(
        ShardingCtx(mesh, plan).act_spec(
            ("act_batch",) + (None,) * (len(tok) - 1), tok))
    # the reference's rng key is the port's generator: a host object that
    # every rank seeds alike, so every rank samples the same token
    return (step_fn, (p_shapes, s_shapes, tok_specs, None),
            (p_sh, s_sh, tok_sh, None),
            None)  # outputs inferred (next-token rank varies per family)


def train_cell(cfg: ArchConfig, shape, mesh, plan: Plan):
    return phase_cell(cfg, wl.as_spec(shape).with_(phase="train"), mesh,
                      plan)


def prefill_cell(cfg: ArchConfig, shape, mesh, plan: Plan):
    return phase_cell(cfg, wl.as_spec(shape).with_(phase="prefill"), mesh,
                      plan)


def decode_cell(cfg: ArchConfig, shape, mesh, plan: Plan):
    return phase_cell(cfg, wl.as_spec(shape).with_(phase="decode"), mesh,
                      plan)


def step_and_specs(cfg: ArchConfig, workload: wl.WorkloadLike, mesh,
                   plan: Plan):
    return phase_cell(cfg, workload, mesh, plan)


# ---------------------------------------------------------------------------
# Laying arguments out, and running a step as a DTensor program
# ---------------------------------------------------------------------------


def _is_placements(x) -> bool:
    from torch.distributed.tensor import Placement
    return isinstance(x, tuple) and len(x) > 0 and all(
        isinstance(p, Placement) for p in x)


def shard_args(args, shardings, mesh, make_local=None):
    """``args`` laid out by ``shardings`` (a tree of the same structure):
    a tensor becomes a DTensor of its placements (a DTensor already laid
    out otherwise is redistributed), a model's parameters become DTensors
    in place (``sharding.distribute_params``, by the ``state_dict`` names
    of its placements dict), a host value or a ``None`` sharding is kept.
    ``make_local`` as in ``sharding.distribute_tensor_as``: the dry run's
    shards of meta specs."""
    if shardings is None:
        return args
    if isinstance(args, torch.nn.Module):
        if not all(sharding.is_dtensor(p) for p in args.parameters()):
            sharding.distribute_params(args, mesh, shardings, make_local)
        return args
    if isinstance(args, torch.Tensor):
        if not _is_placements(shardings):
            raise TypeError(f"a tensor of shape {tuple(args.shape)} against "
                            f"the sharding {shardings!r}")
        if sharding.is_dtensor(args):
            return args if tuple(args.placements) == shardings \
                else args.redistribute(mesh, shardings)
        return sharding.distribute_tensor_as(args, mesh, shardings,
                                             make_local)
    if isinstance(args, dict):
        return {k: shard_args(v, shardings[k], mesh, make_local)
                for k, v in args.items()}
    if isinstance(args, tuple) and hasattr(args, "_fields"):
        return type(args)(*(shard_args(a, s, mesh, make_local)
                            for a, s in zip(args, shardings)))
    if isinstance(args, (tuple, list)):
        return type(args)(shard_args(a, s, mesh, make_local)
                          for a, s in zip(args, shardings))
    return args


def _lay_out(out, shardings, mesh):
    """A step's outputs redistributed to ``shardings`` (a model and host
    values are kept)."""
    if shardings is None or isinstance(out, torch.nn.Module):
        return out
    if isinstance(out, torch.Tensor):
        if sharding.is_dtensor(out) and tuple(out.placements) != shardings:
            return out.redistribute(mesh, shardings)
        return out
    if isinstance(out, dict):
        return {k: _lay_out(v, shardings.get(k), mesh)
                for k, v in out.items()}
    if isinstance(out, tuple) and hasattr(out, "_fields"):
        return type(out)(*(_lay_out(o, s, mesh)
                           for o, s in zip(out, shardings)))
    if isinstance(out, (tuple, list)):
        return type(out)(_lay_out(o, s, mesh) for o, s in zip(out, shardings))
    return out


def sharded(step_fn, mesh, plan: Plan, in_shardings,
            out_shardings: Optional[Any] = None):
    """``step_fn`` as a DTensor program, the counterpart of
    ``jax.jit(step_fn, in_shardings=, out_shardings=)``: its arguments are
    laid out by ``in_shardings`` (``shard_args``: a whole tensor is cut
    into each rank's shard with no communication, so every rank passes the
    same values), it runs under ``sharding.use_sharding(mesh, plan)`` with
    plain tensors taken as replicated (``implicit_replication``: positions,
    masks, constants), and its outputs are laid out by ``out_shardings``."""
    from torch.distributed.tensor.experimental import implicit_replication

    def run(*args):
        args = shard_args(args, in_shardings, mesh)
        with sharding.use_sharding(mesh, plan), implicit_replication():
            out = step_fn(*args)
            return _lay_out(out, out_shardings, mesh)

    return run



