"""Step functions: train_step / prefill_step / serve_step factories.

All run eagerly; prefill and serve without autograd.  The train step takes
the gradient of ``transformer.loss_fn`` with torch autograd, accumulates
microbatches in f32 when the plan asks for several (one microbatch's
activations live at a time), clips by the global norm and applies the
optimizer, which updates the parameters in place; its phases are the
spans ``train.forward`` and ``train.backward`` (one each a microbatch)
and ``train.optimizer`` (``obs/trace``).  The step never synchronizes,
so those spans time the host's issue of the work, not the device's.
``make_step`` picks one of the three from a ``core.workload.WorkloadSpec``.
``make_manual_dp_train_step`` is the data-parallel train step with its
gradient all-reduce written out in collectives, one process per rank.
The steps also run as DTensor programs (``launch/specs.sharded``): under a
sharding context the train step pins its gradients to the parameters'
layout, and the serve step samples from whole logits.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.plan import Plan
from repro_torch.models import transformer
from repro_torch.obs import trace as _obs_trace
from repro_torch.optim import optimizers as opt


class TrainState(NamedTuple):
    params: transformer.Transformer  # the model; its tensors update in place
    opt_state: Any
    step: int                        # host integer


def init_train_state(cfg: ArchConfig, generator: torch.Generator,
                     optimizer: opt.Optimizer, device="cuda") -> TrainState:
    """A model with random weights from ``generator`` (which lives on
    ``device``), the optimizer's zero state and step 0."""
    model = transformer.init_params(cfg, generator, device=device)
    return TrainState(model, optimizer.init(dict(model.named_parameters())),
                      0)


def state_tree(state: TrainState) -> Dict[str, Any]:
    """What a checkpoint holds: the parameters by name, the optimizer state
    and the step (the live tensors; ``checkpoint.store`` copies them)."""
    return {"params": dict(state.params.named_parameters()),
            "opt_state": state.opt_state, "step": state.step}


def trainable(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The parameters a training step differentiates and updates, by name:
    all but those held fixed (``requires_grad`` False, as a dropless
    MoE's correction bias, which steers the picks and gets no gradient).
    The optimizer state and a checkpoint keep every parameter."""
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def _microbatch(v: torch.Tensor, i: int, M: int) -> torch.Tensor:
    """The ``i``-th of ``M`` equal chunks of ``v``'s rows.  A DTensor's
    rows split over the data axes are chunked on each rank, so that every
    microbatch stays spread over the ranks: the chunks differ from a plain
    tensor's, but their mean (the gradient the step applies) does not."""
    if isinstance(v, DTensor):
        local = v.to_local()
        per = local.shape[0] // M
        return DTensor.from_local(local[i * per:(i + 1) * per],
                                  v.device_mesh, v.placements,
                                  run_check=False)
    per = v.shape[0] // M
    return v[i * per:(i + 1) * per]


def make_train_step(cfg: ArchConfig, optimizer: opt.Optimizer,
                    plan: Optional[Plan] = None, lr_schedule=None,
                    clip_norm: float = 1.0):
    """-> ``train_step(state, batch) -> (new_state, metrics)``; ``batch``
    holds tensors on the model's device, its leading dimension split into
    ``plan.microbatches`` chunks.  The metrics are 0-dim tensors (``loss``,
    ``grad_norm``) and the host float ``lr``: reading them waits for the
    device, which the step itself never does."""
    plan = plan or Plan()
    lr_schedule = lr_schedule or (lambda s: 3e-4)
    remat = plan.remat_policy or cfg.remat_policy
    M = plan.microbatches

    def value_and_grad(model, params, batch, tracer):
        with tracer.span("train.forward"):
            loss, _ = transformer.loss_fn(model, cfg, batch,
                                          remat_policy=remat)
        with tracer.span("train.backward"):
            grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), dict(zip(params, grads))

    axes = {}   # the parameters' logical axes, read once, when needed

    def _pin_grads(g):
        """Constrain gradients to the parameter sharding (no-op without a
        sharding context or on plain tensors): a DTensor gradient's
        ``Partial`` placements resolve here, reduce-scattered into the
        sharded layout under FSDP, instead of being carried as partial
        sums into the optimizer."""
        from repro_torch.distributed import sharding as shard
        if shard.current() is None:
            return g
        if not axes:
            axes.update(transformer.param_axes(cfg))
        return shard.constrain_like_params(g, axes)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        tracer = _obs_trace.get_tracer()
        model = state.params
        params = trainable(model)
        if M > 1:
            grads = _pin_grads({n: torch.zeros_like(p, dtype=torch.float32)
                                for n, p in params.items()})
            loss_sum = None
            for i in range(M):
                one = {k: _microbatch(v, i, M) for k, v in batch.items()}
                loss, g = value_and_grad(model, params, one, tracer)
                g = _pin_grads(g)
                for n, gi in g.items():
                    grads[n].add_(gi.float())
                del g
                grads = _pin_grads(grads)
                loss_sum = loss if loss_sum is None else loss_sum + loss
            for gi in grads.values():
                gi.div_(M)
            loss_val = loss_sum / M
        else:
            loss_val, grads = value_and_grad(model, params, batch, tracer)
            grads = _pin_grads(grads)
        with tracer.span("train.optimizer"):
            grads, gnorm = opt.clip_by_global_norm(grads, clip_norm)
            lr = lr_schedule(state.step)
            _, new_opt = optimizer.update(grads, state.opt_state, params, lr)
        del grads
        return (TrainState(model, new_opt, state.step + 1),
                {"loss": loss_val, "grad_norm": gnorm, "lr": lr})

    return train_step


# ---------------------------------------------------------------------------
# Manual-DP train step: explicit collective control
# ---------------------------------------------------------------------------


def make_manual_dp_train_step(cfg: ArchConfig, optimizer: opt.Optimizer,
                              mesh, axis: str = "data",
                              compression: Optional[str] = None,
                              lr_schedule=None, clip_norm: float = 1.0):
    """Pure-DP train step with the gradient all-reduce written out in
    collectives, so the wire format is controllable: ``compression=
    "int8_ef"`` swaps the all-reduce for the int8 error-feedback collective
    (``distributed/compression.py``), 4x fewer DP collective bytes.
    Parameters are replicated, one copy per rank; the batch is split over
    ``axis`` of ``mesh`` (a ``DeviceMesh`` over the initialised group).

    -> ``(train_step, init_ef)``.  ``train_step(state, ef, batch)`` takes the
    GLOBAL batch and keeps this rank's rows by its coordinate on ``axis``
    (as the reference's ``shard_map`` splits the leading dimension); it
    returns ``(state, ef, {"loss", "grad_norm"})``, the metrics 0-dim
    tensors equal on every rank.  ``ef``, the error-feedback residual of
    this rank (``init_ef(model)``: f32 zeros, one per parameter, under
    ``"int8_ef"``; empty without compression, which never reads it), and the
    parameters and optimizer state update in place.  Under ``"int8_ef"``
    the averaged gradients are f32, as the reference's are."""
    import torch.distributed as dist

    from repro_torch.distributed import compression as comp
    from repro_torch.launch.mesh import axis_size
    if compression not in (None, "int8_ef"):
        raise ValueError(f"unknown compression {compression!r}")
    lr_schedule = lr_schedule or (lambda s: 3e-4)
    group = mesh.get_group(axis)
    n_dev = axis_size(mesh, axis)
    rank = mesh.get_local_rank(axis)

    def local_rows(batch):
        out = {}
        for k, v in batch.items():
            if v.shape[0] % n_dev:
                raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows, not "
                                 f"a multiple of the {n_dev} ranks of "
                                 f"{axis!r}")
            per = v.shape[0] // n_dev
            out[k] = v[rank * per:(rank + 1) * per]
        return out

    @torch.no_grad()
    def average(grads, ef):
        """The mean over ``axis`` of each gradient, in place of it."""
        for name, g in grads.items():
            if compression == "int8_ef":
                codes, scales, r_new = comp.ef_compress(g, ef[name])
                ef[name].copy_(r_new)
                del r_new
                deq = comp.dequantize(codes, scales, g.numel(), g.shape)
                del codes, scales
                grads[name] = comp.psum_compressed(deq, group).div_(n_dev)
            else:
                dist.all_reduce(g, group=group)
                g.div_(n_dev)

    def train_step(state: TrainState, ef, batch: Dict[str, torch.Tensor]):
        model = state.params
        params = trainable(model)
        loss, _ = transformer.loss_fn(model, cfg, local_rows(batch))
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        loss = loss.detach()
        average(grads, ef)
        dist.all_reduce(loss, group=group)
        loss.div_(n_dev)
        grads, gnorm = opt.clip_by_global_norm(grads, clip_norm)
        lr = lr_schedule(state.step)
        _, new_opt = optimizer.update(grads, state.opt_state, params, lr)
        del grads
        return (TrainState(model, new_opt, state.step + 1), ef,
                {"loss": loss, "grad_norm": gnorm})

    def init_ef(model) -> Dict[str, torch.Tensor]:
        if compression is None:
            return {}
        params = trainable(model) \
            if isinstance(model, torch.nn.Module) else model
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.items()}

    return train_step, init_ef


def make_prefill_step(cfg: ArchConfig):
    """-> ``prefill_step(model, batch) -> logits``; ``batch`` is handed to
    ``transformer.forward`` whole (``tokens``, and ``vision_embeds`` for the
    vision-language family; keys it does not read, such as ``loss_mask``,
    pass unread)."""

    @torch.no_grad()
    def prefill_step(model, batch):
        logits, _ = transformer.forward(model, cfg, batch)
        return logits

    return prefill_step


def make_serve_step(cfg: ArchConfig, sample: bool = True,
                    temperature: float = 1.0):
    """One decode iteration: token in, next token + new cache.  The next
    token is (B,), or (B, n_output_heads) with several heads: each head
    samples (or argmaxes) over the last axis of its logits.

    ``generator`` (a ``torch.Generator`` on the tokens' device) drives the
    sampling and may be ``None`` for ``sample=False``."""

    @torch.no_grad()
    def serve_step(model, state, tokens,
                   generator: Optional[torch.Generator] = None):
        logits, new_state = transformer.decode_step(model, cfg, state, tokens)
        last = logits[:, -1]                      # (B[, n_heads], V)
        if isinstance(last, DTensor):
            # logits sharded on act_vocab (and rows on the data axes) are
            # made whole on every rank: each rank then samples from the
            # same probabilities with a generator seeded alike
            last = last.full_tensor()
        if sample:
            probs = torch.softmax(last.float() / temperature, dim=-1)
            next_tok = torch.multinomial(probs.reshape(-1, probs.shape[-1]),
                                         1, generator=generator)
            next_tok = next_tok.reshape(last.shape[:-1])
        else:
            next_tok = torch.argmax(last, dim=-1)
        return next_tok.to(torch.int32), new_state

    return serve_step


def make_step(cfg: ArchConfig, workload, plan: Optional[Plan] = None,
              optimizer: Optional[opt.Optimizer] = None, **kw):
    """One entry point for any workload phase: the ``WorkloadSpec`` (or a
    ``ShapeConfig`` / deprecated phase string — ``repro_torch.core.workload``
    normalizes) picks the step family; extra keywords pass through to the
    underlying ``make_*_step``.  ``optimizer`` defaults to the config's for
    train workloads.  The plan shapes the train step only: the prefill and
    serve steps run on one device without autograd, so there is nothing for
    its remat policy or sharding to change."""
    from repro_torch.core import workload as wl
    spec = wl.as_spec(workload)
    if spec.phase == "train":
        optimizer = optimizer or opt.get_optimizer(cfg.optimizer)
        return make_train_step(cfg, optimizer, plan, **kw)
    if spec.phase == "prefill":
        return make_prefill_step(cfg, **kw)
    return make_serve_step(cfg, **kw)
