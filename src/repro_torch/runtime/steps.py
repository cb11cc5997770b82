"""Step functions: train_step / prefill_step / serve_step factories.

All run eagerly; prefill and serve without autograd.  The train step takes
the gradient of ``transformer.loss_fn`` with torch autograd, accumulates
microbatches in f32 when the plan asks for several (one microbatch's
activations live at a time), clips by the global norm and applies the
optimizer, which updates the parameters in place.  ``make_step`` waits for
``core/workload.py`` and ``make_manual_dp_train_step`` for the multi-device
slice.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.plan import Plan
from repro_torch.models import transformer
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

    def value_and_grad(model, params, batch):
        loss, _ = transformer.loss_fn(model, cfg, batch, remat_policy=remat)
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), dict(zip(params, grads))

    # _pin_grads: the reference constrains gradients to the parameters'
    # sharding; on one device there is nothing to constrain (multi-device
    # training is the later slice A14)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model = state.params
        params = dict(model.named_parameters())
        if M > 1:
            per = {k: v.shape[0] // M for k, v in batch.items()}
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in params.items()}
            loss_sum = None
            for i in range(M):
                one = {k: v[i * per[k]:(i + 1) * per[k]]
                       for k, v in batch.items()}
                loss, g = value_and_grad(model, params, one)
                for n, gi in g.items():
                    grads[n].add_(gi.float())
                del g
                loss_sum = loss if loss_sum is None else loss_sum + loss
            for gi in grads.values():
                gi.div_(M)
            loss_val = loss_sum / M
        else:
            loss_val, grads = value_and_grad(model, params, batch)
        grads, gnorm = opt.clip_by_global_norm(grads, clip_norm)
        lr = lr_schedule(state.step)
        _, new_opt = optimizer.update(grads, state.opt_state, params, lr)
        del grads
        return (TrainState(model, new_opt, state.step + 1),
                {"loss": loss_val, "grad_norm": gnorm, "lr": lr})

    return train_step


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
        if sample:
            probs = torch.softmax(last.float() / temperature, dim=-1)
            next_tok = torch.multinomial(probs.reshape(-1, probs.shape[-1]),
                                         1, generator=generator)
            next_tok = next_tok.reshape(last.shape[:-1])
        else:
            next_tok = torch.argmax(last, dim=-1)
        return next_tok.to(torch.int32), new_state

    return serve_step
