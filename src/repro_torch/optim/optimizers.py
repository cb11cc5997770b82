"""Optimizers, functional as in the reference (no ``torch.optim`` class,
whose arithmetic differs: AdamW's eps placement, the order of the decoupled
decay).

- ``adamw``     : f32 m/v (type configurable) + decoupled weight decay.
- ``adafactor`` : factored second moment (llama3-405b's choice, whose f32
                  Adam states would not fit).
- ``sgd``       : momentum SGD (measurement baseline).

Parameters, gradients and states are dictionaries of tensors keyed by the
parameter's name (``dict(model.named_parameters())``).  Every update is
computed in f32 and cast back to the parameter's type, one tensor at a time
so that the f32 temporaries never exceed those of the largest tensor.  Unlike
the reference, whose arrays are immutable, ``update`` writes the new
parameters and states IN PLACE (into the same tensors, which the model holds)
and returns them: a copy of a 3.6e9-parameter model and its states does not
fit beside them on one card.  The step count is a host integer.
"""
from __future__ import annotations

import re
from typing import (Any, Callable, Dict, Iterable, List, NamedTuple,
                    Optional)

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Tensors], Any]
    update: Callable[[Tensors, Any, Tensors, float], tuple]
    # update(grads, state, params, lr) -> (params, state), both updated in
    # place


def _f32(x: float) -> float:
    """A host scalar rounded to f32, as the reference's f32 scalars are."""
    return float(np.float32(x))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1,
          state_dtype: torch.dtype = torch.float32) -> Optimizer:
    def init(params: Tensors):
        def zeros(p):   # laid out as p (a DTensor parameter's shards)
            return torch.zeros_like(p, dtype=state_dtype)
        return {"m": {n: zeros(p) for n, p in params.items()},
                "v": {n: zeros(p) for n, p in params.items()},
                "count": 0}

    @torch.no_grad()
    def update(grads: Tensors, state, params: Tensors, lr: float):
        count = state["count"] + 1
        c = np.float32(count)
        bc1 = _f32(1.0 - np.float32(b1) ** c)
        bc2 = _f32(1.0 - np.float32(b2) ** c)
        for n, p in params.items():
            g = grads[n].float()
            m, v = state["m"][n], state["v"][n]
            mf = m.float().mul_(b1).add_(g, alpha=1 - b1)
            vf = v.float().mul_(b2).add_(g * g, alpha=1 - b2)
            del g
            step = (mf / bc1).div_(torch.sqrt(vf / bc2).add_(eps))
            pf = p.float()
            step.add_(pf, alpha=weight_decay)
            p.copy_(pf.sub(step, alpha=_f32(lr)))
            del step, pf
            m.copy_(mf)
            v.copy_(vf)
        return params, {"m": state["m"], "v": state["v"], "count": count}

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adafactor (factored v; optional bf16 momentum)
# ---------------------------------------------------------------------------


#: a per-layer parameter name, ``blocks.{i}.<rest>``
_LAYER_NAME = re.compile(r"blocks\.(\d+)\.(.+)")


def stacked_groups(names: Iterable[str]) -> Dict[str, List[str]]:
    """The reference's stacked leaves in the port's names: the per-layer
    entries ``blocks.{i}.<rest>`` grouped by ``<rest>`` under the key
    ``blocks.*.<rest>``, members in layer order (the reference stacks them
    on a leading ``layers`` axis, ``src/repro/models/transformer.py``).
    Every other name (the top-level leaves, the hybrid's ``shared.``
    block, a flat dict's keys) is a group of its own under its name."""
    groups: Dict[str, List[str]] = {}
    layer: Dict[str, int] = {}
    for n in names:
        m = _LAYER_NAME.fullmatch(n)
        key = f"blocks.*.{m.group(2)}" if m else n
        groups.setdefault(key, []).append(n)
        layer[n] = int(m.group(1)) if m else 0
    return {k: sorted(v, key=layer.__getitem__) for k, v in groups.items()}


def _stacked_1d(key: str, ndim: int) -> bool:
    """A group whose stacked leaf is (L, d) in the reference: its second
    moment is factored across the layers into one (L,) and one (d,)
    moment, kept under the group's key."""
    return key.startswith("blocks.*.") and ndim == 1


def adafactor(decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, momentum: Optional[float] = None,
              momentum_dtype: torch.dtype = torch.bfloat16) -> Optimizer:
    """The reference's Adafactor over its stacked leaves.

    A group of per-layer entries (``stacked_groups``) is one (L, *shape)
    leaf of the reference.  A group of 1-D entries (norm scales, biases,
    the SSM's ``conv_b`` / ``norm`` / ``A_log`` / ``D`` / ``dt_bias``) has
    its second moment factored across the layers: ``v["blocks.*.<rest>"]
    = {"vr": (L,), "vc": (d,)}``.  A group of entries of two or more
    dimensions keeps one ``{"vr", "vc"}`` an entry, under the entry's
    name: those are the reference's slices of its stacked moments.  The
    update's RMS clip is taken over the whole group at once.  Momentum
    stays one tensor a parameter.

    A group is updated in three passes, so that no f32 temporary outgrows
    that of its largest member: the moments; the sum of the squared
    unclipped updates; the update recomputed, clipped and applied."""
    def _factored(p):
        return p.ndim >= 2

    def init(params: Tensors):
        def one(p):
            f32, dev = torch.float32, p.device
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], dtype=f32, device=dev),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=f32, device=dev)}
            return {"v": torch.zeros_like(p, dtype=f32)}

        v = {}
        for key, members in stacked_groups(params).items():
            p = params[members[0]]
            if _stacked_1d(key, p.ndim):
                v[key] = {"vr": torch.zeros(len(members), dtype=torch.float32,
                                            device=p.device),
                          "vc": torch.zeros_like(p, dtype=torch.float32)}
            else:
                v.update({n: one(params[n]) for n in members})
        st = {"v": v, "count": 0}
        if momentum is not None:
            st["m"] = {n: torch.zeros_like(p, dtype=momentum_dtype)
                       for n, p in params.items()}
        return st

    def _unclipped(g, vr, vc, vr_mean):
        """g / sqrt(v̂), v̂ the factored moment's outer product."""
        denom = (vr[..., None] * vc[..., None, :]
                 / torch.clamp(vr_mean[..., None], min=eps))
        return g * torch.rsqrt(denom + eps)

    @torch.no_grad()
    def update(grads: Tensors, state, params: Tensors, lr: float):
        count = state["count"] + 1
        beta = _f32(1.0 - (np.float32(count) + np.float32(1.0))
                    ** np.float32(-decay))
        for key, members in stacked_groups(params).items():
            # 1. the second moments
            if _stacked_1d(key, params[members[0]].ndim):
                v = state["v"][key]
                g2s = [grads[n].float().square().add_(eps) for n in members]
                vr = v["vr"].mul(beta).add_(
                    torch.stack([g2.mean() for g2 in g2s]), alpha=1 - beta)
                vc = v["vc"].mul(beta).add_(sum(g2s) / len(members),
                                            alpha=1 - beta)
                del g2s
                v["vr"].copy_(vr)
                v["vc"].copy_(vc)
                vr_mean = vr.mean(-1, keepdim=True)

                def u_of(i, n):
                    return _unclipped(grads[n].float()[None], vr[i:i + 1],
                                      vc, vr_mean)[0]
            else:
                for n in members:
                    g2 = grads[n].float().square().add_(eps)
                    v = state["v"][n]
                    if "vr" in v:
                        v["vr"].mul_(beta).add_(g2.mean(-1), alpha=1 - beta)
                        v["vc"].mul_(beta).add_(g2.mean(-2), alpha=1 - beta)
                    else:
                        v["v"].mul_(beta).add_(g2, alpha=1 - beta)
                    del g2

                def u_of(i, n):
                    v = state["v"][n]
                    if "vr" in v:
                        return _unclipped(grads[n].float(), v["vr"], v["vc"],
                                          v["vr"].mean(-1, keepdim=True))
                    return grads[n].float() * torch.rsqrt(v["v"] + eps)
            # 2. update clipping (RMS <= clip_threshold) over the group
            sq = sum(torch.sum(u_of(i, n).square())
                     for i, n in enumerate(members))
            numel = sum(params[n].numel() for n in members)
            rms = torch.sqrt(sq / numel + eps)
            scale = torch.clamp(rms / clip_threshold, min=1.0)
            # 3. the update
            for i, n in enumerate(members):
                u = u_of(i, n) / scale
                if momentum is not None:
                    m = state["m"][n]
                    u = momentum * m.float() + (1 - momentum) * u
                    m.copy_(u)
                p = params[n]
                p.copy_(p.float() - _f32(lr) * u)
                del u
        new_state = {"v": state["v"], "count": count}
        if momentum is not None:
            new_state["m"] = state["m"]
        return params, new_state

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# SGD + momentum
# ---------------------------------------------------------------------------


def sgd(momentum: float = 0.9) -> Optimizer:
    def init(params: Tensors):
        return {"m": {n: torch.zeros_like(p, dtype=torch.float32)
                      for n, p in params.items()},
                "count": 0}

    @torch.no_grad()
    def update(grads: Tensors, state, params: Tensors, lr: float):
        for n, p in params.items():
            m = state["m"][n]
            m.mul_(momentum).add_(grads[n].float())
            p.copy_(p.float() - _f32(lr) * m)
        return params, {"m": state["m"], "count": state["count"] + 1}

    return Optimizer(init, update)


def get_optimizer(name: str) -> Optimizer:
    if name == "adamw":
        return adamw()
    if name == "adafactor":
        return adafactor()
    if name == "sgd":
        return sgd()
    raise KeyError(name)


# ---------------------------------------------------------------------------
# LR schedules + grad clipping
# ---------------------------------------------------------------------------


def warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.1):
    """step (host int) -> learning rate (host float), in f32 arithmetic as
    the reference's."""
    f = np.float32

    def lr(step) -> float:
        s = f(step)
        if s < warmup:
            return float(f(peak) * min(f(1.0), s / f(max(warmup, 1))))
        t = min(max((s - f(warmup)) / f(max(total - warmup, 1)), f(0.0)),
                f(1.0))
        cos = f(np.cos(f(np.pi) * t))
        return float(f(peak) * (f(floor) + f(1 - floor) * f(0.5)
                                * (f(1.0) + cos)))
    return lr


@torch.no_grad()
def clip_by_global_norm(grads: Tensors, max_norm: float):
    """Scales the gradients IN PLACE so that their global L2 norm is at most
    ``max_norm``; returns (grads, norm before clipping as a 0-dim f32
    tensor).  The sums are f32; no value leaves the device."""
    g2 = sum(torch.sum(g.float() ** 2) for g in grads.values())
    norm = torch.sqrt(g2)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in grads.values():
        g.copy_(g.float() * scale)
    return grads, norm


# ---------------------------------------------------------------------------
# Optimizer-state logical axes (for distributed sharding of TrainState)
# ---------------------------------------------------------------------------


def opt_state_axes(name: str, params_axes: Dict[str, tuple]):
    """Logical-axes tree mirroring ``get_optimizer(name).init(params)``,
    keyed as the state is.

    Leaf-wise: AdamW m/v inherit the param axes; Adafactor's factored vr/vc
    drop the last / second-to-last axis.  A group of 1-D per-layer entries
    (``stacked_groups``) has its moment under the group's key, as the
    reference's (L, d) leaf: ``vr`` on the ``layers`` axis (which the rules
    map to no mesh axis), ``vc`` on the members' axis.  ``count`` is a
    replicated scalar.
    """
    if name == "adamw":
        return {"m": dict(params_axes), "v": dict(params_axes), "count": ()}
    if name == "adafactor":
        def one(ax):
            if len(ax) >= 2:
                return {"vr": ax[:-1], "vc": ax[:-2] + ax[-1:]}
            return {"v": ax}
        v = {}
        for key, members in stacked_groups(params_axes).items():
            ax = params_axes[members[0]]
            if _stacked_1d(key, len(ax)):
                v[key] = {"vr": ("layers",), "vc": ax}
            else:
                v.update({n: one(params_axes[n]) for n in members})
        return {"v": v, "count": ()}
    if name == "sgd":
        return {"m": dict(params_axes), "count": ()}
    raise KeyError(name)
