"""A training cell: one caller drives the program's ``Trainer.train``, one
step at a time, closed loop.

Set-up makes the weights on the card from the seed and builds one
``Trainer`` holding them, with a feed that makes a new batch of uniform
tokens for every step from the seed (the loader's layout).  Set-up then
drives that trainer through its first ``checked_steps`` steps with the
window's own call and keeps what the check needs: each step's loss, the
gradient of step 1 as the optimizer received it (read back from AdamW's
first moment, m₁ = (1 − b1)·g₁) and the parameters' change after the
last checked step, by leaf.  The window then runs steps until
``seconds`` have passed.  Once it has closed and the trainer is freed, the
plain reference follows the same checked steps in f32 from the same
weights and batches and ``compare`` judges the program against it.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from benchkit import compare, program, weights as W
from benchkit.window import Result, Window


def batch(seed: int, step: int, B: int, S: int, V: int
          ) -> Dict[str, np.ndarray]:
    """Step ``step``'s batch: B rows of S + 1 uniform tokens, inputs and
    next-token labels, every position in the loss."""
    rng = np.random.default_rng([int(seed), int(step)])
    toks = rng.integers(0, V, size=(B, S + 1), dtype=np.int32)
    return {"tokens": toks[:, :S].copy(), "labels": toks[:, 1:].copy(),
            "loss_mask": np.ones((B, S), np.float32)}


def lr_at(lr: dict, step: int) -> float:
    """The traffic's warmup-cosine schedule, in f32 arithmetic."""
    f = np.float32
    s = f(step)
    if s < lr["warmup"]:
        return float(f(lr["peak"]) * min(f(1.0), s / f(max(lr["warmup"], 1))))
    t = min(max((s - f(lr["warmup"])) / f(max(lr["total"] - lr["warmup"], 1)),
                f(0.0)), f(1.0))
    cos = f(np.cos(f(np.pi) * t))
    return float(f(lr["peak"]) * (f(lr["floor"]) + f(1 - lr["floor"])
                                  * f(0.5) * (f(1.0) + cos)))


def run(cfg: dict, traffic: dict, ref, seed: int, seconds: float,
        win: Window, device) -> Result:
    arch = program.arch_config(cfg)
    B, S, V = traffic["batch"], traffic["seq_len"], cfg["vocab_size"]
    n_checked = traffic["checked_steps"]
    weights = W.make(cfg, seed, device, ref)
    feed = program.Feed(lambda step: batch(seed, step, B, S, V))
    tr = program.trainer(arch, traffic, weights, feed, device)
    b1 = traffic["optimizer"]["b1"]
    grad = change = None
    for s in range(n_checked):
        tr.train(1)
        if s == 0:
            grad = compare.per_leaf_norms(tr.state.opt_state["m"],
                                          scale=1.0 / (1.0 - b1))
    params = dict(tr.state.params.named_parameters())
    change = compare.per_leaf_norms(params, minus=weights)
    prog = {"loss": [h["loss"] for h in tr.history], "grad": grad,
            "change": change}
    del weights, params

    walls: List[float] = []

    def one() -> float:
        t0 = time.perf_counter()
        tr.train(1)   # ends in a synchronize and reads the loss back
        dt = time.perf_counter() - t0
        walls.append(dt)
        return dt

    with win.tracing() as tracer:
        res = win.run(one, seconds, traffic["profiled_steps"])
    window_losses = [h["loss"] for h in tr.history[n_checked:]]
    tokens = B * S
    res.metrics = {"train_tokens_per_s": res.steps * tokens / res.span_s}
    res.attempted = res.steps
    res.failed = sum(1 for x in window_losses if not math.isfinite(x))
    if tracer is not None:
        spans = [sp.duration_s for sp in tracer.spans
                 if sp.name == "train_step"]
        res.host_ms = [(w - s) * 1e3 for w, s in zip(walls, spans)]
    del tr, feed
    win.free()

    want = follow(ref, cfg, traffic, seed, device, "f32")
    res.numbers = compare.train_numbers(prog, want)
    return res


def follow(ref, cfg: dict, traffic: dict, seed: int, device,
           precision: str, rows: Callable = None) -> dict:
    """The reference's first ``checked_steps`` steps from the seed's
    weights and batches (``rows(batch)`` may cut each batch): the loss of
    each, the clipped gradient of step 1 and the change after the last,
    by leaf.  The parameters are kept in the configuration's types after
    every update, as the program keeps them; all else is f32."""
    B, S, V = traffic["batch"], traffic["seq_len"], cfg["vocab_size"]
    opt, clip = traffic["optimizer"], traffic["clip_norm"]
    start = W.make(cfg, seed, device, ref)
    leaves = {n: t.to(torch.float32, copy=True).requires_grad_()
              for n, t in start.items()}
    m = {n: torch.zeros_like(p) for n, p in leaves.items()}
    v = {n: torch.zeros_like(p) for n, p in leaves.items()}
    losses, grad = [], None
    for step in range(traffic["checked_steps"]):
        bt = {k: torch.from_numpy(x).to(device)
              for k, x in batch(seed, step, B, S, V).items()}
        if rows is not None:
            bt = rows(bt)
        loss = ref.loss(leaves, cfg, bt, precision=precision)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        losses.append(float(loss.detach()))
        del loss
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)
            g = dict(zip(leaves, grads))
            del grads
            for gi in g.values():
                gi.mul_(scale)
            if step == 0:
                grad = compare.per_leaf_norms(g)
            count = step + 1
            bc1 = 1.0 - opt["b1"] ** count
            bc2 = 1.0 - opt["b2"] ** count
            lr = lr_at(traffic["lr"], step)
            for n, p in leaves.items():
                m[n].mul_(opt["b1"]).add_(g[n], alpha=1 - opt["b1"])
                v[n].mul_(opt["b2"]).add_(g[n] * g[n], alpha=1 - opt["b2"])
                upd = (m[n] / bc1) / (torch.sqrt(v[n] / bc2) + opt["eps"])
                upd.add_(p, alpha=opt["weight_decay"])
                p.copy_((p - lr * upd).to(start[n].dtype).float())
                del upd
            del g
    change = compare.per_leaf_norms(leaves, minus=start)
    del leaves, m, v, start
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {"loss": losses, "grad": grad, "change": change}
