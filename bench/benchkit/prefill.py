"""A prefill cell: one caller sends back-to-back prefill steps through the
program's ``steps.make_step`` step, closed loop.

Set-up makes the weights and a pool of distinct token batches on the card
from the seed, binds the weights into the program's model and runs
``warmup_steps`` steps.  The window then runs steps until ``seconds``
have passed, each timed on the host clock to a synchronize.  A seeded
reservoir keeps the outputs of ``sampled_steps`` of the window's steps
(and, for an MoE, the experts the program picked in each routed layer);
once the window has closed, the plain reference recomputes those steps in
f32 and ``compare`` judges them.  The traced run holds the program's
tracer on for its window (``Window.tracing``); the timed run runs none.
"""
from __future__ import annotations

import random
import time
from typing import List, Optional

import numpy as np
import torch

from benchkit import compare, program, weights as W
from benchkit.window import Result, Window


class _Picks:
    """The experts the program picks in each MoE layer of a step:
    ``moe.route`` wrapped, its result passed on unchanged."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.orig = moe, moe.route
        self.step: List[torch.Tensor] = []
        orig = self.orig

        def route(*args, **kwargs):
            r = orig(*args, **kwargs)
            self.step.append(r.experts)
            return r

        moe.route = route

    def restore(self) -> None:
        self.moe.route = self.orig


def run(cfg: dict, traffic: dict, ref, seed: int, seconds: float,
        win: Window, device) -> Result:
    arch = program.arch_config(cfg)
    B, S, P = traffic["batch"], traffic["seq_len"], traffic["pool"]
    weights = W.make(cfg, seed, device, ref)
    model = program.model_with(arch, weights)
    step = program.prefill_step(arch, B, S)
    gen = torch.Generator(device).manual_seed(int(seed) * 2 + 1)
    pool = torch.randint(0, cfg["vocab_size"], (P, B, S), generator=gen,
                         device=device, dtype=torch.int32)
    picks = _Picks() if cfg.get("moe") else None
    try:
        for i in range(traffic["warmup_steps"]):
            step(model, {"tokens": pool[i % P]})
        win.synchronize()

        rng = random.Random(int(seed))
        K = traffic["sampled_steps"]
        kept: list = []
        n = 0

        def one() -> float:
            nonlocal n
            b = n % P
            if picks:
                picks.step = []
            t0 = time.perf_counter()
            out = step(model, {"tokens": pool[b]})
            win.synchronize()
            dt = time.perf_counter() - t0
            item = (b, out, picks.step if picks else None)
            if len(kept) < K:
                kept.append(item)
            else:
                j = rng.randrange(n + 1)
                if j < K:
                    kept[j] = item
            n += 1
            return dt

        with win.tracing():
            res = win.run(one, seconds, traffic["profiled_steps"])
    finally:
        if picks:
            picks.restore()
    tokens = B * S
    res.metrics = {
        "prefill_tokens_per_s": res.steps * tokens / res.span_s,
        "prefill_ms_p90": float(np.percentile(res.timed_s, 90)) * 1e3}
    res.attempted, res.failed = res.steps, 0

    # the check, after the window: the program's state freed but for the
    # sampled outputs
    sampled = [(pool[b].clone(), out, pk) for b, out, pk in kept]
    del pool, kept, model, step
    win.free()
    numbers: dict = {}
    for tokens_b, out, pk in sampled:
        got = check_step(cfg, ref, weights, tokens_b, out, pk)
        numbers = {k: max(v, numbers.get(k, 0.0)) for k, v in got.items()}
    res.numbers = numbers
    return res


def routed_layers(cfg: dict, ref=None) -> int:
    """The layers that route tokens to experts: ``ref``'s
    ``routed_layers(cfg)`` where the configuration's reference module
    defines one, else every layer."""
    if hasattr(ref, "routed_layers"):
        return ref.routed_layers(cfg)
    return cfg["n_layers"]


def check_step(cfg: dict, ref, weights, tokens: torch.Tensor,
               out: torch.Tensor, picks: Optional[List[torch.Tensor]]
               ) -> dict:
    """The numbers of one step: ``out`` (and ``picks``) of the program, or
    of the control, against the reference in f32 on ``tokens``.  Picks
    that are not one (groups, tokens, top_k) tensor a routed layer
    (``routed_layers``) for these tokens are no routing: the reference
    then routes by itself and the regret is infinite."""
    record: dict = {}
    moe = cfg.get("moe")
    whole = moe and picks is not None \
        and len(picks) == routed_layers(cfg, ref) \
        and all(p.numel() == tokens.numel() * moe["top_k"] for p in picks)
    want = ref.logits(weights, cfg, tokens, precision="f32",
                      picks=picks if whole else None, record=record)
    got = {"logit_err": compare.logit_err(out, want)}
    del want
    if moe:
        got["route_regret"] = compare.route_regret(record["probs"], picks) \
            if whole else float("inf")
    return got


def control_step(cfg: dict, ref, weights, tokens: torch.Tensor) -> dict:
    """The control: the reference itself, computed with fp8 products, in
    the program's place (its own routing), judged as the program is."""
    record: dict = {}
    out = ref.logits(weights, cfg, tokens, precision="fp8", record=record)
    return check_step(cfg, ref, weights, tokens, out,
                      record.get("picks"))


