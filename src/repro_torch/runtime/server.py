"""Batched decode server: continuous batching over fixed decode slots.

A fixed (slots, max_len) decode state — KV caches, SSM conv windows and
states, as the family has them — is allocated once; finished sequences free
their slot, which is refilled from the request queue (the new prompt is fed
through the decode step into that slot's rows of the state).  The shapes
never change, only slot occupancy does.

Ported: ``admission="fifo"``.  Model-scored admission (``admission="model"``,
``slo_decode_s``, ``AdmissionScorer``, ``simulate_serving``) waits for
``core/predictor.py``; ``calibrator`` for the online calibration; ``injector``
for ``runtime/faults.py``.  Each raises ``NotImplementedError`` until then.

Two properties of the reference that are reproduced here on purpose:

* the decode state has ONE position for all slots, so every token fed to one
  slot during ``_prefill_slot`` advances it and feeds a token 0 to every
  other slot: a token-0 row lands in their KV caches, and their SSM conv
  windows and states advance by one step;
* the position only grows, so a server lives for at most ``max_len`` decode
  calls (prompts included).  The reference's cache write clamps at the last
  row beyond that; here the step raises instead.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _obs_trace

_ADMISSIONS = _obs_metrics.REGISTRY.counter(
    "repro_admission_decisions_total",
    "admission outcomes at slot refill, by policy and outcome "
    "(admit / slo_defer)")
_SLO_VIOLATIONS = _obs_metrics.REGISTRY.counter(
    "repro_slo_violations_total",
    "measured decode iterations that exceeded the decode-latency SLO")
_DECODE_SECONDS = _obs_metrics.REGISTRY.histogram(
    "repro_decode_step_seconds", "measured decode-iteration wall seconds")


@dataclass
class Request:
    rid: int
    prompt: np.ndarray        # (S,) int32
    max_new: int = 32
    out: List[int] = field(default_factory=list)
    done: bool = False
    # --- supervised-degradation bookkeeping ---
    shed: bool = False                      # dropped to preserve the SLO
    retry_after_s: Optional[float] = None   # stamped when shed
    evictions: int = 0                      # slot evictions survived


def _context_cap(cfg: ArchConfig, max_len: int) -> int:
    return min(max_len, cfg.sliding_window) if cfg.sliding_window \
        else max_len


class DecodeServer:
    def __init__(self, cfg: ArchConfig, model, *, slots: int = 4,
                 max_len: int = 512, eos_id: int = 0, seed: int = 0,
                 calibrator=None, admission: str = "fifo",
                 slo_decode_s: Optional[float] = None, injector=None,
                 device="cuda"):
        if cfg.n_input_codebooks != 1:
            # as the reference's server, which asserts one codebook and
            # leaves codebook serving to its examples (there is none)
            raise NotImplementedError(
                f"{cfg.name}: the decode server serves one codebook; "
                f"{cfg.n_input_codebooks} codebooks decode through "
                "steps.make_serve_step")
        if admission not in ("fifo", "model"):
            raise ValueError(f"admission must be 'fifo' or 'model', "
                             f"got {admission!r}")
        if admission == "model" or slo_decode_s is not None:
            raise NotImplementedError(
                "model-scored admission and the decode SLO guard wait for "
                "AdmissionScorer (runtime/server.py of the reference), not "
                "ported yet")
        if calibrator is not None:
            raise NotImplementedError(
                "online calibration (calibration/online.py) is not ported yet")
        if injector is not None:
            raise NotImplementedError(
                "fault injection (runtime/faults.py) is not ported yet")
        self.device = torch.device(device)
        if transformer.param_device(model).type != self.device.type:
            raise ValueError(
                f"the model lies on {transformer.param_device(model)}, the "
                f"server was asked for {self.device}")
        self.cfg = cfg
        self.model = model
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.gen = torch.Generator(self.device).manual_seed(seed)
        self.state = transformer.init_decode_state(cfg, slots, max_len,
                                                   device=self.device)
        self.active: List[Optional[Request]] = [None] * slots
        self.queue: List[Request] = []
        self.remaining = np.zeros(slots, np.int32)
        self._ctx = np.zeros(slots, np.int64)   # cached tokens per slot
        self._iters = 0                         # decode iterations served
        self.admission = admission
        self.last_logits: Optional[torch.Tensor] = None  # of the last step

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _decode(self, tok: np.ndarray) -> torch.Tensor:
        logits, self.state = transformer.decode_step(
            self.model, self.cfg, self.state,
            torch.from_numpy(tok).to(self.device))
        return logits

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _cache_tokens(self) -> float:
        """Total context tokens the next decode iteration streams — per
        occupied slot, capped at the attention window."""
        cap = _context_cap(self.cfg, self.max_len)
        return float(np.minimum(self._ctx, cap)
                     [[r is not None for r in self.active]].sum())

    def _n_active(self) -> int:
        return sum(r is not None for r in self.active)

    def _prefill_slot(self, slot: int, req: Request) -> None:
        """Feed the prompt token by token into this slot's cache rows (the
        clear-and-correct path of the reference; one chunked forward is
        ``prefill_step``'s job)."""
        tracer = _obs_trace.get_tracer()
        with tracer.span("prefill", predicted_s=None, rid=req.rid,
                         plen=len(req.prompt), slot=slot):
            # re-admission after an eviction resumes from the generated
            # prefix: feed prompt + already-produced tokens, owe only the
            # still-missing ones
            for t in list(req.prompt) + list(req.out):
                tok = np.zeros((self.slots, 1), np.int64)
                tok[slot, 0] = t
                self._decode(tok)
            if tracer.enabled:
                self._sync()
        self.active[slot] = req
        self.remaining[slot] = req.max_new - len(req.out)
        self._ctx[slot] = len(req.prompt) + len(req.out)

    def evict_slot(self, slot: int) -> Optional[Request]:
        """Evict ``slot``'s request back to the FRONT of the queue (it has
        seniority).  The request keeps its generated prefix and resumes from
        it on re-admission."""
        req = self.active[slot]
        if req is None:
            return None
        req.evictions += 1
        self.active[slot] = None
        self.remaining[slot] = 0
        self._ctx[slot] = 0
        self.queue.insert(0, req)
        return req

    def _pick(self) -> Optional[int]:
        """Index into ``self.queue`` of the next request to admit."""
        if not self.queue:
            return None
        _ADMISSIONS.inc(1, policy="fifo", outcome="admit")
        return 0

    def _refill(self) -> None:
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                i = self._pick()
                if i is None:
                    break
                self._prefill_slot(s, self.queue.pop(i))

    def step(self) -> float:
        """One decode iteration across all occupied slots; returns the
        measured wall seconds (to the point where the sampled tokens are on
        the host, so the device has finished)."""
        tok = np.zeros((self.slots, 1), np.int64)
        for s, req in enumerate(self.active):
            if req is not None:
                tok[s, 0] = req.out[-1] if req.out else req.prompt[-1]
        tracer = _obs_trace.get_tracer()
        active = self._n_active()
        t0 = time.perf_counter()
        with tracer.span("decode_step", predicted_s=None, active=active):
            logits = self._decode(tok)
            probs = torch.softmax(logits[:, -1].float(), dim=-1)
            nxt = torch.multinomial(probs, 1, generator=self.gen)[:, 0] \
                .cpu().numpy()  # waits for the device
        dt = time.perf_counter() - t0
        self.last_logits = logits
        self._iters += 1
        _DECODE_SECONDS.observe(dt)
        for s, req in enumerate(self.active):
            if req is None:
                continue
            t = int(nxt[s])
            req.out.append(t)
            self.remaining[s] -= 1
            self._ctx[s] += 1
            if t == self.eos_id or self.remaining[s] <= 0:
                req.done = True
                self.active[s] = None
                self._ctx[s] = 0
        return dt

    def run(self, max_iters: int = 10_000) -> List[Request]:
        """Serve until queue + slots drain; returns completed requests."""
        done: List[Request] = []
        it = 0
        while (self.queue or any(self.active)) and it < max_iters:
            self._refill()
            before = [r for r in self.active if r]
            self.step()
            done.extend(r for r in before if r.done)
            it += 1
        return done
