"""Batched decode server: continuous batching over fixed decode slots,
with cost-model-informed admission.

A fixed (slots, max_len) decode state — KV caches, SSM conv windows and
states, as the family has them — is allocated once; finished sequences free
their slot, which is refilled from the request queue (the new prompt is fed
through the decode step into that slot's rows of the state).  The shapes
never change, only slot occupancy does.

Admission is where the unified cost model pays off at serving time: an
``AdmissionScorer`` compiles two fused basis programs once — the
decode-iteration program of ``WorkloadSpec(phase="decode",
active_slots=…, cache_tokens=…)``, whose occupancy (``AS``) and context
(``CT``) free variables rescore a sweep of candidate admissions as array
ops, and the prefill program, vectorized over the prompt length ``S`` —
and every refill scores ``prefill + remaining tokens × marginal decode
cost`` per queued candidate.  ``admission="model"`` admits the argmin
(shortest predicted job first), with ``slo_decode_s`` deferring an
admission whose predicted next iteration breaks the SLO;
``admission="fifo"`` keeps arrival order.  ``simulate_serving`` replays
both policies under the model's own predictions.  On a CUDA server the
scorer prices through the card's model (``gpu-h100``, fitted where a
calibration registered one, else its datasheet seed) over the step
programs of the card's kernels; on the CPU through the reference's default
(the analytic v5e seed).

A ``calibrator`` (``calibration/online.OnlineCalibrator``) is fed every
decode iteration's measured seconds against the property vector of the
reference's live decode workload (``WorkloadSpec(phase="decode")`` at the
server's slots and length, over the kernels the card launches); an
``injector`` (``runtime/faults.FaultInjector``) perturbs the measured time
(``perturb_decode_time``), and ``ServingSupervisor`` calls its
``decode_begin``.

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
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import report as _obs_report
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


class AdmissionScorer:
    """Scores admission candidates through the fused step programs.

    Compiled once per (cfg × slot geometry); after that every call is a
    basis-program GEMV over array environments — microseconds per sweep,
    cheap enough to run inside the serving loop on every refill.

    Single-host serving (no collectives): a cell's seconds are the fused
    step score divided over ``n_dev`` plus the model's per-dispatch
    constant, exactly the ``planspace.scores`` composition with the
    collective term dropped (DP = TP = 1 ⇒ zero collective bytes).
    ``model``: anything ``predictor.resolve_model`` takes (None, the
    analytic v5e seed); ``kernels``: the registry the step programs compose
    (``predictor.step_program``'s; None, the card's kernels).
    """

    def __init__(self, cfg: ArchConfig, *, slots: int, max_len: int,
                 model=None, n_dev: int = 1, kernels=None):
        from repro_torch.core import predictor
        from repro_torch.core import properties as props
        from repro_torch.core import workload as wl
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.n_dev = max(int(n_dev), 1)
        self.model = predictor.resolve_model(model)
        self._w1 = 0.0
        for k, w in zip(self.model.keys, self.model.weights):
            if k == props.CONST1:
                self._w1 = float(w)
        # occupancy-refined decode spec: AS/CT become free variables of the
        # compiled program (structure ('decode','ct','as')); the env values
        # set here are placeholders — score calls pin them per candidate
        decode = wl.WorkloadSpec(
            phase="decode", global_batch=slots, seq_len=max_len,
            active_slots=0, cache_tokens=0.0, name="admission_decode")
        self._decode_prog = predictor.step_program(cfg, decode,
                                                   kernels=kernels)
        prefill = wl.WorkloadSpec(
            phase="prefill", global_batch=1, seq_len=max_len,
            name="admission_prefill")
        self._prefill_prog = predictor.step_program(cfg, prefill,
                                                    kernels=kernels)

    # -- primitives --------------------------------------------------------
    def prefill_seconds(self, prompt_lens) -> np.ndarray:
        """Predicted seconds to prefill one prompt of each given length
        (vectorized over ``S``)."""
        lens = np.asarray(prompt_lens, dtype=np.float64)
        env = {"B": 1.0, "S": lens, "M": 1.0}
        s = np.asarray(self._prefill_prog.score(env, self.model),
                       dtype=np.float64)
        return self._w1 + np.broadcast_to(s, lens.shape) / self.n_dev

    def decode_step_seconds(self, active, cache_tokens) -> np.ndarray:
        """Predicted seconds of one decode iteration at the given slot
        occupancy (``AS``) and total cached context (``CT``) — both may be
        arrays (one entry per candidate admission)."""
        a = np.asarray(active, dtype=np.float64)
        ct = np.asarray(cache_tokens, dtype=np.float64)
        a, ct = np.broadcast_arrays(a, ct)
        env = {"B": float(self.slots), "S": float(self.max_len), "M": 1.0,
               "AS": a, "CT": ct, "SL": 1.0, "MI": 1.0}
        s = np.asarray(self._decode_prog.score(env, self.model),
                       dtype=np.float64)
        return self._w1 + np.broadcast_to(s, a.shape) / self.n_dev

    # -- the admission decision -------------------------------------------
    def admission_scores(self, prompt_lens, remaining_tokens, *,
                         active: int, cache_tokens: float
                         ) -> Dict[str, np.ndarray]:
        """Score each queued candidate for the next free slot.

        score_i = prefill(len_i) + remaining_i × Δdecode_i, where Δdecode_i
        is the marginal per-iteration cost of running with this candidate
        resident (occupancy +1, context +min(len_i, window)) over the
        current occupancy — i.e. the predicted serving time this admission
        ADDS.  Argmin is shortest-predicted-job-first.
        """
        lens = np.asarray(prompt_lens, dtype=np.float64)
        rem = np.asarray(remaining_tokens, dtype=np.float64)
        pf = self.prefill_seconds(lens)
        win = self.cfg.sliding_window
        ctx = np.minimum(lens, win) if win is not None else lens
        base = self.decode_step_seconds(active, cache_tokens)
        with_c = self.decode_step_seconds(active + 1, cache_tokens + ctx)
        delta = np.maximum(with_c - base, 0.0)
        return {"prefill_s": pf, "decode_delta_s": delta,
                "score_s": pf + rem * delta}


def _context_cap(cfg: ArchConfig, max_len: int) -> int:
    return min(max_len, cfg.sliding_window) if cfg.sliding_window \
        else max_len


class DecodeServer:
    def __init__(self, cfg: ArchConfig, model, *, slots: int = 4,
                 max_len: int = 512, eos_id: int = 0, seed: int = 0,
                 calibrator=None, admission: str = "fifo",
                 slo_decode_s: Optional[float] = None, injector=None,
                 device="cuda", cost_model=None):
        """``model``: the network, as ``transformer.init_params`` builds it,
        on ``device``.  ``cost_model`` (the reference's ``model=``) prices
        the admission scorer: None is ``gpu-h100`` on a CUDA server (as
        ``kernels.ops.default_model``) and the reference's default on the
        CPU."""
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
        self.injector = injector                # FaultInjector or None
        self._iters = 0                         # decode iterations served
        self.last_logits: Optional[torch.Tensor] = None  # of the last step

        # ---- model-informed admission ----
        self.admission = admission
        self.slo_decode_s = slo_decode_s
        self.scorer: Optional[AdmissionScorer] = None
        if admission == "model" or slo_decode_s is not None:
            if cost_model is None and self.device.type == "cuda":
                from repro_torch.kernels.ops import CARD_MODEL
                cost_model = CARD_MODEL
            self.scorer = AdmissionScorer(cfg, slots=slots, max_len=max_len,
                                          model=cost_model)

        # ---- online calibration: feed per-iteration decode timings ----
        self.calibrator = calibrator
        self._decode_pv = None
        if calibrator is not None:
            from repro_torch.core import predictor
            from repro_torch.core.workload import WorkloadSpec
            from repro_torch.distributed.plan import Plan
            live = WorkloadSpec(phase="decode", global_batch=slots,
                                seq_len=max_len, name="decode_live")
            self._decode_pv = predictor.plan_property_vector(
                cfg, live, Plan(dp_axes=(), tp_axis=None, fsdp=False,
                                sequence_parallel=False), {"data": 1})

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
        pred = None
        if tracer.enabled and self.scorer is not None:
            pred = float(self.scorer.prefill_seconds([len(req.prompt)])[0])
        with tracer.span("prefill", predicted_s=pred, rid=req.rid,
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
        """Index into ``self.queue`` of the next request to admit, or None
        to defer admission this iteration (SLO guard)."""
        if self.admission == "fifo" or self.scorer is None:
            if not self.queue:
                return None
            _ADMISSIONS.inc(1, policy="fifo", outcome="admit")
            return 0
        if not self.queue:
            return None
        active, ct = self._n_active(), self._cache_tokens()
        sc = self.scorer.admission_scores(
            [len(r.prompt) for r in self.queue],
            [r.max_new for r in self.queue],
            active=active, cache_tokens=ct)
        i = int(np.argmin(sc["score_s"]))
        if self.slo_decode_s is not None and active > 0:
            cap = _context_cap(self.cfg, self.max_len)
            nxt = self.scorer.decode_step_seconds(
                active + 1, ct + min(len(self.queue[i].prompt), cap))
            if float(nxt) > self.slo_decode_s:
                _ADMISSIONS.inc(1, policy="model", outcome="slo_defer")
                _obs_trace.get_tracer().instant(
                    "slo_defer", rid=self.queue[i].rid,
                    predicted_next_s=float(nxt), slo_s=self.slo_decode_s)
                return None     # admitting would break the decode SLO
        req = self.queue[i]
        _ADMISSIONS.inc(1, policy="model", outcome="admit")
        _obs_report.emit("admit", {
            "rid": req.rid, "plen": len(req.prompt),
            "pred_prefill": f"{sc['prefill_s'][i]*1e3:.3f}ms",
            "decode_delta": f"{sc['decode_delta_s'][i]*1e6:.3f}us",
            "score": f"{sc['score_s'][i]*1e3:.3f}ms", "policy": "model"})
        return i

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
        the host, so the device has finished; injector-perturbed, when
        armed) — the supervisor's watchdog currency."""
        tok = np.zeros((self.slots, 1), np.int64)
        for s, req in enumerate(self.active):
            if req is not None:
                tok[s, 0] = req.out[-1] if req.out else req.prompt[-1]
        tracer = _obs_trace.get_tracer()
        pred = None
        active = self._n_active()
        if tracer.enabled and self.scorer is not None and active:
            pred = float(self.scorer.decode_step_seconds(
                active, self._cache_tokens()))
        t0 = time.perf_counter()
        with tracer.span("decode_step", predicted_s=pred, active=active):
            logits = self._decode(tok)
            probs = torch.softmax(logits[:, -1].float(), dim=-1)
            nxt = torch.multinomial(probs, 1, generator=self.gen)[:, 0] \
                .cpu().numpy()  # waits for the device
        dt = time.perf_counter() - t0
        if self.injector is not None:
            dt = self.injector.perturb_decode_time(self._iters, dt)
        self.last_logits = logits
        self._iters += 1
        _DECODE_SECONDS.observe(dt)
        if self.slo_decode_s is not None and active \
                and dt > self.slo_decode_s:
            _SLO_VIOLATIONS.inc()
        if self.calibrator is not None:
            self.calibrator.observe(self._decode_pv, dt, tag="decode",
                                    phase="decode")
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


# ---------------------------------------------------------------------------
# Discrete-event serving simulation — the admission policies compared under
# the cost model's own physics (no hardware, no weights, deterministic)
# ---------------------------------------------------------------------------


def simulate_serving(cfg: ArchConfig, prompt_lens: Sequence[int],
                     max_new: int = 32, *, slots: int = 4,
                     max_len: int = 512, policy: str = "model",
                     model=None, scorer: Optional[AdmissionScorer] = None,
                     seed: int = 0, noise: float = 0.0, kernels=None
                     ) -> Dict[str, object]:
    """Replay the slot server's schedule with the scorer's predictions as
    the clock: prefills serialize (the example server feeds prompts through
    the decode step), decode iterations cost ``decode_step_seconds`` at the
    instantaneous (occupancy, context) point.  All requests arrive at t=0,
    so a request's completion time IS its latency and the policies differ
    only in admission order — exactly the decision the scorer ranks.

    Returns mean/max latency, makespan and the admission order; run with
    ``policy="model"`` and ``policy="fifo"`` (sharing one ``scorer``) to
    compare.

    ``seed``/``noise`` make perturbed replays deterministic: with
    ``noise > 0`` every event duration is scaled by
    ``exp(noise · z)``, z standard normal from ``default_rng(seed)`` —
    same seed, same trajectory, every CI run.  ``noise=0`` (default) is
    the exact predicted-time replay, bit-identical to the pre-seed
    behavior.  ``kernels``: the registry of a scorer built here
    (``AdmissionScorer``'s).
    """
    if policy not in ("fifo", "model"):
        raise ValueError(f"policy must be 'fifo' or 'model', got {policy!r}")
    scorer = scorer or AdmissionScorer(cfg, slots=slots, max_len=max_len,
                                       model=model, kernels=kernels)
    rng = np.random.default_rng(seed)
    jit = (lambda: float(np.exp(noise * rng.standard_normal()))) \
        if noise > 0.0 else (lambda: 1.0)
    cap = _context_cap(cfg, max_len)
    queue = list(range(len(prompt_lens)))          # rids in arrival order
    lens = [int(l) for l in prompt_lens]
    slot_rid = [None] * slots
    slot_rem = np.zeros(slots, np.int64)
    slot_ctx = np.zeros(slots, np.int64)
    t = 0.0
    latency: Dict[int, float] = {}
    order: List[int] = []

    def occupancy():
        act = [s for s in range(slots) if slot_rid[s] is not None]
        return len(act), float(np.minimum(slot_ctx[act], cap).sum())

    while queue or any(r is not None for r in slot_rid):
        for s in range(slots):
            if slot_rid[s] is not None or not queue:
                continue
            if policy == "fifo":
                i = 0
            else:
                active, ct = occupancy()
                sc = scorer.admission_scores(
                    [lens[r] for r in queue], [max_new] * len(queue),
                    active=active, cache_tokens=ct)
                i = int(np.argmin(sc["score_s"]))
            rid = queue.pop(i)
            t += float(scorer.prefill_seconds([lens[rid]])[0]) * jit()
            slot_rid[s], slot_rem[s], slot_ctx[s] = rid, max_new, lens[rid]
            order.append(rid)
        active, ct = occupancy()
        if active == 0:
            break
        t += float(scorer.decode_step_seconds(active, ct)) * jit()
        for s in range(slots):
            if slot_rid[s] is None:
                continue
            slot_rem[s] -= 1
            slot_ctx[s] += 1
            if slot_rem[s] <= 0:
                latency[slot_rid[s]] = t
                slot_rid[s] = None
                slot_ctx[s] = 0

    lat = np.asarray([latency[r] for r in sorted(latency)])
    return {"policy": policy, "order": order,
            "mean_latency_s": float(lat.mean()) if len(lat) else 0.0,
            "max_latency_s": float(lat.max()) if len(lat) else 0.0,
            "makespan_s": t, "n_done": len(lat)}
