"""The numbers that decide ``correct``: what the program produced against
what the plain reference works out from the same weights and inputs.

Prefill (per sampled step):

* ``logit_err``: over every position, the distance of the program's
  logits from the reference's, ``‖program − reference‖₂ / ‖reference‖₂``
  over the vocabulary; the widest position counts.
* ``route_regret`` (MoE): in every layer, for every token, the reference's
  router probability of its top-k experts less that of the experts the
  program picked; the widest token of the widest layer counts.

Training (the first ``checked_steps`` steps):

* ``loss``: the widest relative gap of a step's loss;
* ``grad``: the gradient of step 1 as the optimizer received it, by leaf,
  the gap of the norms over the larger of the reference leaf's norm and
  the median leaf's; the widest leaf counts;
* ``change``: the parameters' change over the checked steps, by leaf, the
  same measure, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (the rest move by round-off alone).

A run is correct when every number is finite and within its limit.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

#: a leaf counts for ``change`` when its reference gradient norm is at
#: least this share of the median leaf's
MOVING = 1e-3


@torch.no_grad()
def logit_err(program: torch.Tensor, reference: torch.Tensor) -> float:
    """program, reference (B, S, V); the widest position's relative L2
    distance."""
    worst = 0.0
    for b in range(program.shape[0]):
        p, r = program[b].float(), reference[b].float()
        if not bool(torch.isfinite(p).all()):
            return float("inf")
        d = torch.linalg.vector_norm(p - r, dim=-1) \
            / torch.linalg.vector_norm(r, dim=-1).clamp(min=1e-30)
        worst = max(worst, float(d.max()))
    return worst


@torch.no_grad()
def route_regret(probs: Sequence[torch.Tensor],
                 picks: Sequence[torch.Tensor]) -> float:
    """probs[l] (G, t, E) the reference's router probabilities of layer l,
    picks[l] (G, t, K) the program's experts there; the widest token's
    regret."""
    worst = 0.0
    for p, k in zip(probs, picks):
        best = torch.topk(p, k.shape[-1], dim=-1).values.sum(-1)
        got = torch.gather(p, -1, k.long()).sum(-1)
        worst = max(worst, float((best - got).max()))
    return worst


def _leaf_gap(prog: Mapping[str, float], ref: Mapping[str, float],
              names: Sequence[str]) -> Tuple[float, str]:
    med = statistics.median(ref[n] for n in names)
    worst, where = 0.0, ""
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
        if not gap == gap:  # NaN
            return float("inf"), n
        if gap > worst:
            worst, where = gap, n
    return worst, where


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """prog, ref: {"loss": [per step], "grad": {leaf: norm}, "change":
    {leaf: norm}}."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"],
                                                    ref["loss"]))
    if not all(x == x and abs(x) != float("inf") for x in prog["loss"]):
        loss = float("inf")
    names = sorted(ref["grad"])
    grad, _ = _leaf_gap(prog["grad"], ref["grad"], names)
    med = statistics.median(ref["grad"][n] for n in names)
    moving = [n for n in names if ref["grad"][n] >= MOVING * med]
    change, _ = _leaf_gap(prog["change"], ref["change"], moving)
    return {"loss": loss, "grad": grad, "change": change}


def judge(numbers: Mapping[str, float], limits: Mapping[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """-> (correct, {name: {"value", "limit"}}) over the numbers that have
    a limit; a limit without a number is an error of the benchmark."""
    if not set(limits) <= set(numbers):
        raise KeyError(f"limits {sorted(limits)} for numbers "
                       f"{sorted(numbers)}")
    shown = {n: {"value": float(numbers[n]), "limit": float(limits[n])}
             for n in sorted(limits)}
    ok = all(v["value"] <= v["limit"] for v in shown.values())
    return ok, shown


def per_leaf_norms(tensors: Mapping[str, torch.Tensor],
                   minus: Optional[Mapping[str, torch.Tensor]] = None,
                   scale: float = 1.0) -> Dict[str, float]:
    """{leaf: ‖t (− minus)‖ · scale} read back in one transfer."""
    names: List[str] = list(tensors)
    with torch.no_grad():
        norms = torch.stack([torch.linalg.vector_norm(
            tensors[n].float() - (minus[n].float() if minus else 0.0))
            for n in names])
    return {n: v * scale for n, v in zip(names, norms.tolist())}
