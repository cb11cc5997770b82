"""Basis-term attribution — decompose predictions, project residuals.

The fused engine (``core/exprops.py``) scores a cell as one GEMV
``B @ w̃ + c``; this module keeps that sum OPEN: ``score_explain``
returns every addend — per basis term, grouped per property and per cost
category (compute / memory / collective / other), per program source
(step vs. collective vs. launch constant) — so "the model predicts
41.3 ms" becomes "38.1 ms of HBM streaming across 3 terms, 2.9 ms of
all-reduce bytes, 0.3 ms launch overhead".  The decomposition is exact:
the rows sum to the fused ``PlanSpace.scores`` cell at rtol 1e-9 (an
acceptance bar, pinned in ``tests/test_obs.py`` across every registered
arch).

``attribute_residual`` runs the same decomposition *backwards*: given
measured-vs-predicted errors over a sample window, it solves a ridge
least-squares for per-term multiplicative miscalibrations ε (measured ≈
predicted + Σ εᵢ·sᵢ where sᵢ is term i's predicted seconds), so a drift
report can say "HBM-traffic terms account for 78% of the miss" instead
of just flagging drift.  With envs that vary across the window the
projection identifies an injected single-term perturbation (tested);
with identical rows it degrades gracefully to the minimum-norm
projection (shares ∝ contribution²).

This module imports ``repro_torch.core`` lazily where needed, so ``core``
modules may import ``repro_torch.obs`` (trace/metrics/report) without cycles.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "TermContribution", "Explanation", "explain_program", "score_explain",
    "ResidualAttribution", "attribute_residual", "attribute_residual_pv",
]


# ---------------------------------------------------------------------------
# Forward: open up a prediction into its basis-term addends
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TermContribution:
    term: str                 # canonical repr of the basis term ("1" = const)
    seconds: float            # this term's predicted seconds for the cell
    share: float              # seconds / total (signed)
    group: str                # compute | memory | collective | other
    source: str               # "step" | "collective" | "launch"
    properties: Tuple[str, ...]  # property keys the term feeds


@dataclass
class Explanation:
    """A fully decomposed prediction for one cell."""

    total_seconds: float
    rows: List[TermContribution]          # sorted by |seconds| descending
    phase: str = ""
    meta: Dict[str, object] = field(default_factory=dict)

    def by_group(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for r in self.rows:
            out[r.group] = out.get(r.group, 0.0) + r.seconds
        return out

    def by_source(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for r in self.rows:
            out[r.source] = out.get(r.source, 0.0) + r.seconds
        return out

    def by_property(self) -> Dict[str, float]:
        """Per-property seconds (the ``LinearCostModel.breakdown`` analog,
        reconstructed from the term decomposition).  Stored by
        ``score_explain``; empty for hand-built explanations."""
        return dict(self.meta.get("property_seconds", {}))

    def top(self, n: int = 5) -> List[TermContribution]:
        return self.rows[:n]

    def report(self, n: int = 10) -> str:
        """Human-readable table, biggest contributor first."""
        lines = [f"predicted {self.total_seconds*1e3:.3f} ms"
                 + (f" ({self.phase})" if self.phase else "")]
        for g, s in sorted(self.by_group().items(), key=lambda kv: -kv[1]):
            pct = 100.0 * s / self.total_seconds if self.total_seconds \
                else 0.0
            lines.append(f"  {g:<10} {s*1e3:10.4f} ms  {pct:5.1f}%")
        lines.append(f"  top {min(n, len(self.rows))} terms:")
        for r in self.rows[:n]:
            term = r.term if len(r.term) <= 46 else r.term[:43] + "..."
            lines.append(f"    {r.seconds*1e3:10.4f} ms {r.share*100:5.1f}%"
                         f" [{r.group}/{r.source}] {term}")
        return "\n".join(lines)


def _term_groups(program, model) -> Tuple[np.ndarray, List[str],
                                          List[Tuple[str, ...]]]:
    """(w̃ per term, category per term, fed property keys per term).

    A term's category is decided by where its weighted seconds flow: the
    property row with the largest |α_k · coeff[k, i]| wins (terms shared
    across properties are rare after dedup, and the dominant row is what
    a reader wants named)."""
    from repro_torch.core import properties as props
    w = {k: float(v) for k, v in zip(model.keys, model.weights)}
    alpha = np.asarray([w.get(k, 0.0) for k in program.keys])
    contrib = program.coeff * alpha[:, None]        # (n_props, n_terms)
    w_terms = contrib.sum(axis=0)
    groups: List[str] = []
    fed: List[Tuple[str, ...]] = []
    for i in range(program.coeff.shape[1]):
        rows = np.nonzero(program.coeff[:, i])[0]
        fed.append(tuple(program.keys[int(r)] for r in rows))
        pri = np.nonzero(contrib[:, i])[0]
        if len(pri) == 0:
            pri = rows
        if len(pri) == 0:
            groups.append("other")
        else:
            dom = pri[np.argmax(np.abs(contrib[pri, i]))] \
                if len(pri) > 1 else pri[0]
            groups.append(props.category(program.keys[int(dom)]))
    return w_terms, groups, fed


def explain_program(program, env: Mapping[str, object], model, *,
                    scale: float = 1.0, source: str = "step"
                    ) -> List[Tuple[str, float, str, Tuple[str, ...]]]:
    """Per-term (term repr, seconds, group, fed properties) for one
    program at one environment, including the folded constant (term
    ``"1"``).  ``scale`` applies the caller's work division (``1/n_dev``
    for step terms).  The seconds sum EXACTLY to
    ``scale · (program.score(env, model))`` — same folded weights, same
    generated term functions."""
    from repro_torch.core import properties as props
    w_terms, groups, fed = _term_groups(program, model)
    out: List[Tuple[str, float, str, Tuple[str, ...]]] = []
    if np.any(w_terms):
        vals = program(env)
        for i in np.nonzero(w_terms)[0]:
            i = int(i)
            sec = float(w_terms[i]) * float(np.asarray(vals[i], np.float64))
            out.append((program.term_reprs[i], sec * scale, groups[i],
                        fed[i]))
    # the folded constant: Σ_k α_k · const_k
    w = {k: float(v) for k, v in zip(model.keys, model.weights)}
    alpha = np.asarray([w.get(k, 0.0) for k in program.keys])
    c = float(program.const @ alpha)
    if c:
        rows = np.nonzero(program.const * alpha)[0]
        dom = rows[np.argmax(np.abs((program.const * alpha)[rows]))]
        out.append(("1", c * scale, props.category(program.keys[int(dom)]),
                    tuple(program.keys[int(r)] for r in rows)))
    return out


def score_explain(cfg, workload, plan, mesh_shape: Mapping[str, int],
                  model=None, *, kernels=None) -> Explanation:
    """Decompose one (cfg × workload × plan × mesh) cell's predicted step
    seconds into basis-term contributions.

    The composition mirrors ``planspace.PlanSpace.scores`` exactly —
    fused step program scaled by the SPMD work division, fused collective
    program at the cell's (DP, TP), the model's per-dispatch constant as
    a ``launch`` row — so the rows sum to the fused GEMV score at rtol
    1e-9 (tested across all registered archs).  ``kernels``: the registry
    the step program composes (``predictor.step_program``'s; None, the
    card's).
    """
    from repro_torch.core import archcount, planspace, predictor
    from repro_torch.core import properties as props
    from repro_torch.core import workload as wl
    model = predictor.resolve_model(model)
    spec = wl.as_spec(workload)
    mesh = dict(mesh_shape)
    n_dev = 1
    for v in mesh.values():
        n_dev *= int(v)
    n_dev = max(n_dev, 1)
    dp = 1
    for ax in plan.dp_axes:
        dp *= mesh.get(ax, 1)
    tp = mesh.get(plan.tp_axis, 1) if plan.tp_axis else 1

    env = spec.env(cfg)
    env["M"] = plan.microbatches

    rows: List[TermContribution] = []
    raw: List[Tuple[str, float, str, Tuple[str, ...], str]] = []

    step_prog = predictor.step_program(cfg, spec, plan.remat_policy,
                                       kernels=kernels)
    for term, sec, group, keys in explain_program(
            step_prog, env, model, scale=1.0 / n_dev, source="step"):
        raw.append((term, sec, group, keys, "step"))

    topo = archcount.collective_topology(plan)
    coll_prog = planspace._collective_program(cfg, spec.phase, topo)
    cenv = {**env, "DP": dp, "TP": tp}
    for term, sec, group, keys in explain_program(
            coll_prog, cenv, model, source="collective"):
        raw.append((term, sec, group, keys, "collective"))

    w1 = 0.0
    for k, w in zip(model.keys, model.weights):
        if k == props.CONST1:
            w1 = float(w)
    if w1:
        raw.append(("1", w1, "other", (props.CONST1,), "launch"))

    total = sum(sec for _, sec, _, _, _ in raw)
    for term, sec, group, keys, source in raw:
        rows.append(TermContribution(
            term=term, seconds=sec,
            share=sec / total if total else 0.0,
            group=group, source=source, properties=keys))
    rows.sort(key=lambda r: (-abs(r.seconds), r.source, r.term))

    # the per-property view (breakdown analog) rides in meta
    prop_secs: Dict[str, float] = {}
    for prog, e, scale in ((step_prog, env, 1.0 / n_dev),
                           (coll_prog, cenv, 1.0)):
        P = prog.matrix(e, 1) @ prog.coeff.T + prog.const
        w = {k: float(v) for k, v in zip(model.keys, model.weights)}
        for j, k in enumerate(prog.keys):
            s = w.get(k, 0.0) * float(P[0, j]) * scale
            if s:
                prop_secs[k] = prop_secs.get(k, 0.0) + s
    if w1:
        prop_secs[props.CONST1] = prop_secs.get(props.CONST1, 0.0) + w1

    return Explanation(
        total_seconds=total, rows=rows, phase=spec.phase,
        meta={"device": model.device, "n_dev": n_dev, "dp": dp, "tp": tp,
              "microbatches": plan.microbatches,
              "remat_policy": plan.remat_policy,
              "property_seconds": prop_secs})


# ---------------------------------------------------------------------------
# Backward: project measured-vs-predicted error onto the basis
# ---------------------------------------------------------------------------


@dataclass
class ResidualAttribution:
    """Per-column attribution of a measured-vs-predicted miss.

    ``columns[i]``'s estimated contribution to the (mean) residual is
    ``miss_seconds[i]``; ``epsilon[i]`` is the implied multiplicative
    miscalibration of that column's weight (``measured ≈ predicted +
    Σ εᵢ·sᵢ``)."""

    columns: List[str]
    groups: List[str]
    epsilon: np.ndarray          # per-column multiplicative error estimate
    miss_seconds: np.ndarray     # per-column mean seconds of the residual
    residual_s: float            # mean residual over the window
    n_samples: int

    def shares(self) -> Dict[str, float]:
        """Per-column fraction of the total |attributed| miss."""
        tot = float(np.abs(self.miss_seconds).sum())
        if tot <= 0:
            return {c: 0.0 for c in self.columns}
        return {c: float(abs(s)) / tot
                for c, s in zip(self.columns, self.miss_seconds)}

    def group_shares(self) -> Dict[str, float]:
        """Category → fraction of the |attributed| miss (the "HBM-traffic
        terms account for 78% of the miss" number)."""
        tot = float(np.abs(self.miss_seconds).sum())
        out: Dict[str, float] = {}
        for g, s in zip(self.groups, self.miss_seconds):
            out[g] = out.get(g, 0.0) + abs(float(s))
        if tot > 0:
            out = {g: v / tot for g, v in out.items()}
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def line(self) -> str:
        """One report fragment: ``memory=78% compute=15% …`` plus the mean
        residual."""
        parts = [f"{g}={v*100:.0f}%" for g, v in self.group_shares().items()
                 if v >= 0.005]
        return (f"residual={self.residual_s*1e3:+.3f}ms "
                + " ".join(parts or ["unattributed"]))


def _solve_attribution(B: np.ndarray, r: np.ndarray, columns: List[str],
                       groups: List[str], ridge: float
                       ) -> ResidualAttribution:
    """Ridge least squares ``ε = argmin ‖Bε − r‖² + λ‖ε‖²`` with λ scaled
    to the column energy (scale-free).  B's columns are per-sample
    CONTRIBUTION SECONDS, so ε is dimensionless (a relative weight error)
    and ``B @ ε`` is seconds."""
    n, k = B.shape
    G = B.T @ B
    lam = ridge * (np.trace(G) / k if k else 1.0)
    eps = np.linalg.solve(G + lam * np.eye(k), B.T @ r) if k \
        else np.zeros(0)
    miss = eps * B.mean(axis=0) if k else np.zeros(0)
    return ResidualAttribution(
        columns=columns, groups=groups, epsilon=eps, miss_seconds=miss,
        residual_s=float(r.mean()) if n else 0.0, n_samples=n)


def attribute_residual(program, model, envs: Sequence[Mapping[str, object]],
                       measured_s: Sequence[float], *, scale: float = 1.0,
                       ridge: float = 1e-6) -> ResidualAttribution:
    """Project measured-vs-predicted errors onto the TERM basis of one
    fused program.

    ``envs``/``measured_s`` are a sample window (one env per measured
    wall time; ``scale`` is the caller's work division, as in
    ``explain_program``).  When the envs vary, an error injected on a
    single term's weight is recovered on that term; identical envs give
    the minimum-norm projection (shares ∝ contribution²).
    """
    w_terms, groups_all, _ = _term_groups(program, model)
    live = [int(i) for i in np.nonzero(w_terms)[0]]
    n = len(measured_s)
    B = np.zeros((n, len(live)), dtype=np.float64)
    r = np.zeros(n, dtype=np.float64)
    w = {k: float(v) for k, v in zip(model.keys, model.weights)}
    alpha = np.asarray([w.get(k, 0.0) for k in program.keys])
    c = float(program.const @ alpha) * scale
    for j, env in enumerate(envs):
        vals = program(env)
        pred = c
        for col, i in enumerate(live):
            s = float(w_terms[i]) * float(np.asarray(vals[i], np.float64)) \
                * scale
            B[j, col] = s
            pred += s
        r[j] = float(measured_s[j]) - pred
    return _solve_attribution(
        B, r, [program.term_reprs[i] for i in live],
        [groups_all[i] for i in live], ridge)


def attribute_residual_pv(model, pvs: Sequence[Mapping[str, float]],
                          measured_s: Sequence[float], *,
                          ridge: float = 1e-6) -> ResidualAttribution:
    """Project measured-vs-predicted errors onto the PROPERTY basis.

    This is the telemetry-side frontend: the online calibrator buffers
    (property vector, seconds) samples, so the attribution columns are
    the model's priced properties (``α_k · p_k`` seconds per sample) —
    coarser than the term basis but available wherever a
    ``TelemetrySink`` window is."""
    from repro_torch.core import properties as props
    keys = [k for k, w in zip(model.keys, model.weights)
            if w and any(pv.get(k) for pv in pvs)]
    n = len(measured_s)
    w = {k: float(v) for k, v in zip(model.keys, model.weights)}
    B = np.zeros((n, len(keys)), dtype=np.float64)
    r = np.zeros(n, dtype=np.float64)
    for j, pv in enumerate(pvs):
        for col, k in enumerate(keys):
            B[j, col] = w[k] * float(pv.get(k, 0.0))
        r[j] = float(measured_s[j]) - model.predict(pv)
    return _solve_attribution(B, r, keys,
                              [props.category(k) for k in keys], ridge)
