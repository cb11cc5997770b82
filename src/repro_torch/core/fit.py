"""Weight fitting — paper §4.3.

The paper minimizes *relative* squared error

    Σ_j (1 − Σ_i α_i p_ij / T_j)²,

which is ordinary least squares on the property matrix with row j scaled by
1/T_j and unit targets.  We solve it with numpy lstsq; a small ridge term is
available (useful when the runtime device collapses rate distinctions the
taxonomy keeps separate — e.g. a CPU has no coalescing cliff, so stride
columns become near-collinear; see EXPERIMENTS.md, "Caveats: ridge and
NNLS"), as is projected
non-negative refinement (the paper's fitted weights may legitimately be
negative — Table 2 has negative local-load and min(L,S) entries — so NNLS
is *off* by default).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import properties as props
from repro_torch.core.model import LinearCostModel
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import report as _obs_report

_RLS_QUARANTINED = _obs_metrics.REGISTRY.counter(
    "repro_rls_quarantined_total",
    "streaming calibration samples quarantined (non-finite/non-positive "
    "seconds or non-finite property values) instead of entering the RLS "
    "state")


def fit_relative(pvs: Sequence[Mapping[str, float]],
                 times: Sequence[float],
                 device: str = "unknown",
                 ridge: float = 0.0,
                 nonneg: bool = False,
                 keys: Optional[List[str]] = None) -> LinearCostModel:
    """Fit α minimizing Σ_j (1 − <α, p_j>/T_j)²  (+ ridge ‖D α‖²).

    The ridge penalty is scaled per column by the column norm of the
    T-normalized design matrix, so regularization strength is unit-free.
    """
    assert len(pvs) == len(times) and len(pvs) > 0
    keys = keys or props.union_keys(pvs)
    A = props.to_matrix(list(pvs), keys)  # (J, I)
    T = np.asarray(list(times), dtype=np.float64)
    assert np.all(T > 0), "non-positive measured times"
    An = A / T[:, None]  # row scaling by 1/T_j
    b = np.ones(len(T))

    if ridge > 0.0:
        col = np.linalg.norm(An, axis=0)
        col = np.where(col > 0, col, 1.0)
        R = np.diag(np.sqrt(ridge) * col)
        An = np.vstack([An, R])
        b = np.concatenate([b, np.zeros(len(keys))])

    w, *_ = np.linalg.lstsq(An, b, rcond=None)

    if nonneg:
        w = _nnls_projected(An, b, w)

    model = LinearCostModel(keys=keys, weights=w, device=device,
                            meta={"ridge": ridge, "nonneg": nonneg,
                                  "n_measurements": len(T)})
    return model


def _nnls_projected(A: np.ndarray, b: np.ndarray, w0: np.ndarray,
                    iters: int = 2000, tol: float = 1e-14) -> np.ndarray:
    """Projected-gradient NNLS refinement (scipy-free)."""
    L = np.linalg.norm(A, 2) ** 2
    if L == 0:
        return np.maximum(w0, 0.0)
    step = 1.0 / L
    w = np.maximum(w0, 0.0)
    AtA, Atb = A.T @ A, A.T @ b
    last = np.inf
    for _ in range(iters):
        g = AtA @ w - Atb
        w = np.maximum(w - step * g, 0.0)
        f = 0.5 * w @ AtA @ w - Atb @ w
        if abs(last - f) < tol * max(abs(f), 1.0):
            break
        last = f
    return w


# ---------------------------------------------------------------------------
# Streaming refit — recursive least squares on the relative-error system
# ---------------------------------------------------------------------------


class RLSState:
    """Recursive least squares over the paper's relative-error rows.

    Each sample (property vector ``p``, measured seconds ``T``) contributes
    the row ``a = p / T`` with unit target — exactly ``fit_relative``'s
    T-normalized system, fed one measurement at a time.

    The state is the *information form*: the exponentially-discounted Gram
    ``G = Σ_j lam^(n-j) ã_j ã_jᵀ + lam^n/delta · I`` and right-hand side,
    updated in O(k²) per sample, with the weights solved on demand (k is
    the taxonomy size, ≤ a few dozen, so the O(k³) solve is trivial).  The
    classic covariance form (propagating P = G⁻¹) is O(k²) throughout but
    numerically treacherous here: taxonomy columns span ~9 orders of
    magnitude (an mxu flop count vs the const1 launch term), and the
    P-update's cancellation then corrupts the gains — the well-known RLS
    divergence.  Rows are also column-preconditioned by the first observed
    row (``col_scale``, a pure reparameterization), so the Gram stays
    near-unit scale regardless of the taxonomy's dynamic range.

    Exactness: with forgetting factor ``lam`` and prior ``(w0, delta)``
    this solves

        min_w  Σ_j lam^(n-j) (1 − <a_j, w>)²  +  (lam^n/delta)·‖S(w−w0)‖²

    (S the first-row column scaling), so with ``lam = 1`` and ``delta``
    large it equals batch ``fit_relative`` (ridge 0) on the same sample
    stream up to a vanishing prior term — ``tests/test_online_calibration``
    pins the two at rtol 1e-7.  With ``lam < 1`` it is the exponentially-
    windowed fit that tracks drift: samples older than ~1/(1−lam) steps
    fade from the solution.  A warm start ``from_model`` anchors
    rank-deficient streams (a trainer feeding one property vector forever)
    to the registered weights instead of collapsing unobserved directions
    to zero.
    """

    def __init__(self, keys: Sequence[str], lam: float = 1.0,
                 delta: float = 1e12, w0: Optional[np.ndarray] = None):
        if not 0.0 < lam <= 1.0:
            raise ValueError(f"forgetting factor must be in (0, 1]: {lam}")
        self.keys: List[str] = list(keys)
        self.lam = float(lam)
        self.delta = float(delta)
        k = len(self.keys)
        self.w0 = (np.zeros(k) if w0 is None
                   else np.asarray(w0, dtype=np.float64).copy())
        self.n_samples = 0
        self.n_quarantined = 0
        self.col_scale: Optional[np.ndarray] = None
        self._G: Optional[np.ndarray] = None   # scaled-space Gram + prior
        self._b: Optional[np.ndarray] = None   # scaled-space RHS
        self._w: Optional[np.ndarray] = None   # lazy solve cache

    @classmethod
    def init(cls, keys: Sequence[str], lam: float = 1.0,
             delta: float = 1e12,
             w0: Optional[np.ndarray] = None) -> "RLSState":
        return cls(keys, lam=lam, delta=delta, w0=w0)

    @classmethod
    def from_model(cls, model: LinearCostModel, lam: float = 1.0,
                   delta: float = 1e12) -> "RLSState":
        """Warm-start from a registered model (prior centered on its α)."""
        return cls(model.keys, lam=lam, delta=delta, w0=model.weights)

    # ------------------------------------------------------------------
    @property
    def w(self) -> np.ndarray:
        """Current weight estimate, natural (seconds/event) space."""
        if self._G is None:
            return self.w0.copy()
        if self._w is None:
            v, *_ = np.linalg.lstsq(self._G, self._b, rcond=None)
            self._w = v / self.col_scale
        return self._w

    def row(self, pv: Mapping[str, float], seconds: float) -> np.ndarray:
        if not seconds > 0:
            raise ValueError(f"non-positive measured time: {seconds}")
        return np.asarray([pv.get(k, 0.0) for k in self.keys],
                          dtype=np.float64) / seconds

    def update(self, a: np.ndarray, y: float) -> None:
        """One generic (row, target) recursive step."""
        a = np.asarray(a, dtype=np.float64)
        if self.col_scale is None:
            s = np.abs(a)
            self.col_scale = np.where(s > 0, s, 1.0)
            k = len(self.keys)
            self._G = np.eye(k) / self.delta
            self._b = (self.w0 * self.col_scale) / self.delta
        a = a / self.col_scale
        self._G = self.lam * self._G + np.outer(a, a)
        self._b = self.lam * self._b + a * y
        self._w = None
        self.n_samples += 1

    def observe(self, pv: Mapping[str, float], seconds: float) -> bool:
        """Ingest one (property vector, measured seconds) sample.

        The streaming path must survive a poisoned measurement (a clock
        glitch, an injected NaN): a non-finite/non-positive ``seconds``
        or a non-finite property value is QUARANTINED — counted in
        ``repro_rls_quarantined_total``, reported on a ``[calib]`` line,
        and the state left untouched — instead of raising the
        ``ValueError`` the strict batch path (``fit_relative``) keeps.
        Returns True when the sample entered the state."""
        bad = None
        if not (np.isfinite(seconds) and seconds > 0):
            bad = f"seconds={seconds}"
        else:
            vals = np.asarray([pv.get(k, 0.0) for k in self.keys],
                              dtype=np.float64)
            if not np.all(np.isfinite(vals)):
                bad = "non-finite property value"
        if bad is not None:
            self.n_quarantined += 1
            _RLS_QUARANTINED.inc()
            _obs_report.emit("calib", {
                "action": "quarantine", "n": self.n_quarantined},
                text=f"sample rejected ({bad})")
            return False
        self.update(self.row(pv, seconds), 1.0)
        return True

    def observe_many(self, pvs: Sequence[Mapping[str, float]],
                     times: Sequence[float]) -> None:
        for pv, t in zip(pvs, times):
            self.observe(pv, t)

    def predict(self, pv: Mapping[str, float]) -> float:
        """<w, p> under the current streaming estimate."""
        return float(sum(w * pv.get(k, 0.0)
                         for k, w in zip(self.keys, self.w) if pv.get(k)))

    def model(self, device: str = "rls",
              meta: Optional[dict] = None) -> LinearCostModel:
        """Materialize the current estimate as a ``LinearCostModel``."""
        m = dict(meta or {})
        m.setdefault("source", "rls-refit")
        m.update({"forgetting": self.lam, "n_samples": self.n_samples})
        return LinearCostModel(keys=list(self.keys), weights=self.w.copy(),
                               device=device, meta=m)


# ---------------------------------------------------------------------------
# Learned residual head — ridge regression on the basis features
# ---------------------------------------------------------------------------


@dataclass
class ResidualHead:
    """Multiplicative learned correction on top of the analytic model.

    The hybrid form: the analytic prediction supplies the physics, a small
    ridge-regularized linear head on the (log-compressed, standardized)
    property-vector features learns what the fixed basis cannot express —
    ``T̂ = <α, p> · exp(clip(<β, z(p)>))``.  Working in log space makes the
    correction multiplicative and symmetric (a 2× underprediction and a 2×
    overprediction are equal-magnitude targets); the clip bounds the head's
    authority so a wild extrapolation can never flip a ranking by orders of
    magnitude.
    """

    keys: List[str]
    mean: np.ndarray               # feature standardization, log1p space
    scale: np.ndarray
    beta: np.ndarray               # (len(keys) + 1,), last entry = bias
    clip: float = 2.0              # bound on |log correction|
    meta: Dict[str, object] = field(default_factory=dict)

    def _features(self, pv: Mapping[str, float]) -> np.ndarray:
        x = np.log1p(np.asarray([pv.get(k, 0.0) for k in self.keys],
                                dtype=np.float64))
        return (x - self.mean) / self.scale

    def log_correction(self, pv: Mapping[str, float]) -> float:
        z = self._features(pv)
        raw = float(z @ self.beta[:-1] + self.beta[-1])
        return float(np.clip(raw, -self.clip, self.clip))

    def correction(self, pv: Mapping[str, float]) -> float:
        """The multiplicative factor applied to the analytic prediction."""
        return float(np.exp(self.log_correction(pv)))

    def predict(self, model: LinearCostModel,
                pv: Mapping[str, float]) -> float:
        return model.predict(pv) * self.correction(pv)

    # -- serialization -----------------------------------------------------
    def to_json_dict(self) -> Dict[str, object]:
        return {"kind": "residual_head", "keys": list(self.keys),
                "mean": self.mean.tolist(), "scale": self.scale.tolist(),
                "beta": self.beta.tolist(), "clip": self.clip,
                "meta": self.meta}

    @classmethod
    def from_json_dict(cls, d: Mapping[str, object]) -> "ResidualHead":
        if d.get("kind") != "residual_head":
            raise ValueError(f"not a residual_head record: {d.get('kind')!r}")
        return cls(keys=list(d["keys"]),
                   mean=np.asarray(d["mean"], dtype=np.float64),
                   scale=np.asarray(d["scale"], dtype=np.float64),
                   beta=np.asarray(d["beta"], dtype=np.float64),
                   clip=float(d.get("clip", 2.0)),
                   meta=dict(d.get("meta", {})))


def fit_residual(pvs: Sequence[Mapping[str, float]],
                 times: Sequence[float], model: LinearCostModel,
                 ridge: float = 1e-2, clip: float = 2.0,
                 keys: Optional[List[str]] = None
                 ) -> Optional[ResidualHead]:
    """Fit a ``ResidualHead`` on the samples' log-ratio residuals.

    Targets are ``log(T_j / <α, p_j>)``; rows where either side is
    non-positive carry no usable log-ratio and are skipped.  Returns None
    when fewer than 2 usable samples remain (no head is better than a head
    fit on nothing).
    """
    keys = keys or props.union_keys(pvs)
    preds = np.asarray(model.predict_many(list(pvs)), dtype=np.float64)
    T = np.asarray(list(times), dtype=np.float64)
    ok = (preds > 0) & (T > 0)
    if int(ok.sum()) < 2:
        return None
    X = np.log1p(props.to_matrix([pvs[i] for i in np.nonzero(ok)[0]], keys))
    y = np.log(T[ok] / preds[ok])
    mean = X.mean(axis=0)
    scale = X.std(axis=0)
    scale = np.where(scale > 1e-12, scale, 1.0)
    Z = np.hstack([(X - mean) / scale, np.ones((X.shape[0], 1))])
    # ridge on the feature weights only; the bias column stays unpenalized
    R = np.sqrt(ridge * len(y)) * np.eye(len(keys) + 1)
    R[-1, -1] = 0.0
    A = np.vstack([Z, R])
    b = np.concatenate([y, np.zeros(len(keys) + 1)])
    beta, *_ = np.linalg.lstsq(A, b, rcond=None)
    return ResidualHead(keys=list(keys), mean=mean, scale=scale, beta=beta,
                        clip=clip,
                        meta={"ridge": ridge, "n_samples": int(ok.sum())})


# ---------------------------------------------------------------------------
# Fit diagnostics
# ---------------------------------------------------------------------------


def safe_relative_errors(preds: Sequence[float], times: Sequence[float],
                         floor: float = 1e-12) -> np.ndarray:
    """|pred − actual| / actual with zero/near-zero timings mapped to inf.

    Fast measurement kernels can legitimately time at (or below) clock
    resolution; a report must flag those rows as unreliable, not crash on
    the division.  Rows with ``actual <= floor`` come back as ``inf``.
    """
    p = np.asarray(list(preds), dtype=np.float64)
    t = np.asarray(list(times), dtype=np.float64)
    out = np.full(t.shape, np.inf)
    ok = t > floor
    out[ok] = np.abs(p[ok] - t[ok]) / t[ok]
    return out


def fit_report(model: LinearCostModel, pvs: Sequence[Mapping[str, float]],
               times: Sequence[float],
               labels: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Per-kernel relative errors + geomean (paper Table 1 bottom row).

    Zero/near-zero timings report ``inf`` per-row errors (see
    ``safe_relative_errors``) and are excluded from the geomean/max
    summaries, which cover the ``n_finite`` reliable rows."""
    from repro_torch.core.model import geomean
    preds = model.predict_many(list(pvs))
    errs = safe_relative_errors(preds, times)
    rows = []
    for i, (p, t, e) in enumerate(zip(preds, times, errs)):
        rows.append({
            "label": labels[i] if labels else str(i),
            "predicted_s": float(p), "actual_s": float(t),
            "rel_err": float(e),
        })
    finite = errs[np.isfinite(errs)]
    return {"rows": rows,
            "geomean_rel_err": geomean(finite) if len(finite)
            else float("inf"),
            "max_rel_err": float(finite.max()) if len(finite)
            else float("inf"),
            "n": len(errs), "n_finite": int(len(finite))}


def condition_report(pvs: Sequence[Mapping[str, float]],
                     times: Sequence[float]) -> Dict[str, float]:
    """Design-matrix conditioning of the T-normalized system.

    Rows with zero/near-zero timings cannot be T-normalized; they are
    dropped from the conditioning analysis and counted in ``n_dropped``."""
    keys = props.union_keys(pvs)
    T = np.asarray(list(times), dtype=np.float64)
    ok = T > 1e-12
    A = props.to_matrix([pv for pv, k in zip(pvs, ok) if k],
                        keys) / T[ok][:, None]
    if A.shape[0] == 0:
        return {"n_rows": 0, "n_cols": len(keys), "rank": 0,
                "cond": float("inf"), "n_dropped": int((~ok).sum())}
    s = np.linalg.svd(A, compute_uv=False)
    s = s[s > 0]
    return {"n_rows": A.shape[0], "n_cols": A.shape[1],
            "rank": int(np.linalg.matrix_rank(A)),
            "cond": float(s[0] / s[-1]) if len(s) else float("inf"),
            "n_dropped": int((~ok).sum())}
