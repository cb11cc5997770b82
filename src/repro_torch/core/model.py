"""The linear cost model — paper §2:  T_wall(n) ≈ Σ_i α_i · p_i(n).

A ``LinearCostModel`` is just (ordered property names, weights α, metadata).
Prediction is the small inner product the paper advertises; weights carry
units of seconds/event and are directly interpretable (Table 2 analog via
``interpretation_report``).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional

import numpy as np

from repro_torch.core import properties as props

# Registry file-format version (see repro.calibration.registry).  v1 adds the
# explicit "schema"/"kind" envelope; files without it are legacy v0 and are
# accepted by ``from_json_dict`` for backward compatibility.
SCHEMA_VERSION = 1


class ModelSchemaError(ValueError):
    """A serialized model has an unreadable or future schema."""


class FutureSchemaError(ModelSchemaError):
    """The schema postdates this checkout — a VERSION problem, not file
    corruption.  The hardened registry fallback re-raises this instead of
    degrading to an older revision: falling back would silently mask the
    need to upgrade."""


@dataclass
class LinearCostModel:
    keys: List[str]
    weights: np.ndarray  # (len(keys),) seconds per event
    device: str = "unknown"
    meta: Dict[str, object] = field(default_factory=dict)

    # ------------------------------------------------------------------
    def predict(self, pv: Mapping[str, float]) -> float:
        """<α, p> — evaluation is a small inner product (paper §1, item 5)."""
        t = 0.0
        for k, w in zip(self.keys, self.weights):
            v = pv.get(k)
            if v:
                t += w * v
        return float(t)

    def predict_many(self, pvs: List[Mapping[str, float]]) -> np.ndarray:
        A = props.to_matrix(pvs, self.keys)
        return A @ self.weights

    def breakdown(self, pv: Mapping[str, float]) -> Dict[str, float]:
        """Per-property contribution in seconds (cost attribution)."""
        out = {}
        for k, w in zip(self.keys, self.weights):
            v = pv.get(k)
            if v:
                out[k] = float(w * v)
        return dict(sorted(out.items(), key=lambda kv: -abs(kv[1])))

    # ------------------------------------------------------------------
    def interpretation_report(self) -> str:
        """Table-2 analog: weight per property, seconds/operation."""
        lines = [f"# fitted weights — device: {self.device}",
                 f"{'property':<44} {'weight (s/event)':>16}"]
        for k, w in sorted(zip(self.keys, self.weights),
                           key=lambda kw: -abs(kw[1])):
            lines.append(f"{props.pretty(k):<44} {w: .3e}")
        return "\n".join(lines)

    # ------------------------------------------------------------------
    def to_json_dict(self) -> Dict[str, object]:
        """Versioned JSON envelope.  ``json`` emits float64 via ``repr``
        (shortest exact form), so weights round-trip bitwise."""
        return {
            "schema": SCHEMA_VERSION,
            "kind": "linear_cost_model",
            "device": self.device,
            "keys": list(self.keys),
            "weights": [float(w) for w in self.weights],
            "meta": self.meta,
        }

    @classmethod
    def from_json_dict(cls, d: Mapping[str, object]) -> "LinearCostModel":
        schema = d.get("schema", 0)  # pre-versioning files are legacy v0
        if isinstance(schema, int) and schema > SCHEMA_VERSION:
            raise FutureSchemaError(
                f"model schema {schema!r} is newer than supported "
                f"({SCHEMA_VERSION}); upgrade this checkout to read it")
        if not isinstance(schema, int):
            raise ModelSchemaError(f"model schema {schema!r} is not an int")
        if schema >= 1 and d.get("kind") != "linear_cost_model":
            raise ModelSchemaError(
                f"not a linear_cost_model record: kind={d.get('kind')!r}")
        keys = list(d["keys"])
        weights = np.asarray(d["weights"], dtype=np.float64)
        if len(keys) != len(weights):
            raise ModelSchemaError(
                f"{len(keys)} keys but {len(weights)} weights")
        return cls(keys=keys, weights=weights,
                   device=str(d.get("device", "unknown")),
                   meta=dict(d.get("meta", {})))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json_dict(), f, indent=1)

    @classmethod
    def load(cls, path: str) -> "LinearCostModel":
        with open(path) as f:
            return cls.from_json_dict(json.load(f))

    @classmethod
    def from_dict(cls, weights: Mapping[str, float], device: str = "analytic",
                  meta: Optional[dict] = None) -> "LinearCostModel":
        keys = sorted(weights)
        return cls(keys=keys, weights=np.asarray([weights[k] for k in keys]),
                   device=device, meta=meta or {})


def relative_error(pred: float, actual: float) -> float:
    """|pred - actual| / actual — the paper's §5 error metric."""
    return abs(pred - actual) / actual


def geomean(xs) -> float:
    """Geometric mean — Fleming & Wallace summary of normalized values."""
    xs = np.asarray(list(xs), dtype=np.float64)
    xs = np.maximum(xs, 1e-12)
    return float(np.exp(np.mean(np.log(xs))))
