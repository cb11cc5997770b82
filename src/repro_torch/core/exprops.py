"""Algebraic optimization + fused basis-matrix lowering for the symbolic
cost model.

The paper's premise is that wall time is *linear in symbolically gathered
counts* — ``T ≈ <α, p(n)>`` — and this module exploits that linearity end
to end.  Where ``symcount.CompiledVector`` compiles each property's
``Expr`` to an independent closure (so shared subterms re-evaluate once
per property per call, and scoring loops model keys in Python), here a
whole property-vector map lowers to ONE **fused basis program**:

  1. **canonicalize** every tree (``simplify``): n-ary Add/Mul flattening
     with constant folding and like-term collection, constant Piecewise
     guards resolved and else-chains hoisted flat, ``Max``/``Min``
     flattening, ``Pow`` identities;
  2. **decompose** each property into a linear combination of non-constant
     *basis terms* (coefficients pulled out of the canonical Mul forms) and
     **deduplicate the terms across all properties** — the model's
     linearity means a term shared by three properties is worth one column,
     not three;
  3. **lower** all deduped terms into a single generated numpy function
     with DAG-level common-subexpression elimination: every distinct
     subtree becomes one assignment, evaluated once per call no matter how
     many terms (or properties) reference it.

Evaluating the program over an array environment yields the **basis
matrix** ``B`` (cells × terms); folding a ``LinearCostModel`` through the
coefficient matrix gives a per-term weight vector ``w̃ = Cᵀ·α``, so scoring
an entire candidate space is ``B @ w̃`` — one GEMV.  ``score_cells`` adds
the *gathered-counts* fast path on top: array environments in a plan sweep
carry massive duplication (every mesh repeats each plan's microbatch
count, every plan repeats each mesh's dp/tp ways), so the program
evaluates on the UNIQUE environment rows and scatters back — the basis
matrix never grows past the distinct-row count.

Two more layers ride on the same decomposition:

  * **incremental rescoring** (``BasisCache``): basis columns cache keyed
    by (term, the fingerprint of the term's OWN free-variable values), so
    a device-count delta between two ``elastic.replan`` calls recomputes
    only the DP/TP-dependent columns — everything keyed on (B, S, M) comes
    back from cache;
  * a **persistent on-disk compile cache** (``load_or_build``): programs
    serialize as (generated source + coefficient matrices) keyed by a
    canonical content hash + the model schema version, so repeated CLI
    invocations skip symbolic simplification and codegen entirely.

Consumers: ``core.planspace`` (fused ``PlanSpace.scores``), ``core.
predictor`` (fused step programs), ``distributed.elastic`` /
``runtime.straggler`` (cached incremental rescores), ``kernels.autotune``
(the block-grid scoring).

A copy of the reference's ``core/exprops.py``.  The compile cache reads the
same ``REPRO_COMPILE_CACHE`` variable, defaults to
``~/.cache/repro_torch/exprops`` and fingerprints this package's formula
modules, so the two packages never serve each other's programs.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.lru import LRUCache
from repro_torch.core.model import SCHEMA_VERSION
from repro_torch.core.symcount import (
    Add, CeilDiv, Const, Expr, ExprLike, FloorDiv, Max, Min, Mul, Piecewise,
    Pow, Var, as_expr,
)
from repro_torch.obs import metrics as _obs_metrics

# registry-side telemetry (repro_torch.obs.metrics is dependency-free, so
# this import can never cycle): BasisCache column probes and the disk compile
# cache both publish here, alongside their instance/module views.
_BASIS_HITS = _obs_metrics.REGISTRY.counter(
    "repro_basis_cache_hits_total",
    "BasisCache column probes served from cache")
_BASIS_MISSES = _obs_metrics.REGISTRY.counter(
    "repro_basis_cache_misses_total",
    "BasisCache column probes that recomputed the column")
_BASIS_INVALIDATIONS = _obs_metrics.REGISTRY.counter(
    "repro_basis_cache_invalidations_total",
    "BasisCache.clear() epochs (drift refits, explicit resets)")

#: bump when the canonical form, codegen, or serialization layout changes —
#: part of every disk-cache key, so stale programs can never load.
FORMAT_VERSION = 1


# ---------------------------------------------------------------------------
# Canonicalization — n-ary flattening, constant folding, Piecewise hoisting
# ---------------------------------------------------------------------------


def _addends(e: Expr):
    if isinstance(e, Add):
        yield from _addends(e.a)
        yield from _addends(e.b)
    else:
        yield e


def _factors(e: Expr):
    if isinstance(e, Mul):
        yield from _factors(e.a)
        yield from _factors(e.b)
    else:
        yield e


def _split_coeff(e: Expr) -> Tuple[float, Optional[Expr]]:
    """Canonical-form addend → (coefficient, non-constant part|None).

    Simplified Mul chains carry at most one ``Const`` and it leads, so this
    is a shape check, not a search."""
    if isinstance(e, Const):
        return e.v, None
    if isinstance(e, Mul) and isinstance(e.a, Const):
        return e.a.v, e.b
    return 1, e


def _rebuild_mul(coeff, factors: Sequence[Expr]) -> Expr:
    if coeff == 0 or not factors:
        return Const(coeff)
    out = factors[0]
    for f in factors[1:]:
        out = Mul(out, f)
    if coeff != 1:
        out = Mul(Const(coeff), out)
    return out


def _rebuild_add(const, pairs: Sequence[Tuple[float, Expr]]) -> Expr:
    parts = [_rebuild_mul(c, [t]) if c != 1 else t for c, t in pairs]
    if const != 0 or not parts:
        parts.append(Const(const))
    out = parts[0]
    for p in parts[1:]:
        out = Add(out, p)
    return out


def simplify(e: ExprLike, _memo: Optional[dict] = None) -> Expr:
    """Canonicalize ``e`` preserving ``eval`` semantics.

    Integer-only trees simplify *exactly* (Python int arithmetic is
    arbitrary precision and the rewrites are value-preserving); float
    constants may reassociate, changing results only at rounding level —
    the fused-vs-loop goldens pin rtol ≤ 1e-9.

    Rewrites: Add/Mul flattened n-ary with constants folded and like terms
    collected (terms ordered by canonical repr, so structurally equal sums
    canonicalize identically regardless of construction order); constant
    distribution over sums; ``Pow`` k∈{0,1} and constant-base folding;
    constant FloorDiv/CeilDiv folding; Max/Min flattened, deduped, constant
    args pre-folded; Piecewise else-chains hoisted flat, constant guards
    resolved, duplicate/dead branches dropped.
    """
    e = as_expr(e)
    memo: dict = {} if _memo is None else _memo
    return _simp(e, memo)


def _simp(e: Expr, memo: dict) -> Expr:
    out = memo.get(e)
    if out is not None:
        return out
    out = _simp_node(e, memo)
    memo[e] = out
    return out


def _simp_node(e: Expr, memo: dict) -> Expr:
    if isinstance(e, (Const, Var)):
        return e

    if isinstance(e, Add):
        const = 0
        coeffs: Dict[Expr, float] = {}
        order: List[Expr] = []
        for raw in _addends(e):
            s = _simp(raw, memo)
            for ad in _addends(s):      # children may simplify to sums
                c, t = _split_coeff(ad)
                if t is None:
                    const += c
                else:
                    if t not in coeffs:
                        coeffs[t] = 0
                        order.append(t)
                    coeffs[t] += c
        order.sort(key=repr)
        pairs = [(coeffs[t], t) for t in order if coeffs[t] != 0]
        return _rebuild_add(const, pairs)

    if isinstance(e, Mul):
        coeff = 1
        factors: List[Expr] = []
        for raw in _factors(e):
            s = _simp(raw, memo)
            for f in _factors(s):
                c, t = _split_coeff(f)
                coeff *= c
                if t is not None:
                    factors.append(t)
        if coeff == 0:
            return Const(0)
        factors.sort(key=repr)
        if len(factors) == 1 and isinstance(factors[0], Add):
            # distribute the constant over the (already canonical) sum so
            # cross-property dedup sees the shared addends, not one blob
            inner_const, pairs = _linear_parts(factors[0])
            return _rebuild_add(inner_const * coeff,
                                [(c * coeff, t) for c, t in pairs])
        return _rebuild_mul(coeff, factors)

    if isinstance(e, Pow):
        a = _simp(e.a, memo)
        if e.k == 0:
            return Const(1)
        if e.k == 1:
            return a
        if isinstance(a, Const):
            return Const(a.v ** e.k)
        return Pow(a, e.k)

    if isinstance(e, FloorDiv):
        a, b = _simp(e.a, memo), _simp(e.b, memo)
        if isinstance(a, Const) and isinstance(b, Const) and b.v != 0:
            return Const(a.v // b.v)
        return FloorDiv(a, b)

    if isinstance(e, CeilDiv):
        a, b = _simp(e.a, memo), _simp(e.b, memo)
        if isinstance(a, Const) and isinstance(b, Const) and b.v != 0:
            return Const(-((-a.v) // b.v))
        return CeilDiv(a, b)

    if isinstance(e, (Max, Min)):
        cls = type(e)
        red = max if cls is Max else min
        cval = None
        args: List[Expr] = []
        seen = set()
        for raw in e.args:
            s = _simp(raw, memo)
            flat = s.args if isinstance(s, cls) else (s,)
            for f in flat:
                if isinstance(f, Const):
                    cval = f.v if cval is None else red(cval, f.v)
                elif f not in seen:
                    seen.add(f)
                    args.append(f)
        if not args:
            return Const(cval)
        if cval is not None:
            args.append(Const(cval))
        if len(args) == 1:
            return args[0]
        return cls(*sorted(args, key=repr))

    if isinstance(e, Piecewise):
        branches: List[Tuple[Expr, Expr]] = []
        stack = [e]
        otherwise = None
        while stack:                      # hoist nested else-chains flat
            pw = stack.pop()
            branches.extend(pw.branches)
            if isinstance(pw.otherwise, Piecewise):
                stack.append(pw.otherwise)
            else:
                otherwise = pw.otherwise
        otherwise = _simp(otherwise, memo)
        out_branches: List[Tuple[Expr, Expr]] = []
        seen_guards = set()
        for g, v in branches:
            g, v = _simp(g, memo), _simp(v, memo)
            if isinstance(g, Const):
                if g.v > 0:               # always fires if reached
                    otherwise = v
                    break
                continue                  # never fires: dead branch
            if g in seen_guards:          # earlier identical guard shadows
                continue
            seen_guards.add(g)
            out_branches.append((g, v))
        while out_branches and out_branches[-1][1] == otherwise:
            out_branches.pop()            # branch value = fallthrough value
        if not out_branches:
            return otherwise
        return Piecewise(out_branches, otherwise)

    raise TypeError(f"cannot canonicalize {type(e).__name__}")


def _linear_parts(e: Expr) -> Tuple[float, List[Tuple[float, Expr]]]:
    """Top-level linear decomposition of an ALREADY simplified expr."""
    const = 0
    pairs: List[Tuple[float, Expr]] = []
    for ad in _addends(e):
        c, t = _split_coeff(ad)
        if t is None:
            const += c
        else:
            pairs.append((c, t))
    return const, pairs


def linear_terms(e: ExprLike) -> Tuple[float, List[Tuple[float, Expr]]]:
    """``simplify`` + split into (constant, [(coeff, basis term), ...])."""
    return _linear_parts(simplify(e))


# ---------------------------------------------------------------------------
# Fused lowering — one generated numpy function for ALL basis terms
# ---------------------------------------------------------------------------


class _Emitter:
    """DAG-level CSE codegen: every distinct subtree (by canonical repr)
    becomes one assignment in the generated function body."""

    def __init__(self, argnames: Mapping[str, str]):
        self.argnames = argnames
        self.lines: List[str] = []
        self._slots: Dict[Expr, str] = {}
        self._n = 0

    def _new_slot(self, rhs: str) -> str:
        name = f"_v{self._n}"
        self._n += 1
        self.lines.append(f"{name} = {rhs}")
        return name

    def ref(self, e: Expr) -> str:
        if isinstance(e, Const):
            return repr(e.v)
        if isinstance(e, Var):
            return self.argnames[e.name]
        slot = self._slots.get(e)
        if slot is None:
            slot = self._new_slot(self._rhs(e))
            self._slots[e] = slot
        return slot

    def _rhs(self, e: Expr) -> str:
        if isinstance(e, Add):
            return f"{self.ref(e.a)} + {self.ref(e.b)}"
        if isinstance(e, Mul):
            return f"{self.ref(e.a)} * {self.ref(e.b)}"
        if isinstance(e, Pow):
            a = self.ref(e.a)
            if e.k < 0:   # int arrays reject negative powers; go via float64
                return f"_np.asarray({a}, dtype=_np.float64) ** {e.k}"
            return f"{a} ** {e.k}"
        if isinstance(e, FloorDiv):
            return f"_np.floor_divide({self.ref(e.a)}, {self.ref(e.b)})"
        if isinstance(e, CeilDiv):
            return f"-_np.floor_divide(-({self.ref(e.a)}), {self.ref(e.b)})"
        if isinstance(e, Max):
            out = self.ref(e.args[0])
            for a in e.args[1:]:
                out = f"_np.maximum({out}, {self.ref(a)})"
                out = self._new_slot(out)
            return out
        if isinstance(e, Min):
            out = self.ref(e.args[0])
            for a in e.args[1:]:
                out = f"_np.minimum({out}, {self.ref(a)})"
                out = self._new_slot(out)
            return out
        if isinstance(e, Piecewise):
            out = self.ref(e.otherwise)
            for g, v in reversed(e.branches):   # first truthy guard wins
                out = self._new_slot(
                    f"_np.where({self.ref(g)} > 0, {self.ref(v)}, {out})")
            return out
        raise TypeError(f"cannot lower {type(e).__name__}")


def _codegen(terms: Sequence[Expr], params: Sequence[str]) -> str:
    names = {v: f"_a{i}" for i, v in enumerate(params)}
    em = _Emitter(names)
    outs = [em.ref(t) for t in terms]
    args = "".join(f", {names[v]}" for v in params)
    body = "\n    ".join(em.lines) if em.lines else "pass"
    ret = ", ".join(outs)
    return (f"def _fused(_np{args}):\n"
            f"    {body}\n"
            f"    return ({ret}{',' if len(outs) == 1 else ''})")


def _compile_source(source: str) -> Callable:
    ns: Dict[str, object] = {}
    exec(compile(source, "<exprops.codegen>", "exec"), ns)
    return ns["_fused"]


def _term_source(term_repr_emit: str, params: Sequence[str],
                 names: Mapping[str, str]) -> str:
    args = "".join(f", {names[v]}" for v in params)
    return f"lambda _np{args}: {term_repr_emit}"


class BasisProgram:
    """A property-vector map lowered to deduped basis terms + coefficients.

    ``keys[k]``'s value is ``const[k] + Σ_i coeff[k, i] · term_i(env)``.
    ``__call__(env)`` evaluates ALL terms through the single CSE'd
    generated function; ``score`` folds a model's weights through ``coeff``
    into one per-term vector and returns the GEMV.
    """

    __slots__ = ("keys", "params", "coeff", "const", "terms", "term_reprs",
                 "term_params", "term_srcs", "source", "_fn", "_term_fns",
                 "_fold_cache")

    def __init__(self, keys, params, coeff, const, term_reprs, term_params,
                 term_srcs, source, terms=None):
        self.keys = list(keys)
        self.params = tuple(params)
        self.coeff = np.zeros((len(self.keys), len(term_reprs)),
                              dtype=np.float64)
        if self.coeff.size:
            self.coeff[:] = np.asarray(coeff, dtype=np.float64).reshape(
                self.coeff.shape)
        self.const = np.asarray(const, dtype=np.float64)
        self.terms = terms               # Expr objects; None when disk-loaded
        self.term_reprs = list(term_reprs)
        self.term_params = [tuple(p) for p in term_params]
        self.term_srcs = list(term_srcs)
        self.source = source
        self._fn = _compile_source(source)
        self._term_fns: Dict[int, Callable] = {}
        self._fold_cache: LRUCache = LRUCache(maxsize=16)

    # -- construction ------------------------------------------------------
    @classmethod
    def build(cls, pv: Mapping[str, ExprLike]) -> "BasisProgram":
        memo: dict = {}
        keys = list(pv)
        const = np.zeros(len(keys), dtype=np.float64)
        terms: List[Expr] = []
        index: Dict[Expr, int] = {}
        entries: List[List[Tuple[int, float]]] = []
        for k, raw in pv.items():
            row: List[Tuple[int, float]] = []
            if isinstance(raw, Expr):
                c0, pairs = _linear_parts(_simp(raw, memo))
                const[len(entries)] = c0
                for c, t in pairs:
                    i = index.get(t)
                    if i is None:
                        i = index[t] = len(terms)
                        terms.append(t)
                    row.append((i, c))
            else:
                const[len(entries)] = float(raw)
            entries.append(row)
        coeff = np.zeros((len(keys), len(terms)), dtype=np.float64)
        for r, row in enumerate(entries):
            for i, c in row:
                coeff[r, i] += c
        params = sorted(set().union(*(t.free_vars() for t in terms))
                        if terms else set())
        term_params = [tuple(sorted(t.free_vars())) for t in terms]
        names = {v: f"_a{i}" for i, v in enumerate(params)}
        term_srcs = [_term_source(t._emit(names), tp, names)
                     for t, tp in zip(terms, term_params)]
        source = _codegen(terms, params)
        return cls(keys, params, coeff, const, [repr(t) for t in terms],
                   term_params, term_srcs, source, terms=terms)

    # -- evaluation --------------------------------------------------------
    @property
    def n_terms(self) -> int:
        return len(self.term_reprs)

    def __call__(self, env: Mapping[str, object]) -> tuple:
        return self._fn(np, *(env[p] for p in self.params))

    def matrix(self, env: Mapping[str, object], n: int) -> np.ndarray:
        """The basis matrix ``B``: (n, n_terms) float64."""
        vals = self(env)
        B = np.empty((n, self.n_terms), dtype=np.float64)
        for i, v in enumerate(vals):
            B[:, i] = np.broadcast_to(np.asarray(v, dtype=np.float64), (n,))
        return B

    def property_columns(self, env: Mapping[str, object], n: int
                         ) -> Dict[str, np.ndarray]:
        """Per-property columns (the ``CompiledVector`` contract), via the
        fused program: ``B @ coeffᵀ + const``."""
        P = self.matrix(env, n) @ self.coeff.T + self.const
        return {k: P[:, j] for j, k in enumerate(self.keys)}

    # -- model folding + GEMV scoring --------------------------------------
    def fold(self, model) -> Tuple[np.ndarray, float]:
        """(per-term weights ``w̃ = Cᵀ·α``, constant seconds) for ``model``.

        Memoized per model instance; the entry keeps a strong reference to
        the model so an id() can never be recycled while cached."""
        return self._folded(model)[:2]

    def _folded(self, model):
        hit = self._fold_cache.get(id(model))
        if hit is not None and hit[3] is model:
            return hit
        # id miss: fall back to a content key, so freshly-built but equal
        # models (e.g. resolve_model(None) per call) still reuse the fold
        ckey = (model.device, hash(model.weights.tobytes()),
                hash(tuple(model.keys)))
        hit = self._fold_cache.get(ckey)
        if hit is not None:
            return hit
        w = {k: float(v) for k, v in zip(model.keys, model.weights)}
        alpha = np.asarray([w.get(k, 0.0) for k in self.keys])
        w_terms = self.coeff.T @ alpha
        w_const = float(self.const @ alpha)
        # (term index, Python-float weight) pairs: the GEMV unrolled, so
        # scalar basis terms (from scalar env entries) stay in native
        # Python arithmetic instead of paying per-term ufunc dispatch
        nz = [(int(i), float(w_terms[i])) for i in np.nonzero(w_terms)[0]]
        entry = (w_terms, w_const, nz, model)
        self._fold_cache[id(model)] = entry
        self._fold_cache[ckey] = entry
        return entry

    def score(self, env: Mapping[str, object], model):
        """``B @ w̃ + const`` for one (array) environment — scalar or
        broadcastable array, matching the env entries.  (The GEMV runs
        unrolled over the folded nonzero weights; see ``_folded``.)"""
        _, w_const, nz, _ = self._folded(model)
        if not nz:
            return w_const
        vals = self._fn(np, *(env[p] for p in self.params))
        total = w_const
        for i, w in nz:
            total = total + w * vals[i]
        return total

    def term_fn(self, i: int) -> Callable:
        fn = self._term_fns.get(i)
        if fn is None:
            fn = eval(compile(self.term_srcs[i], "<exprops.term>", "eval"))
            self._term_fns[i] = fn
        return fn

    def explain(self, env: Mapping[str, object], model, *,
                scale: float = 1.0, source: str = "step"):
        """Per-term attribution of ``scale · score(env, model)``: a list of
        (term repr, seconds, category, fed property keys) rows — the folded
        constant appears as term ``"1"`` — whose seconds sum exactly to the
        fused GEMV score.  Delegates to ``repro_torch.obs.explain``
        (imported lazily; ``obs.explain`` sits above core)."""
        from repro_torch.obs.explain import explain_program
        return explain_program(self, env, model, scale=scale, source=source)

    # -- serialization (the on-disk compile cache) -------------------------
    def to_json_dict(self) -> Dict[str, object]:
        return {
            "format": FORMAT_VERSION,
            "model_schema": SCHEMA_VERSION,
            "keys": self.keys,
            "params": list(self.params),
            "coeff": self.coeff.tolist(),
            "const": self.const.tolist(),
            "term_reprs": self.term_reprs,
            "term_params": [list(p) for p in self.term_params],
            "term_srcs": self.term_srcs,
            "source": self.source,
        }

    @classmethod
    def from_json_dict(cls, d: Mapping[str, object]) -> "BasisProgram":
        if d.get("format") != FORMAT_VERSION \
                or d.get("model_schema") != SCHEMA_VERSION:
            raise ValueError("stale fused-program record")
        return cls(d["keys"], d["params"], d["coeff"], d["const"],
                   d["term_reprs"], d["term_params"], d["term_srcs"],
                   d["source"])


def build_program(pv: Mapping[str, ExprLike]) -> BasisProgram:
    return BasisProgram.build(pv)


# ---------------------------------------------------------------------------
# Cell scoring — unique-environment gather/scatter + incremental cache
# ---------------------------------------------------------------------------


def _unique_rows(cols: List[np.ndarray]
                 ) -> Tuple[List[np.ndarray], np.ndarray]:
    """(unique value rows per column, inverse indices).  Integer columns
    pack into one int64 key when the value ranges allow (one ``np.unique``
    over scalars instead of a lexicographic row sort); tiny inputs dedup
    through a plain dict — numpy's sort setup dwarfs the work there."""
    n = len(cols[0])
    if n <= 64:
        pos: Dict[tuple, int] = {}
        inv = np.empty(n, dtype=np.intp)
        order: List[tuple] = []
        for i, row in enumerate(zip(*(c.tolist() for c in cols))):
            k = pos.get(row)
            if k is None:
                k = pos[row] = len(order)
                order.append(row)
            inv[i] = k
        dtypes = [c.dtype for c in cols]
        return [np.asarray([r[j] for r in order], dtype=dt)
                for j, dt in enumerate(dtypes)], inv
    if all(np.issubdtype(c.dtype, np.integer) for c in cols):
        mins = [int(c.min()) for c in cols]
        spans = [int(c.max()) - m + 1 for c, m in zip(cols, mins)]
        total = 1
        for s in spans:
            total *= s
        if total < 2 ** 62:
            key = np.zeros(len(cols[0]), dtype=np.int64)
            for c, m, s in zip(cols, mins, spans):
                key = key * s + (c.astype(np.int64) - m)
            _, first, inv = np.unique(key, return_index=True,
                                      return_inverse=True)
            return [c[first] for c in cols], inv.reshape(-1)
    stacked = np.stack([np.asarray(c) for c in cols], axis=1)
    rows, inv = np.unique(stacked, axis=0, return_inverse=True)
    return [rows[:, j] for j in range(rows.shape[1])], inv.reshape(-1)


def _is_array(v) -> bool:
    return isinstance(v, np.ndarray) and v.ndim > 0


class BasisCache:
    """Column-level cache for incremental rescoring.

    Keys are ``(term canonical repr, fingerprint of the term's own
    free-variable values)`` — the *unique rows* of exactly the variables
    the term reads.  A replan delta that changes only the device count
    leaves every (B, S, M)-keyed column's fingerprint intact, so only the
    DP/TP-dependent columns recompute.  ``hits``/``misses`` count column
    probes (the acceptance telemetry for warm replans)."""

    def __init__(self, maxsize: int = 4096):
        self._lru: LRUCache = LRUCache(maxsize=maxsize)
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._lru),
                "invalidations": self.invalidations}

    def clear(self) -> None:
        """Drop every cached column (hit/miss telemetry survives).

        The online-calibration path calls this on a drift refit: basis
        columns themselves are weight-independent, but a monitor that
        cached columns for a now-diverged regime must re-derive against
        whatever the refit environment produces — and an explicit epoch
        here keeps 'no stale entries after refit' a checkable invariant
        rather than an argument about key structure."""
        self._lru = LRUCache(maxsize=self._lru.maxsize)
        self.invalidations += 1
        _BASIS_INVALIDATIONS.inc()


def _fingerprint(var_names: Tuple[str, ...], scalars: tuple,
                 rows: Optional[List[np.ndarray]]) -> tuple:
    if rows is None:
        return (var_names, scalars)
    h = hashlib.blake2b(digest_size=16)
    for r in rows:
        h.update(np.ascontiguousarray(r).tobytes())
        h.update(r.dtype.str.encode())
    return (var_names, scalars, len(rows[0]) if rows else 0, h.digest())


def score_cells(program: BasisProgram, env: Mapping[str, object],
                n_cells: int, model, cache: Optional[BasisCache] = None
                ) -> np.ndarray:
    """Score ``n_cells`` environments through ``program`` as one GEMV.

    ``env`` maps each program parameter to a scalar or an (n_cells,)
    column.  The gathered-counts fast path: evaluate on the UNIQUE rows of
    the array-valued parameters and scatter back through the inverse index
    — sweep environments are massively duplicated (microbatch counts
    repeat per mesh, dp/tp ways repeat per plan), so the basis matrix
    stays (distinct rows × terms) regardless of the sweep size.

    With ``cache``, evaluation switches to per-term columns keyed by each
    term's own variable fingerprint (see ``BasisCache``) — the incremental
    path ``elastic.replan`` / ``StragglerMonitor`` use.
    """
    if n_cells == 0:
        return np.zeros(0, dtype=np.float64)
    if cache is not None:
        return _score_cells_cached(program, env, n_cells, model, cache)
    w_terms, w_const = program.fold(model)
    if not np.any(w_terms):
        return np.full(n_cells, w_const, dtype=np.float64)
    arr_params = [p for p in program.params if _is_array(env[p])]
    if not arr_params:
        return np.full(n_cells, float(np.asarray(program.score(env, model))),
                       dtype=np.float64)
    rows, inv = _unique_rows([np.asarray(env[p]) for p in arr_params])
    uenv = dict(env)
    uenv.update(zip(arr_params, rows))
    s = np.asarray(program.score(uenv, model), dtype=np.float64)
    s = np.broadcast_to(s, (len(rows[0]),))
    return s[inv]


def _score_cells_cached(program: BasisProgram, env: Mapping[str, object],
                        n_cells: int, model, cache: BasisCache
                        ) -> np.ndarray:
    w_terms, w_const = program.fold(model)
    total = np.full(n_cells, w_const, dtype=np.float64)
    # group priced terms by the exact variable subset they read
    groups: Dict[Tuple[str, ...], List[int]] = {}
    for i in np.nonzero(w_terms)[0]:
        groups.setdefault(program.term_params[int(i)], []).append(int(i))
    hits = misses = 0     # batched per call: the registry lock stays off
    for var_names, term_ids in groups.items():  # the per-column hot loop
        arr_vars = [v for v in var_names if _is_array(env[v])]
        scalars = tuple((v, env[v]) for v in var_names if v not in arr_vars)
        if arr_vars:
            rows, inv = _unique_rows([np.asarray(env[v]) for v in arr_vars])
        else:
            rows, inv = None, None
        fp = _fingerprint(var_names, scalars, rows)
        uenv = dict(scalars)
        if rows is not None:
            uenv.update(zip(arr_vars, rows))
        for i in term_ids:
            ckey = (program.term_reprs[i], fp)
            col = cache._lru.get(ckey)
            if col is None:
                fn = program.term_fn(i)
                col = np.asarray(
                    fn(np, *(uenv[v] for v in program.term_params[i])),
                    dtype=np.float64)
                cache._lru[ckey] = col
                misses += 1
            else:
                hits += 1
            if inv is None:
                total += w_terms[i] * float(np.asarray(col))
            else:
                expanded = np.broadcast_to(col, (len(rows[0]),))[inv]
                total += w_terms[i] * expanded
    cache.hits += hits
    cache.misses += misses
    if hits:
        _BASIS_HITS.inc(hits)
    if misses:
        _BASIS_MISSES.inc(misses)
    return total


# ---------------------------------------------------------------------------
# Persistent on-disk compile cache
# ---------------------------------------------------------------------------

class _RegistryStats:
    """Dict-like facade over a labeled registry counter, so the existing
    ``DISK_STATS["hits"] += 1`` call sites (and test resets via
    ``DISK_STATS[k] = 0``) keep working while the metrics registry is the
    single store.  Assigning below the current value resets the counter
    family (test isolation) rather than decrementing."""

    __slots__ = ("_counter", "_label", "_fields")

    def __init__(self, counter, label: str, fields: Tuple[str, ...]):
        self._counter = counter
        self._label = label
        self._fields = fields

    def __getitem__(self, key: str) -> int:
        if key not in self._fields:
            raise KeyError(key)
        return int(self._counter.value(**{self._label: key}))

    def __setitem__(self, key: str, value: int) -> None:
        delta = int(value) - self[key]
        if delta >= 0:
            if delta:
                self._counter.inc(delta, **{self._label: key})
        else:       # a rewind is a reset (tests zeroing between cases)
            self._counter._bump(
                _obs_metrics._labelset({self._label: key}),
                int(value), absolute=True)

    def __iter__(self):
        return iter(self._fields)

    def items(self):
        return [(k, self[k]) for k in self._fields]

    def __repr__(self) -> str:
        return repr(dict(self.items()))


#: process-wide disk-cache telemetry (reported by the autoshard CLI; the CI
#: compile-cache smoke step asserts a warm second invocation).  Backed by
#: ``repro_compile_cache_events_total{event=…}`` in the metrics registry.
DISK_STATS = _RegistryStats(
    _obs_metrics.REGISTRY.counter(
        "repro_compile_cache_events_total",
        "persistent compile-cache outcomes, by event (hits/misses/errors)"),
    "event", ("hits", "misses", "errors"))


def compile_cache_dir() -> Optional[str]:
    """The on-disk program cache directory, or None when disabled.

    ``REPRO_COMPILE_CACHE`` (the reference's variable) overrides the
    default ``~/.cache/repro_torch/exprops``; set it to
    ``0``/``off``/``none`` to disable persistence entirely."""
    v = os.environ.get("REPRO_COMPILE_CACHE")
    if v is not None:
        if v.strip().lower() in ("", "0", "off", "none", "disabled"):
            return None
        return v
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "exprops")


_EPOCH_MODULES = ("repro_torch.core.symcount",
                  "repro_torch.core.archcount",
                  "repro_torch.core.kernelmodel",
                  "repro_torch.core.predictor",
                  "repro_torch.core.exprops")
_source_epoch_cache: Optional[str] = None


def _source_epoch() -> str:
    """Fingerprint of the modules that DEFINE the symbolic formulas.

    Disk keys name a program by its *generators* (config repr, step kind,
    topology class) so a warm cache can skip building the symbolic vectors
    entirely — but that means an edit to a count formula would otherwise
    keep serving the pre-edit program.  Hashing the source bytes of the
    formula modules into every key invalidates the cache on any such edit,
    with no version-bump discipline required."""
    global _source_epoch_cache
    if _source_epoch_cache is None:
        import importlib.util
        h = hashlib.sha256()
        for mod in _EPOCH_MODULES:
            spec = importlib.util.find_spec(mod)
            if spec and spec.origin:
                try:
                    with open(spec.origin, "rb") as f:
                        h.update(f.read())
                except OSError:
                    h.update(mod.encode())
        _source_epoch_cache = h.hexdigest()[:16]
    return _source_epoch_cache


def program_key(*parts: object) -> str:
    """Canonical content hash for a program's inputs.  Callers pass the
    *generators* of the property map (config repr, step kind, topology…),
    so a warm cache skips building the symbolic vectors entirely; the
    format + model-schema versions and the formula-module source epoch
    (see ``_source_epoch``) ride in every key."""
    h = hashlib.sha256()
    h.update(f"fmt={FORMAT_VERSION};schema={SCHEMA_VERSION};"
             f"epoch={_source_epoch()}".encode())
    for p in parts:
        h.update(b"|")
        h.update(repr(p).encode())
    return h.hexdigest()


def load_or_build(key: Optional[str],
                  builder: Callable[[], Mapping[str, ExprLike]]
                  ) -> BasisProgram:
    """Fetch the fused program for ``key`` from the disk cache, else build
    it from ``builder()``'s property map and persist it (atomic rename;
    best-effort — an unwritable cache dir never fails the caller)."""
    cdir = compile_cache_dir() if key else None
    path = os.path.join(cdir, f"{key}.json") if cdir else None
    if path and os.path.exists(path):
        try:
            with open(path) as f:
                prog = BasisProgram.from_json_dict(json.load(f))
            DISK_STATS["hits"] += 1
            return prog
        except Exception:   # any unreadable/corrupt record -> rebuild
            DISK_STATS["errors"] += 1
            try:
                # quarantine the corrupt entry so it stops costing a parse
                # attempt on every warm start; the rebuild below rewrites
                # the real path atomically
                os.replace(path, path + ".corrupt")
            except OSError:
                pass
    prog = BasisProgram.build(builder())
    DISK_STATS["misses"] += 1
    if path:
        try:
            os.makedirs(cdir, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=cdir, suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(prog.to_json_dict(), f)
            os.replace(tmp, path)
        except OSError:
            DISK_STATS["errors"] += 1
    return prog


def disk_cache_report() -> str:
    """One CLI-friendly line: hit/miss counts + warm/cold verdict."""
    d = compile_cache_dir()
    if d is None:
        return "compile cache: disabled"
    h, m = DISK_STATS["hits"], DISK_STATS["misses"]
    state = "warm" if h and not m else ("cold" if m else "unused")
    return f"compile cache: {h} hits, {m} misses ({state}) [{d}]"
