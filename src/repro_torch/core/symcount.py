"""Symbolic count expressions — the piecewise-quasi-polynomial analog.

The paper represents every kernel property as a piecewise quasi-polynomial
in the size parameters ``n`` (produced by Barvinok counting), so that a
property vector can be *cheaply re-evaluated for changed problem sizes*
("our model is fully parametric").  This module supplies the same capability
for our JAX-based extraction: a tiny, dependency-free expression language

    Expr := Const | Var | Add | Mul | FloorDiv | CeilDiv | Max | Min | Piecewise

with operator overloading, substitution, evaluation and pretty-printing.
Counts produced by ``core.archcount`` (closed-form per-architecture) are
Exprs; ``core.extract`` produces concrete integers for a concrete ``n`` and
tests assert the two agree on sweeps.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Mapping, Tuple, Union

Number = Union[int, float]


def as_expr(x: "ExprLike") -> "Expr":
    if isinstance(x, Expr):
        return x
    if isinstance(x, (int, float)):
        return Const(x)
    raise TypeError(f"cannot convert {type(x)} to Expr")


class Expr:
    """Base class.  Immutable; hashable by structure string.

    Nodes never mutate after construction, so the structure string and its
    hash are computed once and cached on the instance (``_repr_c`` /
    ``_hash_c``): repeated hashing / equality probes — e.g. the LRU lookups
    in ``predictor.step_vector_fn`` or the term-dedup passes in
    ``core.exprops`` — cost O(1) tree walks, not one full re-serialization
    per probe.  Subclasses implement ``_render`` (the one-shot serializer);
    ``__repr__`` is final and memoizing.
    """

    def eval(self, env: Mapping[str, Number]) -> Number:
        raise NotImplementedError

    def free_vars(self) -> set:
        raise NotImplementedError

    def _emit(self, names: Mapping[str, str]) -> str:
        """Lower to a numpy expression string (see ``compile``)."""
        raise NotImplementedError

    def compile(self) -> "CompiledExpr":
        """Lower this expression tree to a vectorized numpy closure.

        The returned callable evaluates the tree for a whole *array* of
        environments at once: pass scalars and/or broadcastable numpy arrays
        for the free variables and every node becomes one numpy ufunc over
        the full grid.  This is the config-sweep fast path — scoring a
        block-size grid through a compiled expression replaces one
        interpreted tree-walk per point with a handful of array ops total.
        Semantics match ``eval`` exactly on integer/float scalars.
        """
        return CompiledExpr(self)

    # -- operator sugar ----------------------------------------------------
    def __add__(self, o):  return Add(self, as_expr(o))
    def __radd__(self, o): return Add(as_expr(o), self)
    def __mul__(self, o):  return Mul(self, as_expr(o))
    def __rmul__(self, o): return Mul(as_expr(o), self)
    def __sub__(self, o):  return Add(self, Mul(Const(-1), as_expr(o)))
    def __rsub__(self, o): return Add(as_expr(o), Mul(Const(-1), self))
    def __floordiv__(self, o): return FloorDiv(self, as_expr(o))
    def __truediv__(self, o):  return Mul(self, Pow(as_expr(o), -1))
    def __pow__(self, k: int): return Pow(self, k)

    def _render(self) -> str:
        raise NotImplementedError

    def __repr__(self):
        r = getattr(self, "_repr_c", None)
        if r is None:
            r = self._render()
            self._repr_c = r
        return r

    def __eq__(self, o):
        if self is o:
            return True
        return (isinstance(o, Expr) and hash(self) == hash(o)
                and repr(self) == repr(o))

    def __hash__(self):
        h = getattr(self, "_hash_c", None)
        if h is None:
            h = hash(repr(self))
            self._hash_c = h
        return h


class Const(Expr):
    def __init__(self, v: Number):
        self.v = v

    def eval(self, env):
        return self.v

    def free_vars(self):
        return set()

    def _render(self):
        if isinstance(self.v, float) and self.v.is_integer():
            return repr(int(self.v))
        return repr(self.v)

    def _emit(self, names):
        return repr(self.v)


class Var(Expr):
    def __init__(self, name: str):
        self.name = name

    def eval(self, env):
        if self.name not in env:
            raise KeyError(f"unbound size parameter {self.name!r}")
        return env[self.name]

    def free_vars(self):
        return {self.name}

    def _render(self):
        return self.name

    def _emit(self, names):
        return names[self.name]


class Add(Expr):
    def __init__(self, a: Expr, b: Expr):
        self.a, self.b = a, b

    def eval(self, env):
        return self.a.eval(env) + self.b.eval(env)

    def free_vars(self):
        return self.a.free_vars() | self.b.free_vars()

    def _render(self):
        return f"({self.a} + {self.b})"

    def _emit(self, names):
        return f"({self.a._emit(names)} + {self.b._emit(names)})"


class Mul(Expr):
    def __init__(self, a: Expr, b: Expr):
        self.a, self.b = a, b

    def eval(self, env):
        return self.a.eval(env) * self.b.eval(env)

    def free_vars(self):
        return self.a.free_vars() | self.b.free_vars()

    def _render(self):
        return f"{self._p(self.a)}*{self._p(self.b)}"

    @staticmethod
    def _p(e):
        return f"({e})" if isinstance(e, Add) else repr(e)

    def _emit(self, names):
        return f"({self.a._emit(names)} * {self.b._emit(names)})"


class Pow(Expr):
    def __init__(self, a: Expr, k: int):
        self.a, self.k = a, k

    def eval(self, env):
        return self.a.eval(env) ** self.k

    def free_vars(self):
        return self.a.free_vars()

    def _render(self):
        return f"{Mul._p(self.a)}^{self.k}"

    def _emit(self, names):
        a = self.a._emit(names)
        if self.k < 0:  # int arrays reject negative powers; go via float64
            return f"(_np.asarray({a}, dtype=_np.float64) ** {self.k})"
        return f"({a} ** {self.k})"


class FloorDiv(Expr):
    def __init__(self, a: Expr, b: Expr):
        self.a, self.b = a, b

    def eval(self, env):
        return self.a.eval(env) // self.b.eval(env)

    def free_vars(self):
        return self.a.free_vars() | self.b.free_vars()

    def _render(self):
        return f"floor({self.a} / {self.b})"

    def _emit(self, names):
        return (f"_np.floor_divide({self.a._emit(names)}, "
                f"{self.b._emit(names)})")


class CeilDiv(Expr):
    def __init__(self, a: Expr, b: Expr):
        self.a, self.b = a, b

    def eval(self, env):
        return -((-self.a.eval(env)) // self.b.eval(env))

    def free_vars(self):
        return self.a.free_vars() | self.b.free_vars()

    def _render(self):
        return f"ceil({self.a} / {self.b})"

    def _emit(self, names):
        return (f"(-_np.floor_divide(-({self.a._emit(names)}), "
                f"{self.b._emit(names)}))")


class Max(Expr):
    def __init__(self, *args: Expr):
        self.args = tuple(as_expr(a) for a in args)

    def eval(self, env):
        return max(a.eval(env) for a in self.args)

    def free_vars(self):
        return set().union(*(a.free_vars() for a in self.args))

    def _render(self):
        return f"max({', '.join(map(repr, self.args))})"

    def _emit(self, names):
        out = self.args[0]._emit(names)
        for a in self.args[1:]:
            out = f"_np.maximum({out}, {a._emit(names)})"
        return out


class Min(Expr):
    def __init__(self, *args: Expr):
        self.args = tuple(as_expr(a) for a in args)

    def eval(self, env):
        return min(a.eval(env) for a in self.args)

    def free_vars(self):
        return set().union(*(a.free_vars() for a in self.args))

    def _render(self):
        return f"min({', '.join(map(repr, self.args))})"

    def _emit(self, names):
        out = self.args[0]._emit(names)
        for a in self.args[1:]:
            out = f"_np.minimum({out}, {a._emit(names)})"
        return out


class Piecewise(Expr):
    """[(cond_fn_expr_pair)...] — the 'piecewise' in piecewise quasi-polynomial.

    ``branches`` is a list of (guard, value); guard is an Expr evaluated
    truthy (>0), the first truthy guard wins; ``otherwise`` is the default.
    """

    def __init__(self, branches: Iterable[Tuple[Expr, Expr]], otherwise: Expr):
        self.branches = [(as_expr(g), as_expr(v)) for g, v in branches]
        self.otherwise = as_expr(otherwise)

    def eval(self, env):
        for g, v in self.branches:
            if g.eval(env) > 0:
                return v.eval(env)
        return self.otherwise.eval(env)

    def free_vars(self):
        s = self.otherwise.free_vars()
        for g, v in self.branches:
            s |= g.free_vars() | v.free_vars()
        return s

    def _render(self):
        bs = "; ".join(f"{v} if {g}>0" for g, v in self.branches)
        return f"piecewise({bs}; else {self.otherwise})"

    def _emit(self, names):
        out = self.otherwise._emit(names)
        for g, v in reversed(self.branches):  # first truthy guard wins
            out = (f"_np.where({g._emit(names)} > 0, "
                   f"{v._emit(names)}, {out})")
        return out


ExprLike = Union[Expr, int, float]


# ---------------------------------------------------------------------------
# Compilation — vectorized numpy lowering (paper: "cheap re-evaluation",
# here made literal: a whole parameter grid per call, not one point)
# ---------------------------------------------------------------------------


class CompiledExpr:
    """An ``Expr`` lowered to one numpy closure over its free variables.

    Built once per tree (``Expr.compile()``); calls take an env mapping each
    free variable to a scalar or a broadcastable array and return the
    evaluated scalar/array.  ``FloorDiv``/``CeilDiv``/``Max``/``Min``/
    ``Piecewise`` lower to ``floor_divide``/``maximum``/``minimum``/``where``
    so integer semantics match ``Expr.eval`` bit-for-bit.
    """

    __slots__ = ("expr", "params", "_fn")

    def __init__(self, expr: Expr):
        import numpy as np
        self.expr = expr
        self.params = tuple(sorted(expr.free_vars()))
        # positional arg names avoid collisions with numpy / builtins
        names = {v: f"_a{i}" for i, v in enumerate(self.params)}
        args = ", ".join(names[v] for v in self.params)
        src = f"lambda _np{', ' if args else ''}{args}: {expr._emit(names)}"
        self._fn = eval(compile(src, "<symcount.compile>", "eval"))

    def __call__(self, env: Mapping[str, object]):
        import numpy as np
        return self._fn(np, *(env[v] for v in self.params))

    def __repr__(self):
        return f"compiled({self.expr!r})"


class CompiledVector:
    """A property vector compiled property-by-property.

    ``__call__(env)`` returns ``{key: scalar-or-array}``; plain numbers pass
    through untouched (broadcast by numpy where mixed with arrays).
    """

    def __init__(self, pv: Mapping[str, ExprLike]):
        self.consts: Dict[str, Number] = {}
        self.fns: Dict[str, CompiledExpr] = {}
        for k, v in pv.items():
            if isinstance(v, Expr):
                self.fns[k] = v.compile()
            else:
                self.consts[k] = v

    def free_vars(self) -> set:
        out = set()
        for f in self.fns.values():
            out.update(f.params)
        return out

    def __call__(self, env: Mapping[str, object]) -> Dict[str, object]:
        out: Dict[str, object] = dict(self.consts)
        for k, f in self.fns.items():
            out[k] = f(env)
        return out


def compile_vector(pv: Mapping[str, ExprLike]) -> CompiledVector:
    return CompiledVector(pv)


# ---------------------------------------------------------------------------
# Property-vector helpers (dict of name -> Expr | number)
# ---------------------------------------------------------------------------


def evaluate_vector(pv: Mapping[str, ExprLike], env: Mapping[str, Number]
                    ) -> Dict[str, Number]:
    out = {}
    for k, v in pv.items():
        out[k] = v.eval(env) if isinstance(v, Expr) else v
    return out


def add_vectors(*vecs: Mapping[str, ExprLike]) -> Dict[str, ExprLike]:
    out: Dict[str, ExprLike] = {}
    for v in vecs:
        for k, x in v.items():
            if k in out:
                out[k] = as_expr(out[k]) + as_expr(x) \
                    if isinstance(out[k], Expr) or isinstance(x, Expr) \
                    else out[k] + x
            else:
                out[k] = x
    return out


def scale_vector(pv: Mapping[str, ExprLike], c: ExprLike) -> Dict[str, ExprLike]:
    out = {}
    for k, v in pv.items():
        if isinstance(v, Expr) or isinstance(c, Expr):
            out[k] = as_expr(v) * as_expr(c)
        else:
            out[k] = v * c
    return out
