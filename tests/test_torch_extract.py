"""Property extraction of the port (``repro_torch.core.extract``, an ATen-graph
walk) against the reference's jaxpr walk (``repro.core.extract``).

The unit cases of ``tests/test_extraction.py`` written as torch functions
and held to the same numbers; then every case of the tiny measurement and
held-out sets, ``extract_graph`` against ``extract_jaxpr`` key by key.  The
one stated difference: the tiled transpose calls the hand-written kernel
(whose plain version is ``x.t().contiguous()``) without the reference's
``+ 0.0``, so it has n² fewer f32 adds and n² fewer f32 local loads.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import extract as jextract
from repro.core import mkernels as jmk
from repro.core import properties as jprops
from repro.core import tkernels as jtk
from repro_torch.core import extract, mkernels, tkernels
from repro_torch.core import properties as props

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# stride classes (paper §2.1 amortized stride fraction)
# ---------------------------------------------------------------------------


def test_stride_class_quantization():
    assert props.stride_class(0, 1.0) == "s0"
    assert props.stride_class(1, 1.0) == "s1"
    assert props.stride_class(2, 0.5) == "s2_1/2"
    assert props.stride_class(2, 1.0) == "s2_2/2"
    assert props.stride_class(3, 1 / 3) == "s3_1/3"
    assert props.stride_class(3, 1.0) == "s3_3/3"
    assert props.stride_class(4, 0.75) == "s4_3/4"
    assert props.stride_class(7, 1.0) == "s>4_4/>4"
    assert props.stride_class(9, 0.1) == "s>4_1/>4"


def test_stride_class_total_and_equal_to_reference():
    for stride in range(2, 65):
        for util in np.linspace(0.01, 1.0, 23):
            cls = props.stride_class(stride, float(util))
            assert cls == jprops.stride_class(stride, float(util))
            num = cls.split("_")[1].split("/")[0]
            assert 1 <= int(num) <= 4


# ---------------------------------------------------------------------------
# ATen extraction vs hand counts (the reference's unit cases)
# ---------------------------------------------------------------------------


def test_extract_vector_add():
    n = 1024
    a = torch.ones(n)
    pv = extract.extract_graph(lambda a, b: a + b, a, a)
    assert pv[props.flop_key(32, "add")] == n
    assert pv[props.mem_key("load", 32, "s1")] == 2 * n
    assert pv[props.mem_key("store", 32, "s1")] == n
    assert pv[props.minls_key(32)] == n  # min(2n loads, n stores)
    assert pv[props.CONST1] == 1.0


def test_extract_matmul_mxu():
    pv = extract.extract_graph(lambda a, b: a @ b, torch.ones(64, 32),
                               torch.ones(32, 16))
    assert pv[props.mxu_key(32)] == 2 * 64 * 32 * 16


def test_extract_small_k_dot_is_vector():
    """Contractions below MXU_MIN_K are charged as vector flops."""
    pv = extract.extract_graph(lambda a, b: a @ b, torch.ones(64, 3),
                               torch.ones(3, 16))
    assert props.mxu_key(32) not in pv
    assert pv[props.flop_key(32, "mul")] == 64 * 3 * 16


def test_extract_strided_slice_phases():
    """x[0::2] alone is a 1/2-utilization stride-2 access; adding x[1::2]
    fills the footprint -> 2/2 (paper Alg. 2 union-of-footprints)."""
    n = 1024
    x = torch.ones(n)
    pv_half = extract.extract_graph(lambda x: x[0:n:2] * 1.0, x)
    assert pv_half[props.mem_key("load", 32, "s2_1/2")] == n // 2
    pv_full = extract.extract_graph(lambda x: x[0:n - 1:2] + x[1:n:2], x)
    assert pv_full[props.mem_key("load", 32, "s2_2/2")] == 2 * (n // 2)


def test_extract_uniform_broadcast_is_stride0():
    """An explicit lane-independent broadcast is a 'uniform access'
    (paper §2.1 stride 0)."""
    pv = extract.extract_graph(lambda x, v: x + v.expand(128),
                               torch.ones(128), torch.ones(1))
    assert pv[props.mem_key("load", 32, "s0")] == 128


def test_extract_transpose_is_gather():
    pv = extract.extract_graph(lambda x: x.t() + 0.0, torch.ones(64, 64))
    assert pv[props.mem_key("load", 32, "gather")] == 64 * 64


def test_extract_loop_multiplies_by_trip_count():
    """The reference's scan test: a Python loop is unrolled by the trace."""
    def f(x, w):
        c = x
        for i in range(w.shape[0]):
            c = c * w[i]
        return c
    pv = extract.extract_graph(f, torch.ones(128), torch.ones(5, 128))
    assert pv[props.flop_key(32, "mul")] == 5 * 128


def test_extract_flop_kinds():
    pv = extract.extract_graph(
        lambda x: torch.exp(x) / (x + 1.0) * torch.rsqrt(x), torch.ones(100))
    for kind in ("exp", "div", "add", "special", "mul"):
        assert pv[props.flop_key(32, kind)] == 100


def test_extract_integer_ops_not_counted():
    pv = extract.extract_graph(lambda x: x + x,
                               torch.ones(100, dtype=torch.int32))
    assert props.flop_key(32, "add") not in pv


def test_extract_bf16_bucketed_separately():
    pv = extract.extract_graph(lambda x: x * x,
                               torch.ones(64, dtype=torch.bfloat16))
    assert pv[props.flop_key(16, "mul")] == 64
    assert pv[props.mem_key("load", 16, "s1")] == 2 * 64  # x read twice


def test_extract_rank_promotion_reads_like_broadcast_in_dim():
    """A lower-rank global operand is read as jnp's rank promotion reads
    it (the reference's counts for ``x (4,128) + v (128,)``)."""
    pv = extract.extract_graph(lambda x, v: x + v, torch.ones(4, 128),
                               torch.ones(128))
    assert pv[props.mem_key("load", 32, "s1")] == 512 + 128
    assert pv[props.local_key(32)] == 128


# small functions written in both frameworks: the two walks agree key by key
PAIRS = {
    "mean": (lambda x: x.mean(dim=1), lambda x: x.mean(axis=1), [(4, 128)]),
    "square": (lambda x: x ** 2, lambda x: x ** 2, [(4, 128)]),
    "pow": (lambda x: x ** 2.5, lambda x: x ** 2.5, [(4, 128)]),
    "rank_promotion": (lambda x, v: x + v, lambda x, v: x + v,
                       [(4, 128), (128,)]),
    "scalar_operand": (lambda x, v: x * v, lambda x, v: x * v,
                       [(4, 128), ()]),
    "same_rank_broadcast": (lambda x, v: x - v, lambda x, v: x - v,
                            [(4, 128), (4, 1)]),
    # lax.rev, not jnp.flip: jnp.flip wraps rev in a `jit` call, which the
    # reference's walker does not enter
    "flip": (lambda x: torch.flip(x, (1,)) * 2.0,
             lambda x: jax.lax.rev(x, (1,)) * 2.0, [(4, 128)]),
    "concat": (lambda a, b: torch.cat([a, b]) + 1.0,
               lambda a, b: jnp.concatenate([a, b]) + 1.0,
               [(64,), (32,)]),
    "maximum_where": (lambda a, b: torch.where(a > b, torch.maximum(a, b),
                                               b),
                      lambda a, b: jnp.where(a > b, jnp.maximum(a, b), b),
                      [(256,), (256,)]),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_small_functions_extract_as_in_the_reference(name):
    tfn, jfn, shapes = PAIRS[name]
    targs = [torch.full(s, 0.5) for s in shapes]
    jargs = [jnp.full(s, 0.5, jnp.float32) for s in shapes]
    assert extract.extract_graph(tfn, *targs) == \
        jextract.extract_jaxpr(jfn, *jargs)


def test_extract_affine_index_gather_is_strided():
    """``x[torch.arange(b, n, k)]`` reads like the slice ``x[b::k]`` (the
    reference's affine iota-gather recognition)."""
    n = 1024
    x = torch.ones(n)
    pv = extract.extract_graph(lambda x: x[torch.arange(1, n, 2)] * 1.0, x)
    assert pv[props.mem_key("load", 32, "s2_1/2")] == n // 2
    pv = extract.extract_graph(
        lambda x, i: x[i] * 1.0, x, torch.arange(n // 2))
    assert pv[props.mem_key("load", 32, "gather")] == n // 2


def test_extract_cond_takes_the_larger_branch_and_while_the_hint():
    def branches(x):
        return torch.cond(x.sum() > 0, lambda x: torch.exp(x) * 2.0,
                          lambda x: x + 1.0, (x,))
    pv = extract.extract_graph(branches, torch.ones(128))
    assert pv[props.flop_key(32, "exp")] == 128
    assert pv[props.flop_key(32, "mul")] == 128
    assert props.flop_key(32, "add") in pv  # the sum of the predicate

    from torch._higher_order_ops.while_loop import while_loop

    def loop(x):
        i = torch.zeros((), dtype=torch.int64)
        return while_loop(lambda i, c: i < 5,
                          lambda i, c: (i + 1, c * 1.5), (i, x))[1]
    pv = extract.extract_graph(loop, torch.ones(128),
                               hints={"while_trip_count": 5})
    assert pv[props.flop_key(32, "mul")] == 5 * 128
    pv1 = extract.extract_graph(loop, torch.ones(128))
    assert pv1[props.flop_key(32, "mul")] == 128  # defaulted to one trip


def test_extract_traces_stand_ins_not_the_tensors():
    """Arguments of any size are traced as fake CPU tensors: nothing of
    their size is allocated, and a kernel wrapper takes its plain
    version."""
    from repro_torch.kernels import matmul as mm
    big = torch.empty((1 << 20, 1 << 10), device="meta")
    gm = extract.trace(lambda a: a + 0.0, big)
    assert [n for n in gm.graph.nodes if n.op == "call_function"]
    before = mm.matmul.launches
    pv = extract.extract_graph(mkernels._tiled_mm, torch.ones(32, 64),
                               torch.ones(64, 16))
    assert mm.matmul.launches == before
    assert pv[props.mxu_key(32)] == 2 * 32 * 64 * 16


# ---------------------------------------------------------------------------
# Parity with the reference on every tiny measurement and held-out case
# ---------------------------------------------------------------------------

NAMES = [c.name for c in mkernels.measurement_cases("tiny", device="cpu")
         + tkernels.test_cases("tiny", device="cpu")]


@functools.lru_cache(maxsize=1)
def _both():
    ref = {c.name: c for c in jmk.measurement_cases("tiny")
           + jtk.test_cases("tiny")}
    port = {c.name: c for c in mkernels.measurement_cases("tiny", device="cpu")
            + tkernels.test_cases("tiny", device="cpu")}
    return ref, port


def test_case_sets_have_the_reference_names_and_classes():
    ref, port = _both()
    assert list(ref) == list(port) == NAMES
    assert {c.klass for c in ref.values()} == {c.klass for c in port.values()}
    assert len([c for c in port.values() if c.klass != "empty"]) == 96


def test_ladders_of_the_reference_scales_are_the_reference_s():
    for scale in ("cpu", "tiny"):
        assert mkernels._P[scale] == jmk._P[scale]
        assert tkernels._P[scale] == jtk._P[scale]
    assert set(mkernels._P["gpu"]) == set(jmk._P["cpu"])
    assert set(tkernels._P["gpu"]) == set(jtk._P["cpu"])


@pytest.mark.parametrize("name", NAMES)
def test_extract_graph_equals_extract_jaxpr(name):
    ref, port = _both()
    want, got = ref[name].properties(), port[name].properties()
    if name.startswith("transpose_tiled_"):
        n = port[name].meta["n"]
        want = dict(want)
        want[props.flop_key(32, "add")] -= n * n
        want[props.local_key(32)] -= n * n
        want = {k: v for k, v in want.items() if v}
    assert got == want
