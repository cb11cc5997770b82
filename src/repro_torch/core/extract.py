"""Automatic property extraction — the Loopy/Barvinok analog (paper §3).

The paper walks its polyhedral IR and counts integer points of projected
loop domains to obtain symbolic per-instruction execution counts.  The
reference walks a **jaxpr**; this port walks the **ATen graph** that
``torch.fx.experimental.proxy_tensor.make_fx`` records for ``fn(*args)``.
Every node carries static shapes, so the number of executions of each scalar
operation is the product of the output dimensions, and a Python loop is
unrolled into the graph, so its trip count is already in the counts.  The
walk tallies, per paper §2 and exactly as the reference does:

  * global-memory accesses: an access is counted when a node consumes a
    *global view* (a value aliased to a kernel input) or produces a kernel
    output; classified by (element bits × direction × access class), where
    the class is the paper's amortized-stride-fraction quantization
    (``properties.stride_class``): slices with stride k contribute the phase
    set of their start offsets — the union footprint over all accesses of an
    array determines the utilization numerator exactly as Algorithm 2 unions
    per-access index maps;
  * flops by kind × dtype for every floating-point node (integer arithmetic
    is excluded, per paper §2.2);
  * matrix-product MAC flops under the ``mxu:<bits>`` key (the name the
    reference gives the systolic array's rate; kept so that model files of
    both packages are interchangeable);
  * control flow: a Python loop is unrolled by the trace; ``torch.cond``
    takes the elementwise max over branches (conservative);
    ``while_loop`` consumes a user hint (the paper's §2 'human operator
    supplies statistics' escape hatch for data-dependent control flow).

Where ATen differs from a jaxpr, the walker reproduces the jaxpr's counts:

  * views.  A ``slice`` or ``select`` of a global is a window that stays
    pending until something other than another slice or select consumes it;
    then the read is charged once, as the reference charges its one
    ``slice`` equation (chained ATen slices of ``u[1:-1, 1:-1]`` are one
    jaxpr slice), and a ``select`` adds the local loads of the ``squeeze``
    that follows a jaxpr slice.  ``view``/``_unsafe_view``/``clone``/
    ``_to_copy`` keep globality (the reference's ``reshape``/``copy``/
    ``convert_element_type``); ``t``/``permute``/``transpose`` are its
    ``transpose`` (a gather read unless the minor axis stays);
    ``unsqueeze``/``expand`` are its ``broadcast_in_dim``;
  * broadcasting.  A global operand of lower rank in an elementwise node is
    read as the ``broadcast_in_dim`` that jnp's rank promotion inserts;
  * contractions: ``mm``/``bmm``/``mv``/``dot`` (and ``einsum``, which
    decomposes into them) with a contraction shorter than ``MXU_MIN_K`` are
    vector mul+add, as in the reference;
  * ``arange``/``zeros``/``eye``/``full`` are the jaxpr's ``iota`` and
    literal broadcasts: free; a 0-d one returned as a result is a literal.

Local-memory loads, barriers and group counts of a *tiled* kernel are not
graph-visible (codegen artifacts — the paper likewise needs the schedule for
barriers); the measurement kernels declare them (``mkernels.tiled_*_props``)
and plain kernels get a nominal group count ``ceil(out_elems / GROUP_SIZE)``.

``fn`` is traced on CPU stand-ins of its arguments (fake tensors of the same
shapes, strides and types: nothing is allocated and nothing runs), so the
kernel wrappers it calls take their plain versions, and no extraction
touches the card.
"""
from __future__ import annotations

import math
import operator
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch.fx import GraphModule, Node
from torch.utils import _pytree as pytree

from repro_torch.core import properties as props

GROUP_SIZE = 256  # nominal lanes per work group (paper uses 128–512)
MXU_MIN_K = 16    # contractions shorter than this run at vector, not
                  # matrix-unit, rates (as in the reference)

# ATen op packet name -> flop kind (paper's five §2.2 categories)
_FLOP_KIND = {
    "add": "add", "sub": "add", "rsub": "add", "neg": "add", "abs": "add",
    "maximum": "add", "minimum": "add", "max": "add", "min": "add",
    "floor": "add", "ceil": "add", "round": "add", "sign": "add",
    "clamp": "add", "clamp_min": "add", "clamp_max": "add",
    "mul": "mul",
    "div": "div", "remainder": "div", "fmod": "div",
    "exp": "exp", "exp2": "exp", "expm1": "exp", "pow": "exp",
    "log": "exp", "log1p": "exp", "log2": "exp",
    "rsqrt": "special", "sqrt": "special", "tanh": "special",
    "erf": "special", "erfc": "special", "erfinv": "special",
    "sigmoid": "special", "sin": "special", "cos": "special",
    "tan": "special", "asin": "special", "acos": "special",
    "atan": "special", "atan2": "special", "sinh": "special",
    "cosh": "special",
    "square": "mul",
    "cumsum": "add", "logcumsumexp": "exp", "cummax": "add",
    "cumprod": "mul",
}

# reductions: flops = input elems, kind as mapped (``mean`` adds the divide
# the reference's jnp.mean does after its reduce_sum)
_REDUCE_KIND = {
    "sum": "add", "mean": "add", "amax": "add", "amin": "add", "max": "add",
    "min": "add", "prod": "mul", "argmax": "add", "argmin": "add",
    "any": None, "all": None, "logsumexp": "exp",
}

# alias-preserving ops: the output is still a view of the same global
# (element *order* unchanged; _to_copy keeps origin bits for access size)
_ALIAS = ("view", "_unsafe_view", "reshape", "clone", "_to_copy", "to",
          "alias", "detach", "contiguous", "lift_fresh_copy")
_WINDOW = ("slice", "select")
_TRANSPOSE = ("t", "permute", "transpose")
_BROADCAST = ("unsqueeze", "expand")
_FACTORY = ("arange", "zeros", "ones", "full", "empty", "empty_strided",
            "eye", "scalar_tensor", "zeros_like", "ones_like", "full_like",
            "empty_like", "linspace")
_GATHER = ("index", "index_select", "gather", "take", "embedding")
_SCATTER = ("scatter", "scatter_add", "scatter_reduce", "index_put",
            "index_add", "index_copy")
_UPDATE = ("slice_scatter", "select_scatter")
_CONCAT = ("cat", "constant_pad_nd")
_DOT = ("mm", "bmm", "mv", "dot", "addmm", "baddbmm")


def _val(v) -> Any:
    """The fake tensor (or the first of several) a node produced."""
    if not isinstance(v, Node):
        return None
    val = v.meta.get("val")
    if isinstance(val, (tuple, list)):
        val = next((x for x in val if isinstance(x, torch.Tensor)), None)
    return val if isinstance(val, torch.Tensor) else None


def _bits_of(val) -> int:
    return val.dtype.itemsize * 8 if val is not None else 32


def _is_float(val) -> bool:
    return val is not None and val.dtype.is_floating_point


def _elems(val) -> float:
    return float(math.prod(val.shape)) if val is not None else 1.0


def _nbits(bits: int) -> int:
    """Snap to a tracked size bucket."""
    if bits <= 16:
        return 16
    if bits <= 32:
        return 32
    return 64


def _name(target) -> str:
    """Op packet name of a node's target (``aten.add.Tensor`` -> ``add``;
    an in-place ``add_`` counts as ``add``)."""
    packet = getattr(target, "overloadpacket", None)
    name = getattr(packet, "__name__", None) or getattr(
        target, "__name__", str(target))
    return name[:-1] if name.endswith("_") and not name.startswith("_") \
        else name


def _tensor_args(node: Node) -> List[Node]:
    """Tensor-valued input nodes in argument order, repeats kept (``x * x``
    reads x twice, as in the reference)."""
    leaves = pytree.tree_leaves((node.args, node.kwargs))
    return [a for a in leaves if isinstance(a, Node) and _val(a) is not None]


@dataclass
class _GlobalView:
    """Value aliased to a kernel input (array id + original element bits)."""
    gid: int
    bits: int


@dataclass
class _Window:
    """A pending slice/select of a global: per axis of the viewed array
    ``[start, size, step]``; ``axes`` maps the current axes to those axes;
    ``dropped`` counts axes a ``select`` removed."""
    view: _GlobalView
    base: Tuple[int, ...]
    win: List[List[int]]
    axes: List[int]
    dropped: int = 0


@dataclass
class _Access:
    gid: int
    bits: int
    direction: str  # load | store
    stride: int     # innermost-axis stride (0 = uniform, 1 = contiguous)
    phase: int      # start offset mod stride (for stride >= 2)
    elems: float    # elements touched per kernel execution
    kind: str = ""  # '' = strided/contig; 'gather' = data-dependent


@dataclass
class Extraction:
    flops: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    accesses: List[_Access] = field(default_factory=list)
    out_elems: float = 0.0
    warnings: List[str] = field(default_factory=list)

    # ------------------------------------------------------------------
    def add_flops(self, bits: int, kind: str, n: float):
        if n:
            self.flops[props.flop_key(_nbits(bits), kind)] += n

    def add_mxu(self, bits: int, n: float):
        if n:
            self.flops[props.mxu_key(_nbits(bits))] += n

    def add_local(self, val):
        """Local loads of a non-global float operand (the reference's
        local-memory class put to work: what a device that does not fuse
        pays for intermediates)."""
        elems = _elems(val)
        if _is_float(val) and elems > 1:
            self.flops[props.local_key(_nbits(_bits_of(val)))] += elems

    def add_access(self, a: _Access):
        if a.elems:
            self.accesses.append(a)

    def merge_scaled(self, other: "Extraction", mult: float):
        for k, v in other.flops.items():
            self.flops[k] += v * mult
        for a in other.accesses:
            self.add_access(_Access(a.gid, a.bits, a.direction, a.stride,
                                    a.phase, a.elems * mult, a.kind))
        self.out_elems += other.out_elems * mult
        self.warnings.extend(other.warnings)

    # ------------------------------------------------------------------
    def property_vector(self, group_size: int = GROUP_SIZE,
                        extra: Optional[Mapping[str, float]] = None
                        ) -> props.PropertyVector:
        pv: Dict[str, float] = defaultdict(float)
        pv.update(self.flops)

        # ---- classify accesses (paper Alg. 2 union-footprint per array) --
        # group strided accesses by (gid, direction, stride); the distinct
        # phase count is the utilization numerator
        strided: Dict[Tuple, Dict[str, Any]] = defaultdict(
            lambda: {"phases": set(), "elems": 0.0, "bits": 32})
        for a in self.accesses:
            if a.kind == "gather":
                pv[props.mem_key(a.direction, _nbits(a.bits), "gather")] += a.elems
            elif a.stride in (0, 1):
                cls = "s0" if a.stride == 0 else "s1"
                pv[props.mem_key(a.direction, _nbits(a.bits), cls)] += a.elems
            else:
                g = strided[(a.gid, a.direction, a.stride)]
                g["phases"].add(a.phase % a.stride)
                g["elems"] += a.elems
                g["bits"] = a.bits
        for (gid, direction, stride), g in strided.items():
            util = len(g["phases"]) / stride
            cls = props.stride_class(stride, util)
            pv[props.mem_key(direction, _nbits(g["bits"]), cls)] += g["elems"]

        pv[props.GROUPS] = math.ceil(max(self.out_elems, 1) / group_size)
        if extra:
            for k, v in extra.items():
                pv[k] = pv.get(k, 0.0) + v
        return props.finalize(pv)


# ---------------------------------------------------------------------------
# The ATen-graph walker
# ---------------------------------------------------------------------------


def _affine_of(v, depth: int = 16) -> Optional[Tuple[int, int]]:
    """Recognize an affine index map ``stride*arange + phase`` (paper Alg.
    2's index-mapping analysis, e.g. I(i) = 2i+1).  Returns (stride,
    phase)."""
    for _ in range(depth):  # bounded chain walk
        if not isinstance(v, Node) or v.op != "call_function":
            return None
        name = _name(v.target)
        if name == "arange":
            nums = [a for a in v.args if isinstance(a, (int, float))]
            if len(nums) == 1:
                return (1, 0)
            step = int(nums[2]) if len(nums) > 2 else 1
            return (step, int(nums[0]))
        if name in ("view", "_unsafe_view", "_to_copy", "unsqueeze",
                    "expand", "clone"):
            v = v.args[0]
            continue
        if name in ("add", "mul"):
            lit = [a for a in v.args if isinstance(a, (int, float))]
            other = [a for a in v.args if isinstance(a, Node)]
            if len(lit) != 1 or len(other) != 1:
                return None
            sub = _affine_of(other[0], depth - 1)
            if sub is None:
                return None
            s, p = sub
            k = int(lit[0])
            return (s, p + k) if name == "add" else (s * k, p * k)
        return None
    return None


def _perm_of(node: Node, ndim: int) -> List[int]:
    name = _name(node.target)
    if name == "permute":
        return [d % ndim for d in node.args[1]]
    perm = list(range(ndim))
    if name == "t":
        return perm[::-1]
    d0, d1 = node.args[1] % ndim, node.args[2] % ndim
    perm[d0], perm[d1] = perm[d1], perm[d0]
    return perm


def _walk(gm: GraphModule, global_map: Dict[Node, _GlobalView],
          ext: Extraction, hints: Mapping[str, float]
          ) -> Dict[Node, _GlobalView]:
    """Walk one graph; ``global_map`` maps its placeholder nodes to global
    views and grows as aliases of them appear."""
    pending: Dict[Node, _Window] = {}

    def gv(v) -> Optional[_GlobalView]:
        return global_map.get(v) if isinstance(v, Node) else None

    def read(v, elems: float, stride: int = 1, phase: int = 0,
             kind: str = ""):
        """Record a load if v is a global view."""
        g = gv(v)
        if g is not None and elems:
            ext.add_access(_Access(g.gid, g.bits, "load", stride, phase,
                                   elems, kind))

    def settle(v) -> None:
        """Charge a pending window's read, once, as the reference charges
        its ``slice`` (and the ``squeeze`` after it where a select dropped
        axes); from then on the value is an intermediate."""
        w = pending.pop(v, None)
        if w is None:
            return
        out_shape = [size for _, size, _ in w.win]
        out_elems = float(math.prod(out_shape))
        start, _, stride = w.win[-1]
        # multi-axis windows (e.g. conv taps m[:, x:x+n, y:y+n, :]) read
        # many SHORT contiguous runs: if the run length is below a
        # line/sector, the access behaves uncoalesced (paper §2.1's 'gaps
        # caused by striding', generalized to middle axes)
        run = 1
        for ax in range(len(w.base) - 1, -1, -1):
            run *= out_shape[ax]
            if out_shape[ax] != w.base[ax]:
                break
        g = w.view
        if stride == 1 and run < 16 and out_elems > run:
            ext.add_access(_Access(g.gid, g.bits, "load", 1, 0, out_elems,
                                   "gather"))
        else:
            ext.add_access(_Access(g.gid, g.bits, "load", stride, start,
                                   out_elems))
        if w.dropped:
            ext.add_local(_val(v))

    def window(node: Node, src: Node) -> None:
        """Compose a slice/select of a global (or of a pending window)."""
        if src in pending:
            w0 = pending[src]
            w = _Window(w0.view, w0.base, [list(x) for x in w0.win],
                        list(w0.axes), w0.dropped)
        else:
            shape = tuple(_val(src).shape)
            w = _Window(gv(src), shape, [[0, s, 1] for s in shape],
                        list(range(len(shape))))
        in_shape = _val(src).shape
        dim = node.args[1] % len(in_shape) if len(node.args) > 1 else 0
        ax = w.axes[dim]
        s0, _, st = w.win[ax]
        if _name(node.target) == "select":
            idx = node.args[2] % in_shape[dim]
            w.win[ax] = [s0 + st * idx, 1, st]
            del w.axes[dim]
            w.dropped += 1
        else:
            start = node.args[2] if len(node.args) > 2 else 0
            step = node.args[4] if len(node.args) > 4 else 1
            start = 0 if start is None else start
            if start < 0:
                start += in_shape[dim]
            start = min(max(start, 0), in_shape[dim])
            w.win[ax] = [s0 + st * start, _val(node).shape[dim], st * step]
        pending[node] = w

    for node in gm.graph.nodes:
        if node.op == "output":
            for v in pytree.tree_leaves(node.args):
                settle(v)
            continue
        if node.op != "call_function" or node.target is operator.getitem:
            continue
        target = node.target
        name = _name(target)
        ins = _tensor_args(node)

        # ---- pending windows ------------------------------------------
        if name in _WINDOW and ins and (ins[0] in pending
                                        or gv(ins[0]) is not None):
            window(node, ins[0])
            continue
        for v in ins:
            settle(v)

        # ---- control flow (higher-order ops) --------------------------
        if isinstance(target, torch._ops.HigherOrderOperator):
            _walk_control_flow(gm, node, target.name(), global_map, ext,
                               hints)
            continue

        out_val = _val(node)
        out_elems = _elems(out_val)

        # ---- alias-preserving -----------------------------------------
        if name in _ALIAS:
            g = gv(ins[0]) if ins else None
            if g is not None:
                global_map[node] = g  # keep ORIGIN bits: the stream is read
                # at the stored size regardless of later converts
            continue

        if name in _FACTORY or name in _WINDOW:
            continue  # iota / literal broadcasts; views of intermediates

        # ---- memory-pattern ops -----------------------------------------
        if name in _TRANSPOSE:
            perm = _perm_of(node, len(_val(ins[0]).shape))
            minor = len(perm) - 1
            if not perm or perm[minor] == minor:  # minor axis: stream copy
                read(ins[0], out_elems, stride=1)
            else:  # relayout: uncoalesced read
                read(ins[0], out_elems, kind="gather")
            continue

        if name in _BROADCAST:
            in_val = _val(ins[0])
            in_elems = _elems(in_val)
            out_rank, in_rank = len(out_val.shape), len(in_val.shape)
            if name == "unsqueeze":
                new = node.args[1] % out_rank
                bdims = [d for d in range(out_rank) if d != new]
            else:
                bdims = list(range(out_rank - in_rank, out_rank))
            # if the minor axis of out is NOT fed by the input's minor axis,
            # every lane re-reads the same element -> uniform (stride-0)
            if (out_rank - 1 not in bdims) or in_elems == 1.0:
                read(ins[0], out_elems, stride=0)
            else:
                read(ins[0], in_elems, stride=1)
            continue

        if name == "flip":
            read(ins[0], out_elems, kind="gather")
            continue

        if name in _CONCAT:
            for v in ins:
                read(v, _elems(_val(v)))
            continue

        if name in _SCATTER:
            # operand read + data-dependent stores
            read(ins[0], out_elems)
            upd_elems = _elems(_val(ins[-1]))
            g = gv(ins[0])
            gid = g.gid if g else id(node)
            bits = g.bits if g else _bits_of(out_val)
            ext.add_access(_Access(gid, bits, "store", 1, 0, upd_elems,
                                   "gather"))
            global_map[node] = g if g else _GlobalView(gid, bits)
            continue

        if name in _UPDATE:
            g = gv(ins[0])
            if g is not None:
                global_map[node] = g
            continue

        if name in _GATHER:
            # affine arange-gather (x[torch.arange(b, n, k)]) is a *strided*
            # access, not a data-dependent one — recover (k, b); the
            # indices come last, the source first
            aff = _affine_of(ins[-1]) if len(ins) >= 2 else None
            if aff is not None:
                s, ph = aff
                read(ins[0], out_elems, stride=s,
                     phase=0 if s in (0, 1) else ph)
            else:
                read(ins[0], out_elems, kind="gather")
            continue

        # ---- compute ops ------------------------------------------------
        if name in _DOT:
            if name in ("addmm", "baddbmm"):
                bias, lhs, rhs = ins[0], ins[1], ins[2]
            else:
                bias, lhs, rhs = None, ins[0], ins[1]
            lhs_val = _val(lhs)
            k = float(lhs_val.shape[0] if name == "dot" else
                      lhs_val.shape[-1])
            macs = out_elems * k
            bits = _bits_of(lhs_val)
            if k >= MXU_MIN_K:
                ext.add_mxu(bits, 2.0 * macs)  # MAC = 2 flops
            else:
                # tiny contraction: the matrix unit (or a BLAS µkernel)
                # cannot amortize — charge as vector mul+add instead
                ext.add_flops(bits, "mul", macs)
                ext.add_flops(bits, "add", macs)
            for v in (lhs, rhs):
                read(v, _elems(_val(v)))
            if bias is not None:  # the bias add of a fused addmm
                ext.add_flops(_bits_of(out_val), "add", out_elems)
                _operand(bias, out_val, read, ext, gv)
            continue

        if name == "convolution":
            # flops = 2 * out_elems * (kernel window size * in channels)
            rhs = _val(ins[1])
            window_size = float(math.prod(rhs.shape[2:])) \
                if len(rhs.shape) > 2 else 1.0
            cin = rhs.shape[1] if len(rhs.shape) > 1 else 1
            macs = out_elems * window_size * cin
            if window_size * cin >= MXU_MIN_K:
                ext.add_mxu(_bits_of(rhs), 2.0 * macs)
            else:
                ext.add_flops(_bits_of(rhs), "mul", macs)
                ext.add_flops(_bits_of(rhs), "add", macs)
            for v in ins:
                read(v, _elems(_val(v)))
            continue

        if name in _REDUCE_KIND and len(ins) == 1:
            kind = _REDUCE_KIND[name]
            in_val = _val(ins[0])
            in_elems = _elems(in_val)
            if kind and _is_float(in_val):
                ext.add_flops(_bits_of(in_val), kind, in_elems)
            read(ins[0], in_elems)
            if name == "mean":  # jnp.mean: reduce_sum, then a divide
                ext.add_flops(_bits_of(out_val), "div", out_elems)
                ext.add_local(out_val)
            continue

        # ---- generic elementwise -----------------------------------------
        kind = _FLOP_KIND.get(name)
        if kind is not None and _is_float(out_val):
            n = out_elems
            exponent = node.args[1] if len(node.args) > 1 else None
            if name == "pow" and isinstance(exponent, int):
                # x**k with an integer k (the reference's integer_pow)
                # costs ~log2(k) multiplies
                n = out_elems * max(1, int(math.log2(max(abs(exponent), 2))))
                kind = "mul"
            ext.add_flops(_bits_of(out_val), kind, n)
        # loads for any global operands of an elementwise/compute op;
        # NON-global (intermediate) operands are charged as LOCAL loads —
        # on a perfectly-fusing device they are free-ish, on one that
        # materializes them they cost cache/HBM traffic: the fitted
        # local-load weight captures the device's fusion quality (this is
        # the paper's local-memory class, put to work)
        for v in ins:
            _operand(v, out_val, read, ext, gv)

    return global_map


def _operand(v: Node, out_val, read, ext: Extraction, gv) -> None:
    """Charge one operand of an elementwise op: a global is read (through
    the ``broadcast_in_dim`` jnp's rank promotion would insert when its rank
    is lower than the result's), an intermediate costs local loads."""
    val = _val(v)
    elems = _elems(val)
    if gv(v) is None:
        ext.add_local(val)
    elif 0 < len(val.shape) < len(out_val.shape):
        read(v, elems, stride=0 if elems == 1.0 else 1)
        ext.add_local(val)
    else:
        read(v, elems)


def _placeholders(gm: GraphModule) -> List[Node]:
    return [n for n in gm.graph.nodes if n.op == "placeholder"]


def _walk_control_flow(gm: GraphModule, node: Node, op: str,
                       global_map: Dict[Node, _GlobalView], ext: Extraction,
                       hints: Mapping[str, float]) -> None:
    """``torch.cond`` (max over branches) and ``while_loop`` (hinted trip
    count); any other higher-order op is walked as opaque."""
    def sub(graph_node: Node, operands: Sequence, keep: Sequence[bool]
            ) -> Extraction:
        body = getattr(gm, graph_node.target)
        sub_map = {}
        for ph, ov, k in zip(_placeholders(body), operands, keep):
            g = global_map.get(ov) if isinstance(ov, Node) else None
            if g is not None and k:
                sub_map[ph] = g
        sub_ext = Extraction()
        _walk(body, sub_map, sub_ext, hints)
        return sub_ext

    if op == "cond":
        operands = list(node.args[3])
        best: Optional[Extraction] = None
        for br in node.args[1:3]:
            sub_ext = sub(br, operands, [True] * len(operands))
            tot = sum(sub_ext.flops.values()) + sum(
                a.elems for a in sub_ext.accesses)
            if best is None or tot > sum(best.flops.values()) + sum(
                    a.elems for a in best.accesses):
                best = sub_ext
        if best is not None:
            ext.merge_scaled(best, 1.0)  # conservative: max branch
    elif op == "while_loop":
        mult = float(hints.get("while_trip_count", 1.0))
        if "while_trip_count" not in hints:
            ext.warnings.append("while-loop trip count defaulted to 1 "
                                "(supply hints={'while_trip_count': k})")
        carried, consts = list(node.args[2]), list(node.args[3])
        # consts keep globality; carries do not
        keep = [False] * len(carried) + [True] * len(consts)
        ext.merge_scaled(sub(node.args[1], carried + consts, keep), mult)
    else:
        ext.warnings.append(f"higher-order op {op!r} walked as opaque")


def _standins(args):
    """Fake CPU tensors of the arguments' shapes, strides and types: nothing
    is allocated, and kernel wrappers see CPU tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.symbolic_shapes import ShapeEnv
    mode = FakeTensorMode(shape_env=ShapeEnv())

    def fake(x):
        if not isinstance(x, torch.Tensor):
            return x
        with mode:
            return torch.empty_strided(tuple(x.shape), tuple(x.stride()),
                                       dtype=x.dtype, device="cpu")
    return pytree.tree_map(fake, args)


def trace(fn, *args) -> GraphModule:
    """The ATen graph of ``fn(*args)``, traced on CPU stand-ins."""
    from torch.fx.experimental.proxy_tensor import make_fx
    # a varargs wrapper: make_fx counts the parameters of what it traces,
    # and fn may take defaults beyond its positional arguments
    return make_fx(lambda *a: fn(*a), tracing_mode="fake")(*_standins(args))


def extract_graph(fn, *args, hints: Optional[Mapping[str, float]] = None,
                  extra_props: Optional[Mapping[str, float]] = None,
                  group_size: int = GROUP_SIZE) -> props.PropertyVector:
    """Fully-automatic property extraction for ``fn(*args)`` (paper §3.2).

    Returns the finalized property vector (loads/stores by class, flops by
    kind, min(L,S), groups, const1).  ``extra_props`` lets tiled kernels add
    their schedule-derived properties (local loads, barriers).  ``args`` may
    lie on any device: the trace runs on CPU stand-ins of them.
    """
    gm = trace(fn, *args)
    ext = Extraction()
    gmap: Dict[Node, _GlobalView] = {}
    leaves = pytree.tree_leaves(args)
    for i, (ph, leaf) in enumerate(zip(_placeholders(gm), leaves)):
        if isinstance(leaf, torch.Tensor):
            gmap[ph] = _GlobalView(gid=i, bits=_bits_of(leaf))
    gmap = _walk(gm, gmap, ext, hints or {})

    # stores: kernel outputs are written as contiguous streams unless the
    # producing op was a scatter (already recorded)
    out_node = next(n for n in gm.graph.nodes if n.op == "output")
    for ov in pytree.tree_leaves(out_node.args):
        val = _val(ov)
        if val is None or (not val.shape and ov.op == "call_function"
                           and _name(ov.target) in _FACTORY):
            continue  # a literal (a constant 0-d result)
        elems = _elems(val)
        ext.out_elems += elems
        g = gmap.get(ov)
        if g is not None and any(a.gid == g.gid and a.direction == "store"
                                 for a in ext.accesses):
            continue  # scatter store already counted
        ext.add_access(_Access(-1 - len(ext.accesses), _bits_of(val),
                               "store", 1, 0, elems))
    return ext.property_vector(group_size=group_size, extra=extra_props)
