"""The property taxonomy — §2 of the paper, adapted GPU→TPU/XLA.

A *property* is a performance-relevant event class whose count contributes
linearly to run time.  The paper's categories and our TPU/XLA analog:

================================  ==========================================
paper (GPU / OpenCL)              this system (XLA / TPU target, CPU runtime)
================================  ==========================================
global loads/stores by            HBM-stream accesses by element size ×
(32/64/128-bit × direction ×      direction × *access class*:
 amortized stride fraction)         s0    broadcast / uniform (stride-0)
                                    s1    contiguous last-dim stream
                                    sK_U  strided slice, stride K with
                                          utilization class U (the paper's
                                          amortized stride fraction: 1/2,
                                          2/2, 1/3 … 4/>4)
                                    gather  data-dependent / relayout access
                                          (the 'uncoalesced' class)
min(loads, stores)                identical (roofline-style nonlinearity)
local (shared-memory) loads       VMEM block transfers (Pallas BlockSpec
                                  traffic; XLA fusion-internal reuse)
FLOPs by kind × dtype             VPU flops by kind × dtype, plus a separate
                                  MXU property for dot_general contractions
                                  (the dominant rate split on TPU)
barriers                          grid-step synchronisations (Pallas grid
                                  barriers / scan steps)
const(1), work-group count        launch constant + grid-cell ('group') count
—                                 **beyond-paper**: collective bytes by kind
                                  (all_reduce / all_gather / reduce_scatter /
                                  all_to_all / permute) for multi-chip steps
================================  ==========================================

Property keys are plain strings so vectors serialize to JSON:

    load:32:s1      32-bit stride-1 loads         (count = accesses)
    store:64:s0     64-bit uniform stores
    load:32:s2_1/2  stride-2, utilization 1/2
    load:32:gather  uncoalesced loads
    minls:32        min(stride-1 loads, stride-1 stores)
    local:32:load   local/VMEM loads
    flop:32:add     f32 add/sub VPU flops
    flop:32:mul | flop:32:div | flop:32:exp | flop:32:special
    mxu:16 | mxu:32 dot_general MAC flops by operand bits
    barrier         barrier events
    groups          work-group / grid-cell count
    const1          1 per launch
    coll:all_reduce (bytes)  … coll:permute (bytes)
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Tuple

# ---------------------------------------------------------------------------
# Canonical key constructors
# ---------------------------------------------------------------------------

DIRECTIONS = ("load", "store")
SIZES = (16, 32, 64)  # element bits tracked (bf16 / f32 / f64)
FLOP_KINDS = ("add", "mul", "div", "exp", "special")

COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter",
               "all_to_all", "permute")


def stride_class(stride: int, utilization: float) -> str:
    """Quantize (stride, utilization ratio) into the paper's §2.1 classes.

    stride 0 -> 's0'; stride 1 -> 's1'; stride s in {2,3,4} -> 'sK_k/K' with
    k the quantized utilization numerator; stride > 4 -> 's>4_k/>4'.
    """
    if stride == 0:
        return "s0"
    if stride == 1:
        return "s1"
    s = stride if stride <= 4 else ">4"
    denom = stride if stride <= 4 else 4  # numerator quantized over 4 bins
    # utilization in (0,1]; numerator k = ceil(util * denom), clipped to denom
    k = max(1, min(denom, int(-(-utilization * denom // 1))))
    return f"s{s}_{k}/{s}"


def mem_key(direction: str, bits: int, cls: str) -> str:
    assert direction in DIRECTIONS
    return f"{direction}:{bits}:{cls}"


def flop_key(bits: int, kind: str) -> str:
    assert kind in FLOP_KINDS
    return f"flop:{bits}:{kind}"


def mxu_key(bits: int) -> str:
    return f"mxu:{bits}"


def minls_key(bits: int) -> str:
    return f"minls:{bits}"


def local_key(bits: int) -> str:
    return f"local:{bits}:load"


def coll_key(kind: str) -> str:
    assert kind in COLLECTIVES
    return f"coll:{kind}"


BARRIER = "barrier"
GROUPS = "groups"
CONST1 = "const1"


# ---------------------------------------------------------------------------
# PropertyVector = Dict[str, number]; helpers
# ---------------------------------------------------------------------------

PropertyVector = Dict[str, float]


def finalize(pv: Mapping[str, float]) -> PropertyVector:
    """Drop zeros, add const1, and the min(loads, stores) properties."""
    out = {k: float(v) for k, v in pv.items() if v}
    for bits in SIZES:
        l = out.get(mem_key("load", bits, "s1"), 0.0)
        s = out.get(mem_key("store", bits, "s1"), 0.0)
        m = min(l, s)
        if m:
            out[minls_key(bits)] = m
    out[CONST1] = 1.0
    return out


def union_keys(vectors: Iterable[Mapping[str, float]]) -> List[str]:
    keys = set()
    for v in vectors:
        keys.update(v.keys())
    return sorted(keys)


def to_matrix(vectors: List[Mapping[str, float]], keys: List[str]):
    import numpy as np
    A = np.zeros((len(vectors), len(keys)))
    for i, v in enumerate(vectors):
        for j, k in enumerate(keys):
            A[i, j] = v.get(k, 0.0)
    return A


#: the coarse attribution buckets reports aggregate properties into
CATEGORIES = ("compute", "memory", "collective", "other")


def category(key: str) -> str:
    """Coarse cost category of a property key — the shared classification
    ``predictor.predict_step`` terms, ``obs.explain`` groupings, and the
    drift-attribution lines all use (one mapping, not three)."""
    head = key.split(":", 1)[0]
    if head in ("mxu", "flop"):
        return "compute"
    if head in ("load", "store", "local", "minls"):
        return "memory"
    if head == "coll":
        return "collective"
    return "other"


# Human-readable names for reports (Table-2 analog)
PRETTY = {
    "s0": "uniform (stride-0)",
    "s1": "stride-1",
    "gather": "uncoalesced/gather",
}


def pretty(key: str) -> str:
    parts = key.split(":")
    if key == BARRIER:
        return "Barriers"
    if key == GROUPS:
        return "Thread groups / grid cells"
    if key == CONST1:
        return "Const(1) launch overhead"
    if parts[0] == "coll":
        return f"Collective {parts[1]} (bytes)"
    if parts[0] == "minls":
        return f"Min(stride-1 loads, stride-1 stores) [{parts[1]}-bit]"
    if parts[0] == "local":
        return f"Local/VMEM {parts[1]}-bit loads"
    if parts[0] == "mxu":
        return f"MXU (dot) flops [{parts[1]}-bit]"
    if parts[0] == "flop":
        return f"{parts[2].capitalize()} flops [{parts[1]}-bit]"
    if parts[0] in DIRECTIONS:
        cls = PRETTY.get(parts[2], parts[2])
        return f"{parts[1]}-bit {cls} {parts[0]}s"
    return key
