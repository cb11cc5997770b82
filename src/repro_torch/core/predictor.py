"""The analytic v5e seed and the model-argument rules of the predictor.

Only the part of the reference's ``core/predictor.py`` that the registry
needs: the v5e datasheet constants, ``tpu_v5e_weights`` (the registry's
``"tpu-v5e"`` seed and the ``None`` default of ``resolve_model``),
``ModelLike`` and ``resolve_model``.  Step-time prediction over
(arch × shape × mesh × plan) arrives with ``core/workload.py`` and
``archcount.py``.

The constants are a TPU v5e datasheet's, kept so that model files and
``resolve_model(None)`` behave as in the reference; they are catalog data
for another device, not a figure of the H100.
"""
from __future__ import annotations

from typing import Dict, Union

from repro_torch.core import properties as props
from repro_torch.core.model import LinearCostModel

# --- v5e hardware constants (per chip) ---
PEAK_FLOPS_BF16 = 197e12     # FLOP/s
PEAK_FLOPS_F32 = 49e12       # VPU-ish f32 rate
HBM_BW = 819e9               # B/s
ICI_BW = 50e9                # B/s per link (≈3 links usable per axis-dir)
LAUNCH_S = 5e-6              # per-dispatch overhead


def tpu_v5e_weights() -> LinearCostModel:
    """Analytic seconds-per-event weights for the property taxonomy."""
    w: Dict[str, float] = {}
    w[props.mxu_key(16)] = 1.0 / PEAK_FLOPS_BF16
    w[props.mxu_key(32)] = 1.0 / (PEAK_FLOPS_BF16 / 4)  # f32 matmul 1/4 rate
    for kind, mult in (("add", 1.0), ("mul", 1.0), ("div", 4.0),
                       ("exp", 8.0), ("special", 8.0)):
        w[props.flop_key(32, kind)] = mult / PEAK_FLOPS_F32
        w[props.flop_key(16, kind)] = mult / (2 * PEAK_FLOPS_F32)
    for bits in props.SIZES:
        by = bits // 8
        for d in props.DIRECTIONS:
            w[props.mem_key(d, bits, "s0")] = 0.0          # broadcast: cached
            w[props.mem_key(d, bits, "s1")] = by / HBM_BW
            w[props.mem_key(d, bits, "gather")] = 4.0 * by / HBM_BW
            for s in (2, 3, 4):
                for k in range(1, s + 1):
                    # stride-s with k/s utilization: pay the full footprint
                    w[props.mem_key(d, bits, f"s{s}_{k}/{s}")] = \
                        by * (s / k) / HBM_BW
            for k in range(1, 5):
                w[props.mem_key(d, bits, f"s>4_{k}/>4")] = 4.0 * by / HBM_BW
        w[props.minls_key(bits)] = 0.0   # duplex HBM: no extra gain modeled
        w[props.local_key(bits)] = by / (20 * HBM_BW)  # VMEM ≈ 20× HBM BW
    for c in props.COLLECTIVES:
        # ring collectives over ICI; all_to_all crosses bisection
        w[props.coll_key(c)] = 1.0 / (3 * ICI_BW) if c != "all_to_all" \
            else 1.0 / (2 * ICI_BW)
    w[props.BARRIER] = 1e-7
    w[props.GROUPS] = 1e-7
    w[props.CONST1] = LAUNCH_S
    return LinearCostModel.from_dict(w, device="tpu-v5e-analytic",
                                     meta={"source": "datasheet-seed"})


# ---------------------------------------------------------------------------

#: what every prediction entry point accepts: an in-memory model, a registry
#: device name (resolved via ``repro_torch.calibration``), or None (v5e seed).
ModelLike = Union[LinearCostModel, str, None]


def resolve_model(model: ModelLike) -> LinearCostModel:
    """Normalize a model argument.  ``None`` is the deterministic default —
    the built-in analytic v5e seed, never a registry file; a string is a
    registry device name (where a fitted model shadows a same-named seed).

    Delegates to ``repro_torch.calibration.registry.resolve_model`` (the
    single home of these rules), imported lazily because calibration sits
    above core."""
    from repro_torch.calibration import registry
    return registry.resolve_model(model)
