"""Analytic (datasheet-seeded) cost models for the registry.

The paper's headline claim is a *unified, vendor-independent* model: the same
property taxonomy fits GPUs "from multiple hardware generations and vendors"
(§5 fits NVIDIA Titan X / C2070 / K40 and AMD R9 Fury side by side).  The
registry exercises that claim with analytic seeds for several accelerators —
weights derived from public datasheet rates rather than fitted measurements.

An analytic seed plays the same role the datasheet-seeded v5e weights play in
``core.predictor``: a sane starting point that the black-box calibration
driver (``repro.calibration.calibrate``) would refine on real hardware.  Every
seed covers the *full* property taxonomy, so any property vector the
extractors emit is priced.

Only ``repro.core`` is imported here (calibration sits above core; core never
imports calibration at module load).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from repro_torch.core import predictor
from repro_torch.core import properties as props
from repro_torch.core.model import LinearCostModel


@dataclass(frozen=True)
class Datasheet:
    """Public peak rates for one accelerator — everything the analytic seed
    derives its seconds-per-event weights from."""
    name: str
    vendor: str
    matmul_flops: Dict[int, float]   # operand bits -> dense matmul FLOP/s
    vector_flops_f32: float          # FLOP/s, non-matmul f32 ALU rate
    mem_bw: float                    # B/s, HBM/GDDR stream bandwidth
    link_bw: float                   # B/s, per-device interconnect (one dir)
    launch_s: float = 5e-6           # per-dispatch overhead
    local_bw_mult: float = 20.0      # shared-mem/VMEM bandwidth vs HBM
    gather_penalty: float = 4.0      # uncoalesced-access bandwidth penalty
    notes: str = ""


def analytic_model(ds: Datasheet) -> LinearCostModel:
    """Seconds-per-event weights over the full taxonomy (the generalization
    of ``predictor.tpu_v5e_weights`` to any datasheet)."""
    w: Dict[str, float] = {}
    for bits, flops in ds.matmul_flops.items():
        w[props.mxu_key(bits)] = 1.0 / flops
    for kind, mult in (("add", 1.0), ("mul", 1.0), ("div", 4.0),
                       ("exp", 8.0), ("special", 8.0)):
        w[props.flop_key(32, kind)] = mult / ds.vector_flops_f32
        w[props.flop_key(16, kind)] = mult / (2 * ds.vector_flops_f32)
    for bits in props.SIZES:
        by = bits // 8
        for d in props.DIRECTIONS:
            w[props.mem_key(d, bits, "s0")] = 0.0        # broadcast: cached
            w[props.mem_key(d, bits, "s1")] = by / ds.mem_bw
            w[props.mem_key(d, bits, "gather")] = \
                ds.gather_penalty * by / ds.mem_bw
            for s in (2, 3, 4):
                for k in range(1, s + 1):
                    # stride-s with k/s utilization: pay the full footprint
                    w[props.mem_key(d, bits, f"s{s}_{k}/{s}")] = \
                        by * (s / k) / ds.mem_bw
            for k in range(1, 5):
                w[props.mem_key(d, bits, f"s>4_{k}/>4")] = \
                    ds.gather_penalty * by / ds.mem_bw
        w[props.minls_key(bits)] = 0.0
        w[props.local_key(bits)] = by / (ds.local_bw_mult * ds.mem_bw)
    for c in props.COLLECTIVES:
        # ring collectives saturate the link; all_to_all crosses bisection
        w[props.coll_key(c)] = (1.0 / ds.link_bw if c != "all_to_all"
                                else 2.0 / ds.link_bw)
    w[props.BARRIER] = 1e-7
    w[props.GROUPS] = 1e-7
    w[props.CONST1] = ds.launch_s
    return LinearCostModel.from_dict(
        w, device=ds.name,
        meta={"source": "datasheet-seed", "vendor": ds.vendor,
              "notes": ds.notes})


# ---------------------------------------------------------------------------
# The seed catalog — cross-vendor, as the paper demands
# ---------------------------------------------------------------------------

GPU_DATASHEETS: Dict[str, Datasheet] = {
    "gpu-a100": Datasheet(
        name="gpu-a100", vendor="nvidia",
        matmul_flops={16: 312e12, 32: 19.5e12},   # TF32-off f32 path
        vector_flops_f32=19.5e12, mem_bw=2039e9, link_bw=300e9,
        notes="A100-SXM 80GB: 312 TFLOP/s bf16 TC, 2.0 TB/s HBM2e, "
              "600 GB/s NVLink bidir"),
    "gpu-h100": Datasheet(
        name="gpu-h100", vendor="nvidia",
        matmul_flops={16: 989e12, 32: 67e12},
        vector_flops_f32=67e12, mem_bw=3350e9, link_bw=450e9,
        notes="H100-SXM: 989 TFLOP/s bf16 TC dense, 3.35 TB/s HBM3, "
              "900 GB/s NVLink bidir"),
    "gpu-mi300x": Datasheet(
        name="gpu-mi300x", vendor="amd",
        matmul_flops={16: 1307e12, 32: 163e12},
        vector_flops_f32=163e12, mem_bw=5300e9, link_bw=448e9,
        notes="MI300X: 1.3 PFLOP/s bf16 MFMA, 5.3 TB/s HBM3, "
              "~896 GB/s Infinity Fabric bidir"),
}


def _seed_builders() -> Dict[str, "callable"]:
    out: Dict[str, "callable"] = {
        # the v5e seed stays defined in core.predictor (it predates the
        # registry and tests/benchmarks use it directly); expose it verbatim
        "tpu-v5e": predictor.tpu_v5e_weights,
    }
    for name, ds in GPU_DATASHEETS.items():
        out[name] = (lambda d=ds: analytic_model(d))
    return out


#: device name -> zero-arg builder returning a fresh ``LinearCostModel``
ANALYTIC_SEEDS: Dict[str, "callable"] = _seed_builders()
