"""ssd_scan_roofline.prefill: the SSD scan calls of the profiled steps of a
prefill cell (``kernels.ops.ssd_scan`` in its range), the sum of each
call's roofline bound over the sum of its device seconds, in %.  A call's
bound is the larger of the recurrent form's 4·B·H·L·N·P operations at
the bf16 peak and x, dt, A, B, C read and y written once at the memory
peak."""
from benchkit import counts, entries

ENTRY = entries.SSD_SCAN


def bound_s(c: dict) -> float:
    ops = counts.ssd_ops(c["B"], c["H"], c["L"], c["N"], c["P"])
    nbytes = counts.ssd_bytes(c["B"], c["H"], c["L"], c["P"], c["G"],
                              c["N"], c["x_size"], c["dt_size"],
                              c["a_size"], c["bc_size"], c["y_size"])
    return counts.bound_s(ops, nbytes)


def read(ctx):
    calls = ctx.calls("ssd_scan")
    if ctx.kind != "prefill" or not calls:
        return None
    return 100.0 * sum(bound_s(c) for c, _ in calls) \
        / sum(s for _, s in calls)
