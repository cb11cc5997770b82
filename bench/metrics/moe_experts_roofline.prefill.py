"""moe_experts_roofline.prefill: the routed experts' products of the
profiled steps of a prefill cell (``models.moe.expert_products`` in its
range: every expert's down(relu(up x)²) over its rows), the sum of each
call's roofline bound over the sum of its device seconds, in %.  A call's
bound is the larger of 2 · 2 · rows · d · ff operations (up and down) at
the bf16 peak and the experts' weights (E · 2 · d · ff) with the rows
read and written once (2 · rows · d), at the memory peak: the same work
whatever computes the products."""
from benchkit import counts


def describe(x, offsets, up, down, *args, **kwargs) -> dict:
    return {"rows": x.shape[0], "E": up.shape[0], "d": up.shape[1],
            "ff": up.shape[2], "itemsize": x.element_size()}


ENTRY = ("repro_torch.models.moe", "expert_products", describe)


def bound_s(c: dict) -> float:
    ops = 2 * 2 * c["rows"] * c["d"] * c["ff"]
    nbytes = (c["E"] * 2 * c["d"] * c["ff"] + 2 * c["rows"] * c["d"]) \
        * c["itemsize"]
    return counts.bound_s(ops, nbytes)


def read(ctx):
    calls = ctx.calls("expert_products")
    if ctx.kind != "prefill" or not calls:
        return None
    return 100.0 * sum(bound_s(c) for c, _ in calls) \
        / sum(s for _, s in calls)
