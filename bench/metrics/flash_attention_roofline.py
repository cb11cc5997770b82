"""flash_attention_roofline: the attention calls of the profiled steps
(``kernels.ops.flash_attention`` in its range), the sum of each call's
roofline bound over the sum of its device seconds, in %.  A call's bound
is the larger of 4·B·Hq·(visible pairs)·dh operations at the bf16 peak
and q, k, v read and o (and lse) written once at the memory peak."""
from benchkit import counts, entries

ENTRY = entries.FLASH_ATTENTION


def bound_s(c: dict) -> float:
    ops = counts.attention_ops(c["B"], c["Hq"], c["Sq"], c["Skv"], c["dh"],
                               c["causal"], c["window"])
    nbytes = counts.attention_bytes(c["B"], c["Hq"], c["Hkv"], c["Sq"],
                                    c["Skv"], c["dh"], c["itemsize"],
                                    c["lse"])
    return counts.bound_s(ops, nbytes)


def read(ctx):
    calls = ctx.calls("flash_attention")
    if not calls:
        return None
    return 100.0 * sum(bound_s(c) for c, _ in calls) \
        / sum(s for _, s in calls)
