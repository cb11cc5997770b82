"""moe_routing_ms.prefill: the device milliseconds a profiled step of a
prefill cell of the kernels, copies and memsets launched inside the
program's ``moe.route``, ``moe.dispatch`` and ``moe.combine`` spans
(``models/moe.moe_apply``: the f32 router and its picks, the dispatch to
the experts' slots, the weighted combine; not ``moe.experts``;
``benchkit.spans``)."""

SPANS = ("moe.route", "moe.dispatch", "moe.combine")


def read(ctx):
    if ctx.kind != "prefill":
        return None
    return ctx.span_ms(SPANS)
