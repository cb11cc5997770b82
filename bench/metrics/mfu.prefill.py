"""mfu.prefill: a prefill step's forward model FLOPs
(``counts.forward_flops``: the configuration's reference module's
own where it defines one) over the bf16 peak times the mean host-clock
seconds of the window's unprofiled steps, in %."""
from benchkit import counts


def read(ctx):
    steps = ctx.result.timed_s
    if ctx.kind != "prefill" or not steps:
        return None
    t = ctx.traffic
    flops = counts.forward_flops(ctx.config, t["batch"], t["seq_len"],
                                 ctx.ref)
    return 100.0 * flops / (counts.PEAK_FLOPS * sum(steps) / len(steps))
