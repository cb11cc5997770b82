"""mfu.train: the training step's model FLOPs (forward + backward,
``counts.train_flops``: three times the forward's, the configuration's
reference module's own ``forward_flops`` where it defines one) over the
bf16 peak times the mean host-clock seconds of the window's unprofiled
steps, in %."""
from benchkit import counts


def read(ctx):
    steps = ctx.result.timed_s
    if ctx.kind != "train" or not steps:
        return None
    t = ctx.traffic
    flops = counts.train_flops(ctx.config, t["batch"], t["seq_len"],
                               ctx.ref)
    return 100.0 * flops / (counts.PEAK_FLOPS * sum(steps) / len(steps))
