"""device_idle_pct.train: the share of the profiled whole steps of a train
cell in which no kernel, copy or memset ran on the device (1 − the union
of their intervals over the profiled window), in %."""


def read(ctx):
    prof = ctx.result.profile
    if ctx.kind != "train" or prof is None:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
