"""device_idle_pct.prefill: the share of the profiled whole steps of a prefill
cell in which no kernel, copy or memset ran on the device (1 − the union
of their intervals over the profiled window), in %."""


def read(ctx):
    prof = ctx.result.profile
    if ctx.kind != "prefill" or prof is None:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
