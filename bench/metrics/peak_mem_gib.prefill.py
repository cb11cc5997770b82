"""peak_mem_gib.prefill: the allocator's peak over the window of a prefill cell
(``torch.cuda.max_memory_allocated`` after a reset at the window's
start), in GiB."""


def read(ctx):
    peak = ctx.result.window_peak_bytes
    if ctx.kind != "prefill" or not peak:
        return None
    return peak / 2**30
