"""ssd_backward_ms.train: the device milliseconds a profiled step of a train
cell of the kernels, copies and memsets launched inside the program's
``ssd.backward`` spans (``models/ssm._SSDScan.backward``, on the autograd
thread; ``benchkit.spans``): the SSD layers' backward, kernels or plain
recompute."""


def read(ctx):
    if ctx.kind != "train":
        return None
    return ctx.span_ms(["ssd.backward"])
