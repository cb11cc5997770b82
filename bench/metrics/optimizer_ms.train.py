"""optimizer_ms.train: the device milliseconds a profiled step of a train
cell of the kernels, copies and memsets launched inside the program's
``train.optimizer`` span (``runtime/steps.make_train_step``: the clip and
AdamW's update; ``benchkit.spans``)."""


def read(ctx):
    if ctx.kind != "train":
        return None
    return ctx.span_ms(["train.optimizer"])
