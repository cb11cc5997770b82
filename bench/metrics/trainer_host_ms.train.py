"""trainer_host_ms.train: the mean over the window's steps of each
``Trainer.train`` call's host-clock wall less its own ``train_step`` span
(``obs/trace``): the loader, the copy to the card and the bookkeeping
around the step, in ms."""


def read(ctx):
    host = ctx.result.host_ms
    if ctx.kind != "train" or not host:
        return None
    return sum(host) / len(host)
