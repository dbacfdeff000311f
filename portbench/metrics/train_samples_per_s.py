"""train_samples_per_s: samples of the steps completed in the window over
the window's seconds (host clock)."""


def read(ctx):
    return ctx.work / ctx.seconds if ctx.kind == "train" else None
