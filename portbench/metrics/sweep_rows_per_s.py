"""sweep_rows_per_s: real rows of the (type, ratio) points completed in the
window over the window's seconds (host clock); padding rows do not count."""


def read(ctx):
    return ctx.work / ctx.seconds if ctx.kind == "sweep" else None
