"""mfu.sweep: model FLOP (counts/flops.py) of the window's completed
rows over its seconds, in per cent of the H100's 989 TFLOP/s."""
from portbench.readers import mfu


def read(ctx):
    return mfu(ctx, "sweep")
