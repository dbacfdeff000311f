"""mfu.train: model FLOP (counts/flops.py) of the window's completed
samples over its seconds, in per cent of the H100's 989 TFLOP/s."""
from portbench.readers import mfu


def read(ctx):
    return mfu(ctx, "train")
