"""attn_roofline.sweep: the port's attention kernels' share of their
roofline in the traced window, in per cent: the sum of each call's least
time over the kernels' device time, found by their symbols."""
from portbench.readers import attn_roofline


def read(ctx):
    return attn_roofline(ctx, "sweep")
