"""device_idle.train: per cent of the traced window in which no operation
ran on the card (the union of the kernel, copy and set intervals of the
torch.profiler trace against the window's wall time)."""
from portbench.readers import device_idle


def read(ctx):
    return device_idle(ctx, "train")
