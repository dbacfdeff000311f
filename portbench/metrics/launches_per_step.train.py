"""launches_per_step.train: kernel-launch calls on the host (the runtime
and driver APIs' launch calls and graph launches) a step of the traced
window."""
from portbench.readers import launches


def read(ctx):
    return launches(ctx, "train")
