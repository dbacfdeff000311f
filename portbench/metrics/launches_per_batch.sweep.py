"""launches_per_batch.sweep: kernel-launch calls on the host (the runtime
and driver APIs' launch calls and graph launches) a batch of the traced
window."""
from portbench.readers import launches


def read(ctx):
    return launches(ctx, "sweep")
