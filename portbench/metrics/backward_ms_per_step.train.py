"""backward_ms_per_step.train: host ms a step of the traced window in
missm.train.backward: the loss's backward, launched from the host."""
from portbench.readers import span_reading


def read(ctx):
    return span_reading(ctx, "train", "backward_ms_per_step.train")
