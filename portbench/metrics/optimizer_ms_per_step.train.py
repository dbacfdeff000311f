"""optimizer_ms_per_step.train: host ms a step of the traced window in
missm.train.optimizer: the Adam update of the trainable leaves."""
from portbench.readers import span_reading


def read(ctx):
    return span_reading(ctx, "train", "optimizer_ms_per_step.train")
