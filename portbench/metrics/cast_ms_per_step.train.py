"""cast_ms_per_step.train: host ms a step of the traced window in
missm.model.cast: the encoder's parameters cast to the compute type."""
from portbench.readers import span_reading


def read(ctx):
    return span_reading(ctx, "train", "cast_ms_per_step.train")
