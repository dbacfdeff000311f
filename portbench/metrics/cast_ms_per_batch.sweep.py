"""cast_ms_per_batch.sweep: host ms a batch of the traced window in
missm.model.cast: the encoder's parameters cast to the compute type."""
from portbench.readers import span_reading


def read(ctx):
    return span_reading(ctx, "sweep", "cast_ms_per_batch.sweep")
