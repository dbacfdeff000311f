"""input_wait_ms_per_batch.sweep: host ms a batch of the traced window
in missm.eval.wait: the consumer's wait on the loader's prefetch thread."""
from portbench.readers import span_reading


def read(ctx):
    return span_reading(ctx, "sweep", "input_wait_ms_per_batch.sweep")
