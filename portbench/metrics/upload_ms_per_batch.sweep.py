"""upload_ms_per_batch.sweep: host ms a batch of the traced window
in missm.model.upload: the batch's copy from host memory to the card."""
from portbench.readers import span_reading


def read(ctx):
    return span_reading(ctx, "sweep", "upload_ms_per_batch.sweep")
