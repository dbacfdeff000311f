"""upload_ms_per_step.train: host ms a step of the traced window in
missm.model.upload: the batch's copy from host memory to the card."""
from portbench.readers import span_reading


def read(ctx):
    return span_reading(ctx, "train", "upload_ms_per_step.train")
