"""eval_host_ms_per_batch.sweep: host ms a batch of the traced window
in missm.eval.point's self time: the sweep's own work around its batches
(metrics, the report, the loop), less its waits, steps and readbacks."""
from portbench.readers import span_reading


def read(ctx):
    return span_reading(ctx, "sweep", "eval_host_ms_per_batch.sweep")
