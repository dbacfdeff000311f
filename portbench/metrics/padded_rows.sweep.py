"""padded_rows.sweep: per cent of the rows the eval step ran that
were padding, from the port's counters eval.padded_rows over eval.rows,
their change over the traced window."""
from portbench.readers import span_reading


def read(ctx):
    return span_reading(ctx, "sweep", "padded_rows.sweep")
