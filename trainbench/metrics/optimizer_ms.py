"""Device milliseconds a step launched inside the program's ``optimizer``
span (AdamW's update and its application to the parameters), put down to
it by ``span_trace.by_span``, the highest over the ranks, over the traced
steps. The yardstick of the optimizer's update."""

from trainbench import span_trace


def read(ctx):
    return span_trace.span_ms(ctx, "rt/optimizer")
