"""Device milliseconds a step launched inside the program's ``attention``
spans (``repro_torch.spans``: the blockwise attention's forward, its
rematerialised forward and its flash backward), put down to them by
``span_trace.by_span``, the highest over the ranks, over the traced
steps. The yardstick of the attention tile loop."""

from trainbench import span_trace


def read(ctx):
    return span_trace.span_ms(ctx, "rt/attention")
