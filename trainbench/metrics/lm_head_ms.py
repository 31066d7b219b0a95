"""Device milliseconds a step launched inside the program's ``lm_head``
spans (the LM head's float32 logits through the loss's vocabulary mask,
log-sum-exp and gather, forward and backward), put down to them by
``span_trace.by_span``, the highest over the ranks, over the traced
steps. The yardstick of the float32 LM head."""

from trainbench import span_trace


def read(ctx):
    return span_trace.span_ms(ctx, "rt/lm_head")
