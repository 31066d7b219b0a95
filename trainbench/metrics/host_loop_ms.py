"""Host milliseconds a step outside the step call: the wait for the next
coded batch from the worker thread and its copy to the card (the
harness's ``host_loop`` span, rank 0, every step of the window)."""

import statistics


def read(ctx):
    t = ctx["ranks"][0]["spans"].get("host_loop")
    return statistics.mean(t) * 1e3 if t else None
