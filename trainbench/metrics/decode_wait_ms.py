"""Host milliseconds a step spent getting the decoded weights w: the
``LookaheadPrefetcher``'s ``next()`` and, on several ranks, w's
broadcast (the harness's ``decode_wait`` span, rank 0, every step of the
window)."""

import statistics


def read(ctx):
    t = ctx["ranks"][0]["spans"].get("decode_wait")
    return statistics.mean(t) * 1e3 if t else None
