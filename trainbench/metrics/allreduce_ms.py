"""Device milliseconds a step of the NCCL all-reduce kernels (by their
profiler names), the highest over the ranks, over the traced steps."""

from trainbench import trace


def read(ctx):
    best = None
    for r in ctx["ranks"]:
        tr = r.get("trace")
        if not tr or not tr["steps"]:
            continue
        got = trace.matching({k: v for k, v in tr["kernels"].items()
                              if "nccl" in k.lower()}, "AllReduce")
        if got["launches"]:
            ms = got["seconds"] / tr["steps"] * 1e3
            best = ms if best is None else max(best, ms)
    return best
