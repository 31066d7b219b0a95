"""Share of the traced window in which no device operation runs: one
minus the union of the operations' intervals over the window's wall
time, the highest over the ranks."""


def read(ctx):
    shares = [100.0 * (1.0 - r["trace"]["busy_s"] / r["trace"]["window_s"])
              for r in ctx["ranks"] if r.get("trace")
              and r["trace"]["window_s"] > 0]
    return max(shares) if shares else None
