"""K3's share of its memory roofline on the manual path: each launch
combines one leaf's float32 per-machine gradients, (rows x D) read once,
the (D,) result written once and the rows' weights read once, over
3.35 TB/s, divided by the device time of the kernels named
``combine_vec`` / ``combine_scalar`` in the traced steps of rank 0. A
step launches once a leaf and a streamed chunk of ``stream_chunk``
machines (m / (ranks x chunk) chunks); another count returns nothing."""

import math

from trainbench import peaks, reference, trace


def read(ctx):
    tr = ctx["ranks"][0].get("trace")
    t = ctx["traffic"]
    if not tr or not tr["steps"] or t["path"] != "manual":
        return None
    got = trace.matching(tr["kernels"], "combine_vec", "combine_scalar")
    if not got["launches"] or got["seconds"] <= 0:
        return None
    fam = reference.family(ctx["cell"]["config"]["reference"])
    shapes = fam.param_shapes(ctx["model"])
    rows = t.get("stream_chunk") or t["machines"] // ctx["cards"]
    chunks = t["machines"] // (ctx["cards"] * rows)
    if got["launches"] != chunks * len(shapes) * tr["steps"]:
        return None
    per_step = chunks * sum((rows + 1) * 4 * math.prod(s) + 4 * rows
                            for s in shapes.values())
    least = per_step * tr["steps"] / peaks.HBM_BYTES_PER_S
    return 100.0 * least / got["seconds"]
