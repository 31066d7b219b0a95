"""K1's share of its memory roofline: the bytes its launches need at the
step's shapes (the activation read once and written once, in the compute
dtype, and the float32 scale read once, a launch) over 3.35 TB/s, divided
by the device time of the kernels named ``rmsnorm_kernel*`` in the
traced steps of rank 0. Every launch of a step normalises one forward
pass's tokens: all blocks at once on the dedup path, one machine's
blocks a streamed chunk on the manual path."""

from trainbench import peaks, trace
from trainbench.reference import coding


def read(ctx):
    tr = ctx["ranks"][0].get("trace")
    if not tr:
        return None
    got = trace.matching(tr["kernels"], "rmsnorm_kernel")
    if not got["launches"] or got["seconds"] <= 0:
        return None
    t, model = ctx["traffic"], ctx["model"]
    A = coding.assignment(t["scheme"], t["machines"], t["replication"])
    blocks = A.shape[0] if t["path"] == "dedup" else int(A.sum(axis=0).max())
    tokens = blocks * t["block_size"] * t["seq_len"]
    item = 2 if model.get("dtype", "bfloat16") in ("bfloat16", "float16") \
        else 4
    D = model["d_model"]
    per_launch = 2 * tokens * D * item + 4 * D
    least = got["launches"] * per_launch / peaks.HBM_BYTES_PER_S
    return 100.0 * least / got["seconds"]
