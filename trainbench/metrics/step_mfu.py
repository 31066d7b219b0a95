"""Share of the cards' bfloat16 peak in model FLOPs: the FLOPs of the
step's distinct tokens (the reference family's ``step_flops``) over the
window's wall time a step, times the peak (``trainbench.peaks``), times
the cards. The peak is the 700 W data sheet's; the result carries the
card's power limit."""

from trainbench import peaks, reference
from trainbench.reference import coding


def read(ctx):
    lead = ctx["ranks"][0]
    steps = lead["window_steps"]
    if not steps:
        return None
    tr = ctx["traffic"]
    n = coding.assignment(tr["scheme"], tr["machines"],
                          tr["replication"]).shape[0]
    fam = reference.family(ctx["cell"]["config"]["reference"])
    f = fam.step_flops(ctx["model"], tr["seq_len"], n * tr["block_size"])
    per_step = lead["window_s"] / steps
    return 100.0 * f / (per_step * peaks.BF16_FLOPS * ctx["cards"])
