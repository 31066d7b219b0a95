"""Share of the blockwise attention's tiles skipped because the mask
wholly hides them: the program's counter ``attention.tiles`` (computed
and skipped, a tile per call of the forward, the rematerialised forward
and the flash backward) over the traced steps, summed over the ranks.
Positions alone set it: 28 of 64 tiles a call of a causal 4,096-token
sequence, 1 of 4 of a 1,024-token one."""

COUNTERS = {"tiles": "repro_torch.models.attention:tiles"}


def read(ctx):
    skipped = seen = 0.0
    for r in ctx["ranks"]:
        got = (r.get("trace") or {}).get("counters", {}).get("tiles")
        if got:
            skipped += got["skipped"]
            seen += got["skipped"] + got["computed"]
    return 100.0 * skipped / seen if seen else None
