"""GiB a rank handed the all-reduce a step: the program's own counter
(``dist.process_group.traffic["all_reduce"]``) over the traced steps,
rank 0."""


def read(ctx):
    moved = ctx["ranks"][0].get("traffic_bytes_per_step", {})
    b = moved.get("all_reduce", 0)
    return b / float(1 << 30) if b else None
