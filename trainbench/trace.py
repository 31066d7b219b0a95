"""Reduction of a ``torch.profiler`` chrome trace: device time by kernel,
the busy time of the device (the union of its operations' intervals),
and the idle gaps between them, each named by the harness span
(``record_function("tb:<name>")``) the host was in when the gap began."""

from __future__ import annotations

import json
from typing import Dict, List

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def reduce(path: str) -> Dict[str, object]:
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    ops, spans = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            ops.append((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]),
                        ev.get("name", cat)))
        elif cat == "user_annotation" and ev.get("name", "").startswith("tb:"):
            spans.append((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]),
                          ev["name"][3:]))
    by_name: Dict[str, List[float]] = {}
    for t0, t1, name in ops:
        acc = by_name.setdefault(name, [0.0, 0])
        acc[0] += (t1 - t0) * 1e-6
        acc[1] += 1
    merged: List[List[float]] = []
    for t0, t1, _ in sorted(ops):
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    busy = sum(t1 - t0 for t0, t1 in merged) * 1e-6
    spans.sort(key=lambda s: s[1] - s[0])        # innermost first

    def host_at(t):
        for s0, s1, name in spans:
            if s0 <= t < s1:
                return name
        return "outside_spans"

    gaps = [(merged[i + 1][0] - merged[i][1], host_at(merged[i][1]))
            for i in range(len(merged) - 1)]
    gaps.sort(reverse=True)
    return {"busy_s": busy,
            "kernels": {k: {"seconds": v[0], "launches": v[1]}
                        for k, v in by_name.items()},
            "idle_gaps": [[name, dt * 1e-6] for dt, name in gaps[:10]],
            "first_op_s": merged[0][0] * 1e-6 if merged else None,
            "last_op_s": merged[-1][1] * 1e-6 if merged else None}


def top_ops(kernels: Dict[str, dict], k: int = 10) -> List[list]:
    items = sorted(kernels.items(), key=lambda kv: -kv[1]["seconds"])[:k]
    return [[name[:160], v["seconds"]] for name, v in items]


def matching(kernels: Dict[str, dict], *needles) -> Dict[str, float]:
    """Seconds and launches of the kernels whose name holds any needle."""
    sec, n = 0.0, 0
    for name, v in kernels.items():
        if any(s in name for s in needles):
            sec += v["seconds"]
            n += v["launches"]
    return {"seconds": sec, "launches": n}
