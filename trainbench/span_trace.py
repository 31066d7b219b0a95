"""Device time of a ``torch.profiler`` chrome trace put down to the span
that launched it.

The program's spans (``rt/<name>``, ``repro_torch.spans``) and the
harness's (``tb:<name>``, ``harness.Spans``) are ``record_function``
ranges on the profiler's timeline. Each device operation (kernel, memcpy,
memset, NCCL's kernels among them) is linked by its ``correlation`` id to
the runtime or driver call that launched it, and goes to exactly one of:

(a) the innermost span around that call on the launching thread. Inside
    a backward node (``autograd::engine::evaluate_function: ...``) only
    the spans opened within the node count here: such a span is the
    layer's forward entered again by rematerialisation (``recompute``)
    unless the program marked it as a backward (``rt/<name>/backward``);
(b) else, inside a backward node, the innermost span around the forward
    op that made the node: the last op with the node's ``Sequence
    number`` on its forward thread (``Fwd thread id``; ops before it that
    made no node carry the same number), booked as ``backward``; else
    the spans the launching thread had open around the node;
(c) else ``unattributed``.

A span's chain of enclosing spans is that of the launching thread; inside
a backward node it starts with the chain of the node's forward op, so a
recomputed or backward kernel also counts to the spans around its
forward. ``by_span`` reports, per span name (``rt/<name>`` or
``tb:<name>``), device seconds split into forward, recompute and backward
(the span and the spans inside it), self seconds (the operations whose
innermost span it is; these and ``unattributed`` sum to the total) and
launches, the top unattributed operations, and the ten longest idle gaps
of the device named by the span the thread that launched the next
operation was in when the gap began. ``summary`` condenses one rank's
attribution for the result line: device ms a step by span and phase, the
partition's check, and the float32 products' share in attention and the
LM head.
"""

from __future__ import annotations

import json
import time
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

from trainbench.trace import DEVICE_CATS

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PREFIXES = ("rt/", "tb:")
BACKWARD_MARK = "/backward"
NODE = "autograd::engine::evaluate_function:"
PHASES = ("forward", "recompute", "backward")
UNATTRIBUTED = "unattributed"
OUTSIDE = "outside_spans"
F32 = ("f32f32", "simt_sgemm")      # names of cuBLAS's float32 products


class _Interval:
    __slots__ = ("t0", "t1", "name", "seq", "fwd")

    def __init__(self, t0, t1, name, seq=None, fwd=None):
        self.t0, self.t1, self.name = t0, t1, name
        self.seq, self.fwd = seq, fwd


def _open_at(intervals: List[_Interval], points: Iterable[float]
             ) -> Dict[float, Tuple[_Interval, ...]]:
    """For each point t the intervals with t0 <= t < t1, outermost first
    (intervals of one thread nest)."""
    ivs = sorted(intervals, key=lambda i: (i.t0, -i.t1))
    out, stack, j = {}, [], 0
    for t in sorted(set(points)):
        while j < len(ivs) and ivs[j].t0 <= t:
            iv = ivs[j]
            while stack and stack[-1].t1 <= iv.t0:
                stack.pop()
            stack.append(iv)
            j += 1
        while stack and stack[-1].t1 <= t:
            stack.pop()
        out[t] = tuple(i for i in stack if i.t1 > t)
    return out


def load_events(path: str) -> list:
    with open(path) as f:
        return json.load(f).get("traceEvents", [])


class _Timeline:
    """The trace's spans, backward nodes and forward ops by thread, and
    the chain of spans at a point of a thread."""

    def __init__(self, events: list):
        self.spans = defaultdict(list)
        self.nodes = defaultdict(list)
        self.fwd_ops = defaultdict(list)      # seq -> [(tid, ts)]
        self.host = defaultdict(list)         # host ops and runtime calls
        self.launches = {}                    # correlation -> (tid, ts)
        self.ops = []                         # (t0, t1, name, correlation)
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat, name = ev.get("cat", ""), ev.get("name", "")
            args = ev.get("args") or {}
            ts = float(ev["ts"])
            if cat == "cpu_op" or cat in LAUNCH_CATS:
                self.host[ev.get("tid")].append(
                    _Interval(ts, ts + float(ev["dur"]), name))
            if cat in DEVICE_CATS:
                self.ops.append((ts, ts + float(ev["dur"]), name or cat,
                                 args.get("correlation")))
            elif cat in LAUNCH_CATS and "correlation" in args:
                self.launches[args["correlation"]] = (ev.get("tid"), ts)
            elif cat == "user_annotation" and name.startswith(PREFIXES):
                self.spans[ev.get("tid")].append(
                    _Interval(ts, ts + float(ev["dur"]), name))
            elif cat == "cpu_op" and name.startswith(NODE):
                self.nodes[ev.get("tid")].append(_Interval(
                    ts, ts + float(ev["dur"]), name,
                    args.get("Sequence number"), args.get("Fwd thread id")))
            elif (cat == "cpu_op" and "Sequence number" in args
                  and not args.get("Fwd thread id")):
                self.fwd_ops[args["Sequence number"]].append(
                    (ev.get("tid"), ts))
        self._thread_of = self._fwd_threads()

    def _fwd_threads(self) -> Dict[object, object]:
        """The trace thread of each ``Fwd thread id``: the thread that
        holds most of the forward ops its nodes name."""
        votes = defaultdict(Counter)
        for nodes in self.nodes.values():
            for n in nodes:
                for tid, _ in self.fwd_ops.get(n.seq, ()):
                    votes[n.fwd][tid] += 1
        return {f: c.most_common(1)[0][0] for f, c in votes.items()}

    def resolve(self, points: Dict[object, set]):
        """{(tid, t): (chain of span names outermost first, phase)} for
        the points of each thread."""
        spans_at, nodes_at = {}, {}
        for tid, ts in points.items():
            spans_at[tid] = _open_at(self.spans.get(tid, []), ts)
            nodes_at[tid] = _open_at(self.nodes.get(tid, []), ts)
        # the forward op of every node a point lies in
        need = defaultdict(set)
        fwd_of = {}
        for tid, ts in points.items():
            for t in ts:
                node = nodes_at[tid][t][-1] if nodes_at[tid][t] else None
                if node is None or id(node) in fwd_of:
                    continue
                # ops that made no node carry the number the next node
                # will take: the node's maker is the last op with it
                thread = self._thread_of.get(node.fwd)
                made = max((ts_ for tid_, ts_ in
                            self.fwd_ops.get(node.seq, ())
                            if tid_ == thread), default=None)
                fwd_of[id(node)] = None if made is None else (thread, made)
                if made is not None:
                    need[thread].add(made)
        fwd_spans = {tid: _open_at(self.spans.get(tid, []), ts)
                     for tid, ts in need.items()}
        out = {}
        for tid, ts in points.items():
            for t in ts:
                open_spans = spans_at[tid][t]
                nodes = nodes_at[tid][t]
                if not nodes:
                    names = [s.name for s in open_spans]
                    phase = ("backward" if any(n.endswith(BACKWARD_MARK)
                                               for n in names) else
                             "forward")
                    out[(tid, t)] = (names, phase)
                    continue
                node = nodes[-1]
                inner = [s.name for s in open_spans if s.t0 >= node.t0]
                fwd = fwd_of.get(id(node))
                base = ([s.name for s in fwd_spans[fwd[0]][fwd[1]]]
                        if fwd else [])
                if not base:
                    base = [s.name for s in open_spans if s.t0 < node.t0]
                phase = ("recompute" if inner and not any(
                    n.endswith(BACKWARD_MARK) for n in inner)
                    else "backward")
                out[(tid, t)] = (base + inner, phase)
        return out


def _base(name: str) -> str:
    return name[:-len(BACKWARD_MARK)] if name.endswith(BACKWARD_MARK) \
        else name


def attribute(events: list):
    """(records, timeline): one record a device operation, (name,
    seconds, chain of span names outermost first or [] where
    unattributed, phase)."""
    tl = _Timeline(events)
    points = defaultdict(set)
    for _, _, _, corr in tl.ops:
        if corr in tl.launches:
            tid, ts = tl.launches[corr]
            points[tid].add(ts)
    where = tl.resolve(points)
    records = []
    for t0, t1, name, corr in tl.ops:
        chain, phase = [], "forward"
        if corr in tl.launches:
            chain, phase = where[tl.launches[corr]]
        records.append((name, (t1 - t0) * 1e-6, [_base(n) for n in chain],
                        phase))
    return records, tl


def _idle_gaps(tl: _Timeline) -> List[list]:
    """The ten longest gaps between the device's busy intervals, each as
    [span, phase, seconds, host op]: the innermost span (``outside_spans``
    where none) of the thread that launched the operation after the gap,
    when the gap began, and the innermost op or runtime call that thread
    was in then."""
    order = sorted(range(len(tl.ops)), key=lambda i: tl.ops[i][:2])
    merged = []                        # [t0, t1, first op, last op]
    for i in order:
        t0, t1 = tl.ops[i][0], tl.ops[i][1]
        if merged and t0 <= merged[-1][1]:
            if t1 > merged[-1][1]:
                merged[-1][1], merged[-1][3] = t1, i
        else:
            merged.append([t0, t1, i, i])
    gaps = sorted(((merged[j + 1][0] - merged[j][1], j)
                   for j in range(len(merged) - 1)), reverse=True)[:10]
    points, where_of = defaultdict(set), {}
    for dt, j in gaps:
        for op in (merged[j + 1][2], merged[j][3]):
            corr = tl.ops[op][3]
            if corr in tl.launches:
                tid = tl.launches[corr][0]
                points[tid].add(merged[j][1])
                where_of[j] = (tid, merged[j][1])
                break
    where = tl.resolve(points)
    busy = {tid: _open_at(tl.host.get(tid, []), ts)
            for tid, ts in points.items()}
    out = []
    for dt, j in gaps:
        at = where_of.get(j)
        chain, phase = where.get(at, ([], None))
        ops = busy[at[0]][at[1]] if at else ()
        op = ops[-1].name[:80] if ops else None
        out.append([_base(chain[-1]), phase, dt * 1e-6, op] if chain else
                   [OUTSIDE, None, dt * 1e-6, op])
    return out


def summarise(records, tl: _Timeline) -> Dict[str, object]:
    """``by_span``'s result from ``attribute``'s."""
    spans: Dict[str, dict] = {}
    lost = defaultdict(lambda: [0.0, 0])
    total = 0.0
    for name, sec, chain, phase in records:
        total += sec
        if not chain:
            lost[name][0] += sec
            lost[name][1] += 1
            continue
        for n in set(chain):
            acc = spans.setdefault(n, {"forward_s": 0.0, "recompute_s": 0.0,
                                       "backward_s": 0.0, "self_s": 0.0,
                                       "launches": 0})
            acc[phase + "_s"] += sec
            acc["launches"] += 1
        spans[chain[-1]]["self_s"] += sec
    worst = sorted(lost.items(), key=lambda kv: -kv[1][0])[:10]
    return {"total_s": total, "launches": len(records), "spans": spans,
            "unattributed": {"seconds": sum(v[0] for v in lost.values()),
                             "launches": sum(v[1] for v in lost.values()),
                             "top": [[n[:160], v[0]] for n, v in worst]},
            "idle_gaps": _idle_gaps(tl)}


def by_span(path: str) -> Dict[str, object]:
    """Device seconds of the trace at ``path`` by span (see the module's
    docstring), with ``f32_products`` (``matching`` the float32 products)
    and the ``seconds`` the attribution took."""
    t0 = time.time()
    records, tl = attribute(load_events(path))
    got = summarise(records, tl)
    got["f32_products"] = matching(records, *F32)
    got["seconds"] = time.time() - t0
    return got


def matching(records, *needles) -> Dict[str, float]:
    """Device seconds of the operations whose name holds any needle, by
    the spans of their chain, with ``total`` and ``unattributed``."""
    out = defaultdict(float)
    for name, sec, chain, _ in records:
        if any(s in name for s in needles):
            out["total"] += sec
            for n in set(chain) or (UNATTRIBUTED,):
                out[n] += sec
    return dict(out)


def span_ms(ctx, name: str) -> Optional[float]:
    """Device ms a step of span ``name`` (forward, recompute and
    backward), the highest over the ranks; None where no rank's trace
    holds the span."""
    best = None
    for r in ctx["ranks"]:
        tr = r.get("trace") or {}
        got = (tr.get("by_span") or {}).get("spans", {}).get(name)
        if not got or not tr.get("steps"):
            continue
        ms = sum(got[p + "_s"] for p in PHASES) / tr["steps"] * 1e3
        best = ms if best is None else max(best, ms)
    return best


def breakdown(trace: dict) -> Dict[str, object]:
    """The result line's ``device_by_span`` (self device ms a step by
    span, and ``unattributed``) and ``idle_gaps_by_span`` from one rank's
    trace; empty where it holds no ``by_span``."""
    got = trace.get("by_span")
    if not got or not trace.get("steps"):
        return {}
    per = 1e3 / trace["steps"]
    ms = {n: v["self_s"] * per for n, v in got["spans"].items()}
    ms[UNATTRIBUTED] = got["unattributed"]["seconds"] * per
    return {"device_by_span": dict(sorted(ms.items(), key=lambda kv: -kv[1])),
            "idle_gaps_by_span": got["idle_gaps"]}


def summary(rank: dict) -> Optional[Dict[str, object]]:
    """One rank's ``by_span`` condensed, per step: device ms by span and
    phase, the partition's check (the spans' self seconds and the
    unattributed seconds against the total), the unattributed share and
    its top operations, the float32 products' ms by span and their share
    in ``attention`` and ``lm_head``, and the seconds the attribution
    took; None where the rank's trace holds no ``by_span``."""
    tr = rank.get("trace") or {}
    got, steps = tr.get("by_span"), tr.get("steps")
    if not got or not steps:
        return None
    total = got["total_s"]
    parts = sum(v["self_s"] for v in got["spans"].values())
    lost = got["unattributed"]
    f32 = got["f32_products"]
    per = 1e3 / steps
    return {
        "rank": rank["rank"], "steps": steps, "device_s": total,
        "partition_gap": (abs(parts + lost["seconds"] - total) / total
                          if total else None),
        "unattributed_share": lost["seconds"] / total if total else None,
        "unattributed_top": lost["top"],
        "f32_products_ms": {k: v * per for k, v in f32.items()},
        "f32_in_attention_lm_head": ((f32.get("rt/attention", 0.0)
                                      + f32.get("rt/lm_head", 0.0))
                                     / f32["total"] if f32.get("total")
                                     else None),
        "ms_by_span": {n: {k: v[k] * per for k in
                           ("forward_s", "recompute_s", "backward_s",
                            "self_s")} | {"launches": v["launches"]}
                       for n, v in sorted(got["spans"].items())},
        "by_span_s": got["seconds"]}
