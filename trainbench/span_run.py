"""Run one cell traced, as ``trainbench.run --trace 1`` does, with the
device time of the traced steps put down to the spans that launched it.

    python3 -m trainbench.span_run --workload <name> --seed <n> \\
        --seconds <s>

``harness._traced`` reduces the profiler's trace with ``trace.reduce``
and deletes it. Here each rank's process wraps ``trace.reduce`` so that
the same trace is also read by ``span_trace.by_span`` before it is
deleted, and stored under the rank's trace as ``by_span``; a four-card
cell starts its ranks as ``run`` does, with this module in each. The
line printed is ``run``'s ``--trace 1`` line with the span readers
(``metrics/attention_ms.py``, ``lm_head_ms.py``, ``optimizer_ms.py``)
among its metrics, ``device_by_span`` and ``idle_gaps_by_span`` in its
breakdown, and ``spans``: for each rank, device ms a step by span and
phase, the partition's check (the spans' self seconds and the
unattributed seconds against the total), the unattributed share and its
top operations, the float32 products' seconds in the ``attention`` and
``lm_head`` spans, and the seconds the attribution took.
"""

from __future__ import annotations

import time

T_START = time.time()

import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

from trainbench import run, span_trace, trace  # noqa: E402

SPAN_METRICS = [{"name": n, "unit": "ms"} for n in
                ("attention_ms", "lm_head_ms", "optimizer_ms")]
F32 = ("f32f32", "simt_sgemm")


def _wrap_reduce():
    """``trace.reduce`` that also stores ``by_span`` (and this tool's
    extras) for the same trace."""
    plain = trace.reduce

    def reduce(path):
        red = plain(path)
        t0 = time.time()
        records, tl = span_trace.attribute(span_trace.load_events(path))
        red["by_span"] = span_trace.summarise(records, tl)
        red["f32_products"] = span_trace.matching(records, *F32)
        red["by_span_s"] = time.time() - t0
        return red
    trace.reduce = reduce


def _launch(args, chips) -> list:
    """One process a card running this module's rank, as ``run._launch``
    starts ``run``'s."""
    out_dir = tempfile.mkdtemp(prefix="trainbench-span-ranks-")
    port = run._free_port()
    procs = []
    for r in range(chips):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   WORLD_SIZE=str(chips), RANK=str(r), LOCAL_RANK=str(r),
                   NCCL_SHM_DISABLE="1", TRAINBENCH_T0=repr(T_START),
                   OMP_NUM_THREADS="4")
        cmd = [sys.executable, "-m", "trainbench.span_run", "--workload",
               args.workload, "--seed", str(args.seed), "--seconds",
               str(args.seconds), "--as-rank", out_dir]
        procs.append(subprocess.Popen(cmd, cwd=str(run.ROOT), env=env,
                                      stdout=sys.stderr))
    codes = []
    try:
        for p in procs:
            codes.append(p.wait(timeout=600))
    except subprocess.TimeoutExpired:
        codes.append("timeout")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r in range(chips):
        f = Path(out_dir, f"rank{r}.json")
        if f.exists():
            results.append(json.loads(f.read_text()))
            f.unlink()
    os.rmdir(out_dir)
    if any(c != 0 for c in codes) or len(results) != chips:
        raise SystemExit(f"a rank failed: exit codes {codes}")
    return sorted(results, key=lambda r: r["rank"])


def _rank_summary(r) -> dict:
    tr = r["trace"]
    got, steps = tr["by_span"], tr["steps"]
    total = got["total_s"]
    parts = sum(v["self_s"] for v in got["spans"].values())
    lost = got["unattributed"]
    f32 = tr["f32_products"]
    per = 1e3 / steps
    return {
        "rank": r["rank"], "steps": steps, "device_s": total,
        "kernels_s": sum(v["seconds"] for v in tr["kernels"].values()),
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
        "idle_gaps_by_span": got["idle_gaps"],
        "traced_window_s": tr["window_s"],
        "by_span_s": tr["by_span_s"]}


def main(argv=None) -> int:
    args = run._parser().parse_args(argv)
    args.trace = 1
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(run.ROOT / ".cache" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(run.ROOT / ".cache" / "triton"))
    from trainbench import harness
    cell = harness.load_cell(args.workload)
    cell["per_layer"] = cell["per_layer"] + SPAN_METRICS
    chips = cell["workload"]["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"span_run: the cell needs {chips} CUDA card(s)",
              file=sys.stderr)
        return 2
    _wrap_reduce()
    if args.as_rank is not None:
        res = run._one_rank(args, cell, args.as_rank)
        return 1 if res["forbidden"] else 0
    ranks = (_launch(args, chips) if chips > 1
             else [run._one_rank(args, cell)])
    found = sorted(set(run.forbidden_modules()).union(
        *(r["forbidden"] for r in ranks)))
    if found:
        print(f"span_run: loaded {found}", file=sys.stderr)
        return 1
    out = run.assemble(cell, ranks, True)
    out["breakdown"].update(span_trace.breakdown(ranks[0]["trace"]))
    out["spans"] = [_rank_summary(r) for r in ranks]
    for s in out["spans"]:
        print(f"rank {s['rank']}: unattributed share "
              f"{s['unattributed_share']}, partition gap "
              f"{s['partition_gap']}, float32 products in attention + "
              f"lm_head {s['f32_in_attention_lm_head']}, attribution "
              f"{s['by_span_s']:.1f} s", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
