"""Run one cell of ``BENCHMARK.json`` once and print its result.

    python3 -m trainbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Needs as many CUDA cards as the cell asks for; without them it exits with
code 2 and prints no result. A four-card cell starts its four ranks
itself (one process a card, ``torch.distributed`` over ``nccl`` at a free
localhost port, NCCL's shared-memory transport off so that nothing is
written to /dev/shm) and prints one line from their results. With
``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, each read by its reader in
``metrics/<name>.py`` from the ranks' spans, the program counters the
readers declare and the profiler's trace of a few steps after the window
(by kernel and by span); the breakdown gives the top device operations,
the longest idle gaps and the device time by span, and ``spans`` each
rank's attribution condensed (``span_trace.summary``). The numbers the check
compares, each beside its limit, are the result's last key and the last
lines on standard error.

Builds and kernel caches stay inside the checkout: the program's nvcc
libraries in ``src/repro_torch/kernels/_build/``, and
``TORCH_EXTENSIONS_DIR`` and ``TRITON_CACHE_DIR`` under ``.cache/``.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GIB = float(1 << 30)


def forbidden_modules(names=None):
    """Loaded modules (or ``names``) whose top-level name is JAX's or
    the JAX package's, compared whole (``repro_torch`` is not
    ``repro``)."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--as-rank", default=None, help=argparse.SUPPRESS)
    return ap


def _device_info(dev):
    import torch
    kind = torch.cuda.get_device_name(dev)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", str(dev.index or 0)],
            capture_output=True, text=True, timeout=20).stdout.strip()
        limit = float(limit)
    except (OSError, ValueError, subprocess.SubprocessError):
        limit = None
    return kind, limit


def _one_rank(args, cell, out_dir=None):
    """This process's rank of the cell; returns its result dict."""
    import torch
    from . import harness
    P = harness._program()
    dev = P["pg"].device_of_rank(torch.device("cuda"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chips = cell["workload"]["chips"]
    workers = None
    if chips > 1:
        workers = P["pg"].init_workers(
            dev, model=cell["traffic"].get("model_axis", 1))
    t_start = float(os.environ.get("TRAINBENCH_T0", T_START))
    try:
        res = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                          dev, t_start=t_start, workers=workers)
    finally:
        if workers is not None:
            torch.distributed.destroy_process_group()
    res["device"], res["power_limit_w"] = _device_info(dev)
    res["forbidden"] = forbidden_modules()
    if out_dir is not None:
        Path(out_dir, f"rank{res['rank']}.json").write_text(json.dumps(res))
    return res


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(args, chips) -> list:
    """Start one process a card, each running its rank, and wait for all
    of them."""
    out_dir = tempfile.mkdtemp(prefix="trainbench-ranks-")
    port = _free_port()
    procs = []
    for r in range(chips):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   WORLD_SIZE=str(chips), RANK=str(r), LOCAL_RANK=str(r),
                   NCCL_SHM_DISABLE="1", TRAINBENCH_T0=repr(T_START),
                   OMP_NUM_THREADS="4")
        cmd = [sys.executable, "-m", "trainbench.run", "--workload",
               args.workload, "--seed", str(args.seed), "--seconds",
               str(args.seconds), "--trace", str(args.trace), "--as-rank",
               out_dir]
        procs.append(subprocess.Popen(cmd, cwd=str(ROOT), env=env,
                                      stdout=sys.stderr))
    deadline = time.time() + 340
    codes = []
    try:
        for p in procs:
            codes.append(p.wait(timeout=max(1.0, deadline - time.time())))
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


def _reader(name):
    from . import harness
    return harness.metric(name).read


def assemble(cell, ranks, trace: bool) -> dict:
    """The result line from every rank's results (rank 0 first)."""
    lead = ranks[0]
    traffic, model = cell["traffic"], cell["config"]["model"]
    n_blocks = 2 * traffic["machines"] // traffic["replication"]
    tokens_per_step = n_blocks * traffic["block_size"] * traffic["seq_len"]
    steps = lead["window_steps"]
    chk = lead["check"]
    failed = sum(r["failed"] for r in ranks)
    peak = max(r["memory_peak_bytes"] for r in ranks)
    ctx = {"ranks": ranks, "cell": cell, "model": model, "traffic": traffic,
           "tokens_per_step": tokens_per_step, "cards": len(ranks)}
    if trace:
        metrics = {}
        for m in cell["per_layer"]:
            v = _reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {
            "train_tokens_per_s": {
                "value": steps * tokens_per_step / lead["window_s"],
                "unit": "tokens/s"},
            "peak_mem_gib": {"value": peak / GIB, "unit": "GiB"},
            "setup_s": {"value": lead["setup_s"], "unit": "s"}}
    device = {"platform": "gpu", "kind": lead["device"], "count": len(ranks),
              "memory_peak_bytes": int(peak),
              "power_limit_w": lead.get("power_limit_w")}
    out = {"correct": bool(chk["correct"] and failed == 0 and steps > 0),
           "attempted": steps, "failed": failed, "metrics": metrics,
           "device": device}
    if trace:
        device["busy_s"] = statistics.mean(r["trace"]["busy_s"]
                                           for r in ranks)
        device["window_s"] = lead["trace"]["window_s"]
        from . import span_trace, trace as trace_mod
        out["breakdown"] = {
            "device_ops": trace_mod.top_ops(lead["trace"]["kernels"]),
            "idle_gaps": lead["trace"]["idle_gaps"]}
        out["breakdown"].update(span_trace.breakdown(lead["trace"]))
        out["spans"] = [got for got in map(span_trace.summary, ranks)
                        if got is not None]
    out["setup_split"] = lead["setup_split"]
    out["window"] = {"steps": steps, "seconds": lead["window_s"],
                     "check_s": lead.get("check_s")}
    out["check_leaves"] = chk.get("leaves")
    out["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                     for k, v in chk["numbers"].items()}
    return out


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    # fixed kernel caches inside the checkout, so a second run finds them
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / ".cache" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".cache" / "triton"))
    from . import harness
    cell = harness.load_cell(args.workload)
    chips = cell["workload"]["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"trainbench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count() = {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    if args.as_rank is not None:
        res = _one_rank(args, cell, args.as_rank)
        return 1 if res["forbidden"] else 0
    ranks = (_launch(args, chips) if chips > 1 else [_one_rank(args, cell)])
    found = sorted(set(forbidden_modules()).union(
        *(r["forbidden"] for r in ranks)))
    if found:
        print(f"trainbench: loaded {found}: the benchmark may not load JAX "
              "or the JAX package", file=sys.stderr)
        return 1
    out = assemble(cell, ranks, bool(args.trace))
    print(json.dumps(out.get("setup_split")), file=sys.stderr)
    for got in out.get("spans", ()):
        print(f"rank {got['rank']}: unattributed share "
              f"{got['unattributed_share']}, partition gap "
              f"{got['partition_gap']}, float32 products in attention + "
              f"lm_head {got['f32_in_attention_lm_head']}, attribution "
              f"{got['by_span_s']:.1f} s", file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
