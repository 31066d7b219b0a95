"""The port's benchmark suite: one report per user-facing metric.

    python -m repro_torch.benchmarks.run [--fast|--full] \\
        [--only kernels,serve,train_step,decoding,roofline] \\
        [--device cpu] [--out DIR] [--dryrun-dir DIR]

Port of ``benchmarks/run.py``'s perf reports (the paper-figure sections
are ``launch.harness``). Runs on the card unless ``--device cpu``; with
no card and no ``--device cpu`` it raises. Writes, into ``--out``
(default: the current directory):

* ``BENCH_torch_kernels.json``: every hand kernel at its path shapes
  against its plain version, a library call and its bound
  (``kernel_bench``);
* ``BENCH_torch_serve.json``: engine tokens/s and TTFT, the p=0
  stream pins, simulated TTFT p50/p99 (``serve_bench``);
* ``BENCH_torch_train.json``: ms per coded step, tokens/s, host decode,
  comm bytes and peak memory per path, and the chaos row
  (``train_step``), audited by ``roofline_report.comm_report``;
* ``BENCH_torch_decoding.json``: decoded trials per second at m = 6552,
  with the K6 and batched-alpha engine rows (``decoding.speed_report``);
* ``BENCH_torch_sweep.json``: the regime-2 grid and campaign seconds,
  spectral timings, the zoo and the adaptive-regret row
  (``decoding.sweep_report``).

Every report carries ``device``: the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit`` gives them, or ``"cpu"``.
The ``roofline`` section prints the table of the dry-run JSON in
``--dryrun-dir`` (``python -m repro_torch.launch.dryrun --out DIR``).
Every section asserts its acceptance inline.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Optional

import torch

from repro_torch import device as _device

SECTIONS = ("kernels", "serve", "train_step", "decoding", "roofline")


def device_info(dev: torch.device):
    """{"name", "power_limit"} of the card (``nvidia-smi``), or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, check=True,
            timeout=60).stdout.strip().splitlines()[0]
        name, limit = (s.strip() for s in line.rsplit(",", 1))
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        name, limit = torch.cuda.get_device_name(dev), "not measured"
    return {"name": name, "power_limit": limit}


def _write(out_dir: str, name: str, report: dict) -> str:
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    return path


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--fast", action="store_true",
                    help="fast mode (the default unless --full)")
    ap.add_argument("--only", default=None,
                    help="comma list of " + ",".join(SECTIONS))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=".",
                    help="directory the BENCH_torch_*.json files go to")
    ap.add_argument("--dryrun-dir", default=os.path.join("experiments",
                                                         "dryrun_torch"),
                    help="dry-run JSON the roofline section reads")
    args = ap.parse_args(argv)
    if args.full and args.fast:
        ap.error("--fast and --full are mutually exclusive")
    wanted = args.only.split(",") if args.only else list(SECTIONS)
    unknown = set(wanted) - set(SECTIONS)
    if unknown:
        ap.error(f"unknown sections {sorted(unknown)}")
    fast = not args.full
    dev = _device.resolve(args.device)
    info = device_info(dev)
    mode = "fast" if fast else "full"
    os.makedirs(args.out, exist_ok=True)

    from . import (decoding, kernel_bench, roofline_report, serve_bench,
                   train_step)
    t0 = time.time()
    written, results = {}, {}
    t_section = [t0]

    def stamp(report: dict) -> dict:
        """The report with its device, mode and the section's seconds."""
        now = time.time()
        seconds, t_section[0] = now - t_section[0], now
        return {"device": info, "mode": mode, "seconds": seconds, **report}

    if "kernels" in wanted:
        print("\n=== kernels ===", flush=True)
        results["kernels"] = kernel_bench.main(dev)
        written["kernels"] = _write(args.out, "BENCH_torch_kernels.json",
                                    stamp(results["kernels"]))
    if "serve" in wanted:
        print("\n=== serve ===", flush=True)
        results["serve"] = serve_bench.main(dev, fast=fast)
        written["serve"] = _write(args.out, "BENCH_torch_serve.json",
                                  stamp(results["serve"]))
        eng, acc = results["serve"]["engine"]["coded"], \
            results["serve"]["acceptance"]
        print(f"wrote {written['serve']}: coded engine "
              f"{eng['tokens_per_s']:.1f} tok/s, sim p99 coded "
              f"{acc['coded_p99_ms']:.2f} ms vs uncoded "
              f"{acc['uncoded_p99_ms']:.2f} ms")
    if "train_step" in wanted:
        print("\n=== train_step ===", flush=True)
        report = train_step.main(dev, fast=fast)
        report["comm"] = roofline_report.comm_report(report)
        results["train_step"] = report
        written["train_step"] = _write(args.out, "BENCH_torch_train.json",
                                       stamp(report))
        runs = report["runs"]
        dedup = train_step.find_run(runs, path="dedup", compress="none")
        repl = train_step.find_run(runs, scheme="expander",
                                   path="replicated", collective="gspmd")
        print(f"wrote {written['train_step']}: coded dedup "
              f"{dedup['step_ms']:.1f} ms/step vs replicated "
              f"{repl['step_ms']:.1f} ms/step")
    if "decoding" in wanted:
        print("\n=== decoding ===", flush=True)
        speed = decoding.speed_report(dev, fast=fast)
        rows = [r for r in (results.get("kernels") or {}).get("rows", [])
                if r["entry"] in ("K6", "engine")]
        speed["kernels"] = rows or kernel_bench.run_specs(
            [s for s in kernel_bench.REGISTRY
             if s.entry in ("K6", "engine")], dev)
        results["decoding"] = speed
        written["decoding"] = _write(args.out, "BENCH_torch_decoding.json",
                                     stamp(speed))
        print(f"wrote {written['decoding']}: scalar "
              f"{speed['scalar']['trials_per_sec']:.1f} trials/s, batched "
              f"{speed['batched']['trials_per_sec']:.1f} trials/s")
        sweep = decoding.sweep_report(dev)
        results["sweep"] = sweep
        written["sweep"] = _write(args.out, "BENCH_torch_sweep.json",
                                  stamp(sweep))
        grid, camp = sweep["regime2_grid"], sweep["campaign"]
        print(f"wrote {written['sweep']}: regime-2 grid "
              f"{grid['per_point_seconds']:.2f}s per-point vs "
              f"{grid['sweep_seconds']:.3f}s sweep; campaign "
              f"{camp['campaign_seconds']:.3f}s vs sequential "
              f"{camp['sequential_seconds']:.3f}s")
    if "roofline" in wanted:
        print("\n=== roofline ===", flush=True)
        results["roofline"] = roofline_report.main(args.dryrun_dir)
    print(f"\nall benchmarks done in {time.time() - t0:.1f}s on {info}")
    return {"device": info, "written": written, "results": results}


if __name__ == "__main__":
    main()
    sys.stdout.flush()
