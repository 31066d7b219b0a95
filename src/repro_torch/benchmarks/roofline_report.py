"""The roofline table from the dry-run's JSON, and the comm-bytes report
over the train bench.

Port of ``benchmarks/roofline_report.py``: per (arch x shape x layout)
the card's three roofline terms (``launch.dryrun --out DIR`` writes one
JSON a cell), the dominant one, MODEL_FLOPS over the counted FLOPs, and
a note on what would move it down on the card. ``comm_report`` audits
``BENCH_torch_train.json``: each run's comm bytes a step against
float32 at the same rows, uncompressed exactly 1.0x, int8 and sign at
most 0.3x, sign_packed at most 0.05x.
"""

from __future__ import annotations

import glob
import json
import os
from typing import List

NOTES = {
    "collective": ("shrink what the combine ships: a compressed codec, "
                   "fewer per-microbatch reductions"),
    "memory": ("raise arithmetic intensity: bf16 operands, fused "
               "attention instead of materialised scores, larger tiles "
               "in shared memory"),
    "compute": ("cut redundant FLOPs: causal block skipping, smaller "
                "replication d"),
}


def load(dirpath: str) -> List[dict]:
    rows = []
    for fn in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        with open(fn) as f:
            rows.append(json.load(f))
    return rows


def table(rows: List[dict]) -> str:
    out = ["| arch | shape | layout | Tc(ms) | Tm(ms) | Tx(ms) | "
           "bottleneck | useful | args GB/device | note |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        layout = "2x16x16" if r.get("multi_pod") else "16x16"
        if r.get("fsdp"):
            layout += " fsdp"
        if r.get("status") == "skipped":
            out.append(f"| {r['arch']} | {r['shape']} | {layout} | - | - "
                       f"| - | skipped | - | - | {r['reason']} |")
            continue
        if r.get("status") != "ok" or "roofline" not in r:
            out.append(f"| {r['arch']} | {r['shape']} | {layout} | - | - "
                       f"| - | {r.get('status', 'ERROR')} | - | - "
                       f"| {r.get('error', '')[:60]} |")
            continue
        rl = r["roofline"]
        dom = rl["dominant"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {layout} "
            f"| {rl['t_compute_s'] * 1e3:.2f} "
            f"| {rl['t_memory_s'] * 1e3:.2f} "
            f"| {rl['t_collective_s'] * 1e3:.2f} "
            f"| {dom} | {rl['useful_flops_ratio']:.2f} "
            f"| {r['memory']['argument_bytes'] / 1e9:.2f} "
            f"| {NOTES[dom]} |")
    return "\n".join(out)


# Per-codec wire-ratio ceilings against float32 at the same rows; None
# means exactly 1.0 (uncompressed runs ship the full gradients).
EXPECTED_COMM_RATIO = {"none": None, "int8": 0.3, "sign": 0.3,
                       "sign_packed": 0.05}
# Codecs every train report must carry a run for.
REQUIRED_CODECS = ("int8", "sign_packed")


def comm_report(train_report: dict) -> List[dict]:
    """The comm-bytes table and its acceptance over a train report."""
    runs = [r for r in train_report.get("runs", [])
            if "comm_bytes_per_step" in r]
    if not runs:
        raise AssertionError("train report carries no comm-bytes column")
    out = []
    print("| scheme | path | m | stream chunk | compress | comm MB/step "
          "| f32 MB/step | ratio |")
    print("|---|---|---|---|---|---|---|---|")
    for r in runs:
        ratio = r["comm_bytes_per_step"] / r["comm_bytes_per_step_float32"]
        codec = r.get("compress", "none")
        out.append({"scheme": r["scheme"], "path": r["path"],
                    "m_workers": r.get("m_workers"),
                    "stream_chunk": r.get("stream_chunk"),
                    "compress": codec,
                    "comm_bytes_per_step": r["comm_bytes_per_step"],
                    "comm_bytes_per_step_float32":
                        r["comm_bytes_per_step_float32"],
                    "ratio": ratio})
        print(f"| {r['scheme']} | {r['path']} | {r.get('m_workers')} "
              f"| {r.get('stream_chunk')} | {codec} "
              f"| {r['comm_bytes_per_step'] / 1e6:.2f} "
              f"| {r['comm_bytes_per_step_float32'] / 1e6:.2f} "
              f"| {ratio:.3f} |")
        if codec not in EXPECTED_COMM_RATIO:
            raise AssertionError(f"no expected comm ratio registered for "
                                 f"codec {codec!r}")
        ceiling = EXPECTED_COMM_RATIO[codec]
        if ceiling is None and ratio != 1.0:
            raise AssertionError("uncompressed runs must ship 1.0x")
        if ceiling is not None and ratio > ceiling:
            raise AssertionError(f"{codec} comm ratio {ratio:.3f} must be "
                                 f"<= {ceiling}x float32 ({r['scheme']}/"
                                 f"{r['path']})")
    for codec in REQUIRED_CODECS:
        if not any(r["compress"] == codec for r in out):
            raise AssertionError(f"train report must carry a {codec} "
                                 "compression run")
    print(f"# comm_report: {len(out)} rows, acceptance ok")
    return out


def main(dirpath: str) -> List[dict]:
    rows = load(dirpath)
    if not rows:
        print(f"# no dry-run artifacts in {dirpath} (run "
              "python -m repro_torch.launch.dryrun --out DIR)")
        return []
    print(table(rows))
    n_ok = sum(r.get("status") == "ok" for r in rows)
    print(f"# roofline_report: {n_ok} ok / {len(rows)} rows")
    return rows
