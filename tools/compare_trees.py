"""Time the rmsnorm (K1), decode-attention (K2), combine (K3-K5),
fused-error (K6) and Gram-matvec (K7) rows of ``chip_smoke.py`` in
several checkouts on one card, every checkout with this checkout's
measuring code:

    python tools/compare_trees.py [--step-profile] [--only GROUPS]
        CHECKOUT [CHECKOUT ...]

The runs go in turns, forward and then backward (a, b, b, a for two
checkouts), one process a run. Each run imports its checkout's
``src/repro_torch`` and builds that checkout's kernels, but measures with
this checkout's ``chip_smoke.py`` and ``src/repro_torch/launch/timing.py``
(loaded in place of the checkout's own), so that every checkout is timed
the same way. Shapes: rmsnorm at the decode step's (8, 1, 4096) in
bf16 and f32 and at the training table's (8192, 4096) bf16;
decode_attention at the serving shape, at the serving position (every
length 144) and at a 32k cache; the combines at the stacked ``wi_gate``
leaf (D = 104,857,600): coded_combine (f32) at 1, 2 and 4 rows,
quantized_combine (int8) at 1-4, packed_sign_combine at 1, 2 and 4, and
these two at 1 and 4 rows of D = 8192 (the stacked norm scales) and of
2^18, 2^20 and 2^22-2^26 (where the planner's routes cross);
fused_error and the Gram matvecs at the harness shapes. ``--only`` takes
a comma list of the groups rmsnorm, decode_attention, combine, harness
(default: all). With ``--step-profile`` each run also takes the serving
step profile (``step_profile --full-config``). The last line is a JSON
object: per shape and run, the kernel's device ms, the wrapper's ms per
call, the library call's ms and the launch plan where the checkout has
a planner. Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUPS = ("rmsnorm", "decode_attention", "combine", "harness")

_RUN = r"""
import importlib.util, os, sys
here, root, profile = sys.argv[1], os.path.abspath(sys.argv[2]), sys.argv[3]
only = sys.argv[4].split(",")
sys.path[:0] = [os.path.join(root, "src"), here]
SMALL_D = (8192, 1 << 18, 1 << 20, 1 << 22, 1 << 23, 1 << 24, 1 << 25,
           1 << 26)
import repro_torch.launch
spec = importlib.util.spec_from_file_location(
    "repro_torch.launch.timing",
    os.path.join(here, "src", "repro_torch", "launch", "timing.py"))
timing = importlib.util.module_from_spec(spec)
spec.loader.exec_module(timing)
sys.modules["repro_torch.launch.timing"] = timing
repro_torch.launch.timing = timing
import numpy as np, torch
import chip_smoke as cs
from repro_torch.kernels import build
sources = {"rmsnorm": ["rmsnorm"], "decode_attention": ["decode_attention"],
           "combine": ["coded_combine"],
           "harness": ["batched_alpha", "spectral_matvec"]}
build.build([src for group in only for src in sources[group]])
dev = torch.device("cuda")
if "rmsnorm" in only:
    for shape, dtype, label in (
            ((8, 1, 4096), "bfloat16", "path (8,1,4096)"),
            ((8, 1, 4096), "float32", "(8,1,4096) f32"),
            ((8192, 4096), "bfloat16", "(8192,4096)")):
        cs.check_rmsnorm(torch, dev, shape, dtype, label)
if "combine" in only:
    D = cs.PATH_D[0]
    for kind, dtype, rows in (("coded_combine", "float32", (1, 2, 4)),
                              ("quantized_combine", "int8", (1, 2, 3, 4)),
                              ("packed_sign_combine", "uint8", (1, 2, 4))):
        for n in rows:
            cs.check_combine(torch, dev, kind, D, dtype, exact=False, n=n)
    # the int8 and packed combines below the wi_gate leaf: the stacked
    # norm scales (D = 8192) and the sizes between
    for kind, dtype in (("quantized_combine", "int8"),
                        ("packed_sign_combine", "uint8")):
        for d in SMALL_D:
            for n in (1, 4):
                cs.check_combine(torch, dev, kind, d, dtype, exact=False,
                                 n=n)
if "decode_attention" in only:
    lens = np.random.default_rng(0).integers(1, 1025, 8).tolist()
    for S, n, label in ((1024, lens, "path"),
                        (1024, [144] * 8, "position 144"),
                        (32768, [32768] * 8, "32k")):
        cs.check_decode_attention(torch, dev, 8, 32, 8, S, 128, "bfloat16",
                                  n, label)
if "harness" in only:
    for T in (30, 1000):
        cs.check_fused_error(torch, dev, T, 2184, time_it=True)
    for R, k in ((2184, 30), (2184, 1000)):
        for bv in (0, 8):
            cs.check_gram_matvec(torch, dev, R, k, bv, time_it=True)
    for B, R, k in ((12, 2184, 30), (12, 2184, 1000)):
        cs.check_gram_matvec_batch(torch, dev, B, R, k, time_it=True)
if profile == "1":
    cs.step_profile()
"""


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="+")
    ap.add_argument("--step-profile", action="store_true")
    ap.add_argument("--only", default=",".join(GROUPS),
                    help="comma list of " + ", ".join(GROUPS))
    args = ap.parse_args(argv)
    if not set(args.only.split(",")) <= set(GROUPS):
        ap.error(f"--only takes a comma list of {', '.join(GROUPS)}")
    order = [(root, f"{i}a") for i, root in enumerate(args.checkouts)]
    order += [(root, f"{i}b") for root, i in
              reversed([(r, i) for i, r in enumerate(args.checkouts)])]
    table = {}
    for root, label in order:
        run = subprocess.run(
            [sys.executable, "-c", _RUN, HERE, root,
             "1" if args.step_profile else "0", args.only],
            capture_output=True, text=True, timeout=900)
        if run.returncode:
            sys.stderr.write(run.stderr[-8000:])
            raise SystemExit(f"run {label} of {root} failed "
                             f"({run.returncode})")
        for line in run.stdout.splitlines():
            tag, _, body = line.partition(" ")
            if tag == "kernel":
                row = json.loads(body)
                table.setdefault(row["shape"], {})[label] = {
                    key: row.get(key) for key in
                    ("kernel_ms", "kernel_call_ms", "library_ms",
                     "copy_ms", "lane_ms", "bulk_ms", "bound_ms",
                     "plan")}
            elif tag == "step_profile":
                table.setdefault("step_profile", {})[label] = json.loads(body)
        print(f"run {label} {root} done", flush=True)
    result = {"checkouts": args.checkouts, "rows": table}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
