"""The training driver on W ranks against one rank, on the same
arguments: loss streams, ms a step, peak memory a rank and the bytes
each collective moved a step a rank.

    python tools/compare_ranks.py [--nproc 4] [--model 1|2]
                                  [--device cuda|cpu]

Each run is ``torchrun --nproc_per_node W`` (W = ``--nproc``) of this
script's rank mode, then the same arguments in one process; every rank
calls ``repro_torch.launch.train.main`` on granite-3-8b at full width
with 2 layers (``--device cpu``: the smoke variant), so on the card the
ranks meet over ``nccl``, one card a rank, and on the CPU over
``gloo``. Runs: the manual collective at m = 8 materialising and
streaming one machine at a time, and the dedup path with ``--fsdp``
(its one-process counterpart without). Each W-rank loss stream must
match the one-rank stream within rtol 2e-4 / atol 2e-5 (the
reference's float32 reassociation tolerance). ``--model M`` runs the W
ranks on the layout (W/M, M), the model axis executed (default 1: the
data axis alone; 2 is the reference's layout at W = 4), in float32
activations on both sides: in bf16 a row-parallel product's partial
sums are rounded to bf16 before the all-reduce adds them, which moves
the losses past that tolerance (2.2e-4 relative at step 5 of the manual
m = 8 run on four H100s). The last line is a JSON object with every
run's numbers and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 12
BASE = ["--steps", str(STEPS), "--seq-len", "256", "--block-size", "4",
        "--scheme", "expander", "--replication", "2", "--straggler-p",
        "0.2", "--lr", "1e-4", "--log-every", "4", "--seed", "0"]
CPU = ["--seq-len", "32", "--block-size", "2", "--lr", "3e-3"]
RUNS = (("manual m=8", ["--collective", "manual", "--machines", "8"]),
        ("manual m=8 stream chunk 1", ["--collective", "manual",
                                       "--machines", "8",
                                       "--stream-chunk", "1"]),
        ("dedup fsdp", ["--fsdp"]))
RTOL, ATOL = 2e-4, 2e-5


def rank_main(out: str, device: str, model: int, argv) -> None:
    """One rank (or the one process): the driver, then this rank's
    numbers into ``out``.<rank>.json."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    cfg = get_config("granite-3-8b")
    cfg = (cfg.smoke_variant() if device == "cpu"
           else cfg.with_overrides(n_layers=2))
    if model > 1:
        cfg = cfg.with_overrides(dtype="float32")
    s = train.main(argv + ["--device", device], cfg=cfg, model=model)
    rank = int(os.environ.get("RANK", "0"))
    peak = (torch.cuda.max_memory_allocated() if device == "cuda"
            else None)
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump({"summary": s, "peak_bytes": peak}, f)


def _launch(nproc: int, out: str, device: str, argv, model: int = 1
            ) -> list:
    me = [os.path.abspath(__file__), "--rank-mode", out, "--device",
          device, "--model", str(model), "--"] + argv
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
               OMP_NUM_THREADS="1")
    cmd = ([sys.executable, "-m", "torch.distributed.run",
            "--nproc_per_node", str(nproc)] + me if nproc > 1
           else [sys.executable] + me)
    subprocess.run(cmd, cwd=HERE, env=env, check=True, timeout=1800)
    outs = []
    for r in range(nproc):
        with open(f"{out}.{r}.json") as f:
            outs.append(json.load(f))
    return outs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--rank-mode", default=None)
    ap.add_argument("argv", nargs="*")
    args = ap.parse_args()
    if args.rank_mode:
        rank_main(args.rank_mode, args.device, args.model, args.argv)
        return
    import numpy as np
    card = None
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()
    base = BASE + (CPU if args.device == "cpu" else [])
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, extra in RUNS:
            many = _launch(args.nproc, os.path.join(tmp, "many"),
                           args.device, base + extra, args.model)
            # one rank holds whole tensors: FSDP there is the identity
            one = _launch(1, os.path.join(tmp, "one"), args.device,
                          base + [a for a in extra if a != "--fsdp"],
                          args.model)
            s, s1 = many[0]["summary"], one[0]["summary"]
            if s["world_size"] != args.nproc // args.model or \
                    s1["world_size"] != 1:
                raise AssertionError(f"{label}: world sizes "
                                     f"{s['world_size']}, {s1['world_size']}")
            got, want = np.asarray(s["losses"]), np.asarray(s1["losses"])
            if not np.allclose(got, want, rtol=RTOL, atol=ATOL):
                raise AssertionError(f"{label}: {args.nproc} ranks' loss "
                                     f"stream {got} != one rank's {want}")
            for other in many[1:]:
                if other["summary"]["losses"] != s["losses"]:
                    raise AssertionError(f"{label}: ranks disagree")
            rows[label] = {
                "world_size": args.nproc, "layout": s["layout"],
                "ms_per_step": s["loop_s"] / STEPS * 1e3,
                "one_rank_ms_per_step": s1["loop_s"] / STEPS * 1e3,
                "peak_gb_per_rank": [None if o["peak_bytes"] is None
                                     else o["peak_bytes"] / 1e9
                                     for o in many],
                "one_rank_peak_gb": (None if one[0]["peak_bytes"] is None
                                     else one[0]["peak_bytes"] / 1e9),
                "resident_bytes": s["resident_bytes"],
                "one_rank_resident_bytes": s1["resident_bytes"],
                "collective_bytes_per_step":
                    s["collective_bytes_per_step"],
                "loss_rel_gap": float(np.max(np.abs(got - want)
                                             / np.abs(want))),
                "losses": s["losses"], "one_rank_losses": s1["losses"]}
            row = rows[label]
            print(f"{label}: {row['ms_per_step']:.1f} ms a step on "
                  f"{args.nproc} ranks, {row['one_rank_ms_per_step']:.1f} "
                  f"on one; loss gap {row['loss_rel_gap']:.2e}", flush=True)
    print(json.dumps({"card": card, "device": args.device,
                      "nproc": args.nproc, "model": args.model,
                      "rtol": RTOL, "atol": ATOL,
                      "runs": rows}))


if __name__ == "__main__":
    main()
