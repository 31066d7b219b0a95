"""What the model axis moves for Mamba2 and the xLSTM, in one or more
checkouts: each checkout's ``launch.train.main`` and ``launch.serve.main``
on two gloo ranks of layout (1, 2) sharing the card, one checkout after
the other, each in a fresh process that imports that checkout's ``src``.

    python tools/model_axis_bytes.py _tree/parent .

Per checkout and run it prints one line: the model group's bytes a step
(training: zamba2-1.2b at 2 Mamba2 layers and one shared attention
insertion, xlstm-1.3b at 8 layers, published widths, float32
activations, the dedup path, ``--steps`` steps of 4,096 tokens) or a pool
step (serving at full config, bf16, 8 requests on 8 slots), by kind;
ms a step or tokens/s; and each rank's peak bytes. Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TRAIN = (("zamba2-1.2b", {"n_layers": 2, "attn_positions": [1]}),
         ("xlstm-1.3b", {"n_layers": 8}))
TRAIN_ARGS = ["--seq-len", "256", "--block-size", "4", "--machines", "4",
              "--scheme", "expander", "--replication", "2",
              "--straggler-model", "bernoulli", "--straggler-p", "0.2",
              "--lr", "1e-4", "--log-every", "4", "--seed", "0"]
SERVE_ARGS = ["--full-config", "--requests", "8", "--slots", "8",
              "--prompt-len", "24", "--prompt-spread", "8",
              "--max-new-tokens", "8", "--max-len", "64", "--replicas", "8",
              "--seed", "0", "--scheme", "expander", "--straggler-p", "0.2"]


def _rank(rank, tmp, steps):
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.dist import process_group as pg
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, "store"), 2), rank=rank, world_size=2)
    rows = []
    try:
        for arch, over in TRAIN:
            over = {k: tuple(v) if isinstance(v, list) else v
                    for k, v in over.items()}
            cfg = get_config(arch).with_overrides(dtype="float32", **over)
            torch.cuda.reset_peak_memory_stats()
            s = launch_train.main(["--steps", str(steps)] + TRAIN_ARGS,
                                  cfg=cfg, model=2)
            rows.append({"run": f"{arch} train", "ms_per_step":
                         s["loop_s"] / steps * 1e3,
                         "bytes_per_step": {
                             k: v for k, v in
                             s["collective_bytes_per_step"].items() if v},
                         "peak_bytes": torch.cuda.max_memory_allocated()})
            dist.barrier()
        for arch, _ in TRAIN:
            torch.cuda.reset_peak_memory_stats()
            before = dict(pg.traffic)
            t0 = time.perf_counter()
            out = launch_serve.main(["--arch", arch] + SERVE_ARGS, model=2)
            wall = time.perf_counter() - t0
            s = out["summary"]
            n = max(1, s["pool_steps"])
            rows.append({"run": f"{arch} serve", "tokens_per_s":
                         s["tokens_per_s"], "pool_steps": s["pool_steps"],
                         "wall_s": wall, "bytes_per_pool_step": {
                             k: (pg.traffic[k] - before[k]) / n
                             for k in before if pg.traffic[k] != before[k]},
                         "peak_bytes": torch.cuda.max_memory_allocated()})
            del out
            dist.barrier()
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(rows, f)
    finally:
        dist.destroy_process_group()


def _worker(tree, steps):
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(tmp, steps), nprocs=2, join=True)
        outs = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                outs.append(json.load(f))
    for row, other in zip(*outs):
        row["peak_gb"] = [row.pop("peak_bytes") / 1e9,
                          other["peak_bytes"] / 1e9]
        print("model_axis_bytes " + json.dumps({"tree": tree, **row}),
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+", help="checkouts, each with src/")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        _worker(args.trees[0], args.steps)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card {json.dumps(card)}", flush=True)
    rc = 0
    for tree in args.trees:
        env = dict(os.environ, PYTHONPATH=os.path.join(
            os.path.abspath(tree), "src"))
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", "--steps", str(args.steps), tree],
                             env=env, cwd=ROOT).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
