"""Dry-run: per-device memory and the roofline of every (architecture x
input shape) on a production layout, from metadata alone.

Port of ``repro.launch.dryrun``. The reference lowers and compiles each
step for 512 placeholder devices and reads XLA's memory and cost
analyses. Here nothing is compiled or allocated:

* ``memory``: the bytes each device holds of the step's arguments
  (parameters, AdamW's moments, the batch, the decode cache) and of its
  outputs, under the layout's placements (``dist.sharding``), and
  ``param_bytes_per_device``; ``fits_device`` holds the argument bytes
  against the card's 80 GB -- what the reference reads
  ``memory_analysis`` for. Temporaries are not counted (no compiler
  plans them here).
* ``roofline``: the card's three terms (``launch.roofline``) from
  ``launch.step_analysis`` of the port's step run on meta tensors, its
  counts divided evenly over the layout's devices (a train step's
  16 identical microbatches counted as one, times 16).

The step analysed for ``train`` is the port's dedup coded step at 16
microbatches (the reference's ``REPRO_MICROBATCHES`` default), AdamW:
each unique block once, weighted by v = A @ w. The reference's dry-run
compiles its replicated step (every block d times); both rematerialise
each layer, and the port's flash-attention backward adds one Q K^T a
tile (``launch.step_analysis``), so its FLOPs are a different step's
and not a copy of the reference's. ``prefill`` and ``decode`` are the
port's ``make_prefill_step`` and ``make_serve_step``. The collective term is
the coded combine's payload, one gradient row per device.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all --multi-pod both --specs-only
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch

from repro_torch import tree as T
from repro_torch.configs import (ALL_SHAPES, ARCH_IDS, CodingConfig,
                                 get_config)
from repro_torch.dist import coded_train
from repro_torch.dist import sharding as rules
from repro_torch.launch import roofline as rl_mod
from repro_torch.launch import specs as specs_mod
from repro_torch.launch import step_analysis
from repro_torch.launch.mesh import make_production_layout
from repro_torch.optim import optimizers as opt_mod

MICROBATCHES = 16


def param_bytes_per_device(spec, layout) -> int:
    """Per-device parameter bytes of a StepSpec's placement."""
    return rules.bytes_per_device(spec.args[0], spec.placements[0], layout)


def argument_bytes(spec, layout) -> int:
    """Per-device bytes of all the step's arguments."""
    return sum(rules.bytes_per_device(a, p, layout)
               for a, p in zip(spec.args, spec.placements))


def _local(tree, specs, layout):
    """Meta tensors of each leaf's per-device shard shape."""
    def shard(leaf, spec):
        shape = list(leaf.shape)
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                shape[dim] = -(-shape[dim] // int(layout.shape[a]))
        return specs_mod.meta(shape, leaf.dtype)
    return T.map(shard, tree, specs)


def build_step(cfg, shape, layout, coding, fsdp=False,
               microbatches=MICROBATCHES):
    """(fn, args, spec, trips): the port's step for ``shape.kind``, the
    meta arguments ``step_analysis.analyze`` runs it on, and how many
    times its counts repeat in the real step.

    A train step of k microbatches runs k identical microbatches, and
    its update does no matmul, so its counts are k times those of a
    one-microbatch step on one microbatch's blocks (``trips`` = k): the
    reference's trip-count correction, made here by the caller.
    ``tests/test_torch_step_analysis.py`` pins the identity."""
    spec = specs_mod.make_step_spec(cfg, shape, layout, coding, fsdp=fsdp)
    if spec.kind == "train":
        optimizer = opt_mod.get_optimizer("adamw", 1e-4)
        fn = coded_train.make_train_step(cfg, optimizer, dedup=True)
        _m, n, bs = specs_mod._coded_geometry(layout, coding,
                                              shape.global_batch)
        if bs % microbatches:
            raise ValueError(f"block batch {bs} not divisible by "
                             f"{microbatches} microbatches")
        blocks = {k: specs_mod.meta((n, bs // microbatches)
                                    + tuple(v.shape[3:]), v.dtype)
                  for k, v in spec.args[2].items() if k != "block_weight"}
        args = (spec.args[0], spec.args[1], blocks,
                specs_mod.meta((n,), torch.float32))
        return fn, args, spec, microbatches
    if spec.kind == "prefill":
        return coded_train.make_prefill_step(cfg), spec.args, spec, 1
    return (coded_train.make_serve_step(cfg, window=spec.window),
            spec.args, spec, 1)


def specs_one(arch: str, shape_name: str, *, multi_pod: bool,
              fsdp: bool, verbose: bool = True) -> dict:
    """Spec-only dry-run: build the StepSpec and report the per-device
    parameter bytes; prints the reference's ``DRYRUN_SPECS_JSON:``
    line. A shape the arch does not run is ``skipped``, as in
    ``dryrun_one``."""
    cfg = get_config(arch)
    shape = {s.name: s for s in ALL_SHAPES}[shape_name]
    layout = make_production_layout(multi_pod=multi_pod)
    coding = CodingConfig(replication=4)
    if shape.name == "long_500k":
        ok, why = specs_mod.long_500k_supported(cfg)
        if not ok:
            return {"arch": arch, "shape": shape_name,
                    "multi_pod": multi_pod, "fsdp": fsdp,
                    "status": "skipped", "reason": why}
    spec = specs_mod.make_step_spec(cfg, shape, layout, coding, fsdp=fsdp)
    result = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "fsdp": fsdp, "status": "ok", "kind": spec.kind,
        "param_bytes_per_device": param_bytes_per_device(spec, layout),
    }
    if verbose:
        print("DRYRUN_SPECS_JSON:" + json.dumps(result))
        sys.stdout.flush()
    return result


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool,
               fsdp: bool = False, verbose: bool = True) -> dict:
    cfg = get_config(arch)
    shape = {s.name: s for s in ALL_SHAPES}[shape_name]
    if shape.name == "long_500k":
        ok, why = specs_mod.long_500k_supported(cfg)
        if not ok:
            return {"arch": arch, "shape": shape_name,
                    "multi_pod": multi_pod, "fsdp": fsdp,
                    "status": "skipped", "reason": why}
    layout = make_production_layout(multi_pod=multi_pod)
    coding = CodingConfig(replication=4)
    fn, args, spec, trips = build_step(cfg, shape, layout, coding,
                                       fsdp=fsdp)
    params = spec.args[0]
    comm = None
    if spec.kind == "train":
        local = _local(params, spec.placements[0], layout)
        comm = step_analysis.comm(None, 1, local)
    t0 = time.time()
    with torch.no_grad():
        stats = step_analysis.analyze(fn, *args, comm=comm)
    t_analyze = time.time() - t0
    n_chips = layout.size
    per_chip = dict(stats, flops=stats["flops"] * trips / n_chips,
                    dot_bytes=stats["dot_bytes"] * trips / n_chips)
    model = rl_mod.model_flops(cfg, shape, replication=coding.replication)
    rl = rl_mod.roofline_report(per_chip, n_chips, model, dtype=cfg.dtype)
    arg_bytes = argument_bytes(spec, layout)
    if spec.kind == "train":   # updated params and AdamW state
        out_bytes = sum(rules.bytes_per_device(a, p, layout)
                        for a, p in zip(spec.args[:2], spec.placements[:2]))
    elif spec.kind == "prefill":  # last-position logits, batch-split
        B = shape.global_batch
        logits = specs_mod.meta((B, cfg.padded_vocab()), torch.float32)
        out_bytes = rules.bytes_per_device(
            logits, rules.leading_axis_specs(logits, layout), layout)
    else:                      # logits and the cache
        logits = specs_mod.meta((shape.global_batch, cfg.padded_vocab()),
                                torch.float32)
        out_bytes = (rules.bytes_per_device(logits, spec.placements[1][:1]
                                            + (None,), layout)
                     + rules.bytes_per_device(spec.args[2],
                                              spec.placements[2], layout))
    result = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "fsdp": fsdp, "status": "ok", "kind": spec.kind,
        "n_chips": int(n_chips), "analyze_s": round(t_analyze, 2),
        "memory": {
            "argument_bytes": int(arg_bytes),
            "output_bytes": int(out_bytes),
            "param_bytes_per_device": param_bytes_per_device(spec, layout),
        },
        "fits_device": bool(arg_bytes <= rl_mod.HBM_BYTES),
        "device_bytes": rl_mod.HBM_BYTES,
        "model": model,
        "roofline": rl,
        "step": {"train": f"dedup, {MICROBATCHES} microbatches, adamw",
                 "prefill": "make_prefill_step",
                 "decode": "make_serve_step"}[spec.kind],
    }
    if verbose:
        gb = 1e9
        print(f"[{arch} x {shape_name} x "
              f"{'2x16x16' if multi_pod else '16x16'}"
              f"{' fsdp' if fsdp else ''}] analyze {t_analyze:.1f}s | "
              f"args {arg_bytes / gb:.2f} GB/device "
              f"({'fits' if result['fits_device'] else 'does not fit'} "
              f"80 GB) | Tc {rl['t_compute_s'] * 1e3:.2f}ms Tm "
              f"{rl['t_memory_s'] * 1e3:.2f}ms Tx "
              f"{rl['t_collective_s'] * 1e3:.2f}ms -> {rl['dominant']} | "
              f"useful {rl['useful_flops_ratio']:.2f}")
        sys.stdout.flush()
    return result


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS)
    ap.add_argument("--shape", default=None,
                    choices=[s.name for s in ALL_SHAPES])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--fsdp", action="store_true",
                    help="place params and AdamW state by "
                         "rules.fsdp_specs instead of replicating them "
                         "over the workers")
    ap.add_argument("--specs-only", action="store_true",
                    help="build StepSpecs and report per-device param "
                         "bytes without analysing the step")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.all or args.arch is None else (args.arch,)
    shapes = [s.name for s in ALL_SHAPES] if args.all or \
        args.shape is None else [args.shape]
    pods = {"single": (False,), "multi": (True,),
            "both": (False, True)}[args.multi_pod]

    results = []
    for arch in archs:
        for shape in shapes:
            for mp in pods:
                try:
                    one = specs_one if args.specs_only else dryrun_one
                    results.append(one(arch, shape, multi_pod=mp,
                                       fsdp=args.fsdp))
                except Exception as e:  # noqa: BLE001 -- report, go on
                    traceback.print_exc()
                    results.append({"arch": arch, "shape": shape,
                                    "multi_pod": mp, "status": "error",
                                    "error": str(e)[:2000]})
                if args.out:
                    os.makedirs(args.out, exist_ok=True)
                    tag = "multi" if mp else "single"
                    fn = os.path.join(args.out, f"{arch}__{shape}__{tag}"
                                      f"{'__fsdp' if args.fsdp else ''}"
                                      ".json")
                    with open(fn, "w") as f:
                        json.dump(results[-1], f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"dry-run: {n_ok} ok, {n_skip} skipped, {n_err} errors "
          f"of {len(results)}")
    if n_err:
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
