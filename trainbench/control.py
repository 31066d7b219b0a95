"""Readings that set a cell's limits: the program's over many seeds, and
the control's and the planted faults' on the same inputs.

    python3 -m trainbench.control --workload <name> --seeds 1,2,3 \\
        [--modes fp8,half_batch,alpha,rank_only,no_decay] [--program 0|1]

In one process, for each seed: with ``--program 1`` one run of the cell
through ``harness.run`` with a one-step window (its check's numbers are
the program's readings); then, for each mode, the plain reference put in
the program's place and computed with that fault, against the float32
reference, on the inputs the seed makes and straggler masks drawn from
it. Modes:

- ``fp8``: the control. Every activation the program holds in
  bfloat16 (the residual stream after the embedding and after each
  block) and both operands of every linear rounded to fp8 (e4m3, one
  scale a tensor), and the gradients that flow back through them to fp8
  (e5m2): the precision below the configuration's bfloat16.
- ``half_batch``: the second half of the blocks left out, the loss
  normalised over the rest.
- ``alpha``: one block's weight doubled where the decoder produces it
  (an answer altered).
- ``rank_only``: only the first rank's machines' blocks, the exchange
  between ranks left out (a cell on several cards).
- ``no_decay``: AdamW's decoupled weight decay left out.

A step that returns its state unchanged reads 1 on ``change_gap`` by
construction and needs no run. Prints one JSON line a reading and a
summary line last.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import numpy as np
import torch

from . import harness, inputs
from .reference import coding as ref_coding
from .reference import train as ref_train


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def _round(x, dtype, top):
    s = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / s).to(dtype).to(x.dtype) * s


def fp8(x):
    return _Fp8.apply(x)


def masks_for(traffic: dict, seed: int, steps: int) -> list:
    rng = np.random.default_rng((int(seed) % (1 << 64), 17))
    return [rng.random(traffic["machines"]) >= traffic["straggler_p"]
            for _ in range(steps)]


def reference_as_program(cell, seed, dev, mode, masks, cards=1):
    """Records of the reference run with ``mode``, in the form the check
    reads from the program."""
    cfgj, traffic = cell["config"], cell["traffic"]
    model = cfgj["model"]
    k = traffic["checked_steps"]
    n = ref_coding.assignment(traffic["scheme"], traffic["machines"],
                              traffic["replication"]).shape[0]
    tokens = inputs.tokens_for(cfgj, traffic, seed)
    batches = [tokens.batch(n * traffic["block_size"], s) for s in range(k)]
    params0 = inputs.make_params(model, seed, dev)
    if mode == "no_decay":
        traffic = dict(traffic, optimizer=dict(traffic["optimizer"],
                                               weight_decay=0.0))
    out = ref_train.run(
        model, traffic, seed, params0, batches, masks,
        q8=fp8 if mode == "fp8" else ref_train.ref_model._ident,
        fault=mode if mode in ref_train.FAULTS else None, ranks=cards)
    change = harness.ref_change(model, seed, dev, out["params"])
    rec = {"loss": out["losses"], "alpha": out["alphas"], "alive": masks,
           "first_grad": out["first_grad"], "change": change}
    del out, params0
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def readings(cell, seed, dev, modes, cards=1) -> list:
    k = cell["traffic"]["checked_steps"]
    masks = masks_for(cell["traffic"], seed, k)
    ref = reference_as_program(cell, seed, dev, None, masks, cards)
    ref_run = {"losses": ref["loss"], "alphas": ref["alpha"],
               "first_grad": ref["first_grad"]}
    out = []
    for mode in modes:
        t0 = time.time()
        got = reference_as_program(cell, seed, dev, mode, masks, cards)
        checked = {"loss": got["loss"], "alpha": got["alpha"],
                   "alive": masks}
        numbers = harness.compare_records(cell, checked, got["first_grad"],
                                          got["change"], ref_run,
                                          ref["change"])
        out.append({"seed": seed, "mode": mode, "seconds": time.time() - t0,
                    "numbers": numbers["numbers"],
                    "every": numbers["every"],
                    "leaves": numbers["leaves"],
                    "norms": numbers["norms"],
                    "losses": numbers["losses"]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="fp8,half_batch,alpha")
    ap.add_argument("--program", type=int, default=1)
    ap.add_argument("--control-seeds", default=None,
                    help="seeds of the modes' runs (default: --seeds)")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seeds = [int(s) for s in args.seeds.split(",") if s]
    modes = [m for m in args.modes.split(",") if m]
    summary = {}
    if args.program:
        for seed in seeds:
            t0 = time.time()
            res = harness.run(cell, seed, 0.0, False, dev, t_start=t0)
            nums = res["check"]["numbers"]
            print(json.dumps({"seed": seed, "mode": "program",
                              "seconds": time.time() - t0,
                              "numbers": nums,
                              "every": res["check"]["every"],
                              "leaves": res["check"]["leaves"],
                              "norms": res["check"]["norms"],
                              "losses": res["check"]["losses"]}), flush=True)
            for k, v in res["check"]["every"].items():
                summary.setdefault("program", {}).setdefault(k, []).append(v)
            del res
            gc.collect()
            torch.cuda.empty_cache()
    cseeds = ([int(s) for s in args.control_seeds.split(",")]
              if args.control_seeds else seeds)
    if modes:
        for seed in cseeds:
            for r in readings(cell, seed, dev, modes,
                              cards=cell["workload"]["chips"]):
                print(json.dumps(r), flush=True)
                for k, v in r["every"].items():
                    summary.setdefault(r["mode"], {}).setdefault(
                        k, []).append(v)
    print(json.dumps({"summary": {
        mode: {k: {"max": max(v), "min": min(v)} for k, v in d.items()}
        for mode, d in summary.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
