"""One run of one cell on one rank: set-up, the checked steps, the
measured window, the traced steps and the check against the reference.

The loop is that of the program's training driver
(``repro_torch.launch.train._train``), which has no entry that runs for a
given time: the global batch of the next step is built and blocked by
``CodedBatcher`` on a worker thread while the device runs this one; the
``CodingRuntime``'s ``LookaheadPrefetcher`` samples and decodes the
straggler masks on the same thread, ``lookahead`` rounds at a time; on W
ranks rank 0 decodes and broadcasts w (one float32 vector, which here
also carries rank 0's decision to stop, so that every rank runs the same
steps); the step is ``coded_train.make_train_step(dedup=True)`` or
``make_manual_collective_train_step`` under AdamW.

Set-up builds one step, with its parameters (made from the seed by
``inputs`` in the layout of the configuration's reference family) and
AdamW state, and drives it through the traffic's ``checked_steps`` first
steps in the window's own loop: they warm up every shape and are what
the reference follows. The window then runs whole steps from where they
stopped until ``seconds`` have passed.
With ``trace`` a few more steps run under ``torch.profiler``, and the
program's counters that the cell's per-layer readers declare are read
around them.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import statistics
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path
from types import ModuleType
from typing import Dict, List

import numpy as np
import torch

from . import inputs, reference, span_trace
from .reference import coding as ref_coding

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# The numbers a check can compare; a cell's limits file names those it
# compares.
NUMBERS = ("loss_gap", "grad_gap", "change_gap", "alpha_gap")


def load_cell(workload: str) -> dict:
    """The cell's entry, configuration, traffic, limits and per-layer
    metrics, each found by name; the configuration's reference family
    (its ``"reference"``) must exist."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")

    def data(folder, name):
        return json.loads((HERE / folder / f"{name}.json").read_text())
    config = data("configs", wl["config"])
    if "reference" not in config:
        raise SystemExit(f"configuration {wl['config']!r} names no "
                         "reference family (its \"reference\" key)")
    try:
        reference.family(config["reference"])
    except LookupError as e:
        raise SystemExit(f"configuration {wl['config']!r}: {e}") from None
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload])]
    return {"workload": wl, "config": config,
            "traffic": data("traffic", wl["traffic"]),
            "limits": data("limits", workload), "per_layer": per_layer}


def family_of(cell: dict) -> ModuleType:
    """The cell's reference family."""
    return reference.family(cell["config"]["reference"])


def metric(name: str) -> ModuleType:
    """The reader of per-layer metric ``name``, ``metrics/<name>.py``: its
    ``read(ctx)`` and, where it reads the program's counters, its
    ``COUNTERS`` ({key: "module:attribute"}, a dict of numbers in a module
    of the program)."""
    spec = importlib.util.spec_from_file_location(
        f"trainbench_metric_{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def program_counters(per_layer: List[dict]) -> Dict[str, dict]:
    """{key: the program's counter dict} that the readers of
    ``per_layer`` declare."""
    where: Dict[str, str] = {}
    for m in per_layer:
        for key, at in getattr(metric(m["name"]), "COUNTERS", {}).items():
            if where.setdefault(key, at) != at:
                raise SystemExit(f"counter {key!r} named twice: {where[key]} "
                                 f"and {at}")
    out = {}
    for key, at in where.items():
        module, _, attr = at.partition(":")
        if module.split(".")[0] != "repro_torch" or not attr:
            raise SystemExit(f"counter {key!r}: {at!r} is not "
                             "'repro_torch.<module>:<attribute>'")
        out[key] = getattr(importlib.import_module(module), attr)
    return out


class Spans:
    """Host seconds by span name, one entry a step; each span is also a
    ``record_function`` range, so a trace can name what the host did."""

    def __init__(self):
        self.times: Dict[str, List[float]] = {}
        self.on = True

    @contextmanager
    def __call__(self, name: str):
        rf = torch.profiler.record_function(f"tb:{name}")
        with rf:
            t0 = time.perf_counter()
            yield
            dt = time.perf_counter() - t0
        if self.on:
            self.times.setdefault(name, []).append(dt)


def _program():
    """The program's modules, imported from ``src/`` of this checkout."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    from repro_torch.configs import CodingConfig, ModelConfig
    from repro_torch.core import step_weights as sw
    from repro_torch.data.pipeline import CodedBatcher
    from repro_torch.dist import coded_train
    from repro_torch.dist import process_group as pg
    from repro_torch.optim import optimizers as opt_mod
    return dict(CodingConfig=CodingConfig, ModelConfig=ModelConfig, sw=sw,
                CodedBatcher=CodedBatcher, coded_train=coded_train, pg=pg,
                opt_mod=opt_mod)


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def model_config(P, model: dict):
    """The program's (frozen) ``ModelConfig`` of a configuration's model,
    every list a tuple."""
    return P["ModelConfig"](**{k: _tuples(v) for k, v in model.items()})


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _norms(tree, scale: float = 1.0) -> Dict[str, float]:
    fl = inputs.flat(tree)
    vals = torch.stack([torch.linalg.vector_norm(v.float()) for v in
                        fl.values()]).mul_(scale).tolist()
    return dict(zip(fl.keys(), vals))


def run(cell: dict, seed: int, seconds: float, trace: bool, dev, *,
        t_start: float, workers=None) -> dict:
    """Everything one rank measures; rank 0's dict also holds the check."""
    P = _program()
    split = {"imports_s": time.time() - t_start}
    cfgj, traffic = cell["config"], cell["traffic"]
    model = cfgj["model"]
    cfg = model_config(P, model)
    fam = family_of(cell)
    coded_train, sw = P["coded_train"], P["sw"]
    rank = 0 if workers is None else workers.rank
    distributed = workers is not None and workers.distributed
    decoder = rank == 0
    m = traffic["machines"]
    coding = P["CodingConfig"](
        scheme=traffic["scheme"], replication=traffic["replication"],
        decoding="optimal", straggler_model=traffic["straggler_model"],
        straggler_p=traffic["straggler_p"], seed=seed)
    t0 = time.time()
    if decoder:
        runtime = coded_train.CodingRuntime(coding, m, device=dev)
        assignment = runtime.assignment
    else:
        runtime, assignment = None, coded_train.make_assignment(coding, m)
    batcher = P["CodedBatcher"](assignment, shuffle_seed=seed)
    dedup = traffic["path"] == "dedup"
    emit = batcher.unique_blocks if dedup else batcher.code_batch
    gb = assignment.n * traffic["block_size"]
    tokens = inputs.tokens_for(cfgj, traffic, seed)
    split["coding_s"] = time.time() - t0

    t0 = time.time()
    params = inputs.nest(inputs.make_params(fam, model, seed, dev))
    o = traffic["optimizer"]
    optimizer = P["opt_mod"].get_optimizer(
        "adamw", o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
        weight_decay=o["weight_decay"])
    opt_state = optimizer.init(params)
    _sync(dev)
    split["weights_s"] = time.time() - t0
    alpha_w = coded_train.alpha_bar_weights(assignment)
    step_workers = workers if distributed else None
    if dedup:
        step_fn = coded_train.make_train_step(
            cfg, optimizer, dedup=True,
            norm_scale=coded_train.dedup_norm_scale(assignment),
            alpha_weights=alpha_w, workers=step_workers)
    else:
        step_fn = coded_train.make_manual_collective_train_step(
            cfg, optimizer, alpha_weights=alpha_w,
            streaming_chunk=traffic.get("stream_chunk"),
            workers=step_workers)

    pool = ThreadPoolExecutor(max_workers=1)
    spans = Spans()
    lookahead = (coded_train.LookaheadPrefetcher(
        runtime, pool, max(1, traffic.get("lookahead", 8)), 1 << 40)
        if decoder else None)

    def host_batch(s):
        return emit(tokens.batch(gb, s))

    state = {"pending": pool.submit(host_batch, 0), "params": params,
             "opt": opt_state}
    del params, opt_state

    def one_step(s: int, stop: bool = False):
        """Step s, or None where rank 0 says stop."""
        if stop and not distributed:
            return None
        with spans("decode_wait"):
            w = alive = None
            if decoder:
                w, alive = lookahead.next()
            if distributed:
                msg = (torch.from_numpy(np.append(w, float(stop)).astype(
                    np.float32)).to(dev) if decoder else
                    torch.empty(m + 1, dtype=torch.float32, device=dev))
                msg = workers.broadcast_(msg).cpu().numpy()
                w, stop = msg[:m], bool(msg[m])
        if stop:
            return None
        with spans("host_loop"):
            batch_np = state["pending"].result()
            state["pending"] = pool.submit(host_batch, s + 1)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in
                     batch_np.items()}
        wv = sw.block_weights(assignment, w) if dedup else w
        wv = torch.from_numpy(np.asarray(wv, np.float32)).to(dev)
        with spans("step"), torch.no_grad():
            state["params"], state["opt"], metrics = step_fn(
                state["params"], state["opt"], batch, wv)
        return metrics, w, alive

    k_checked = traffic["checked_steps"]
    checked = {"loss": [], "w": [], "alive": []}
    t0 = time.time()
    spans.on = False
    try:
        for s in range(k_checked):
            metrics, w, alive = one_step(s)
            checked["loss"].append(metrics["loss"])
            checked["w"].append(np.asarray(w, np.float64))
            checked["alive"].append(alive)
            if s == 0:
                first_grad = _norms(state["opt"]["m"], 1.0 / (1 - o["b1"]))
        _sync(dev)
        split["checked_steps_s"] = time.time() - t0
        t0 = time.time()
        checked["loss"] = [float(x) for x in checked["loss"]]
        fl = inputs.flat(state["params"])
        change = {}
        for path, x in fl.items():
            start = inputs.make_leaf(fam, path, x.shape, seed, dev)
            change[path] = float(torch.linalg.vector_norm(x - start))
            del start
        split["records_s"] = time.time() - t0

        # the window
        spans.on = True
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t_w0 = time.time()
        setup_s = t_w0 - t_start
        losses, s = [], k_checked
        while True:
            out = one_step(s, stop=bool(losses) and
                           time.time() - t_w0 >= seconds)
            if out is None:
                break
            losses.append(out[0]["loss"])
            s += 1
        _sync(dev)
        t_w1 = time.time()
        spans.on = False
        window_steps = len(losses)
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        finite = torch.isfinite(torch.stack(losses)).tolist() if losses \
            else []
        result = {
            "rank": rank, "seed": seed, "setup_s": setup_s,
            "setup_split": split, "window_s": t_w1 - t_w0,
            "window_steps": window_steps,
            "failed": int(sum(1 for f in finite if not f)),
            "memory_peak_bytes": int(peak),
            "spans": {k: v for k, v in spans.times.items()},
        }
        if trace:
            result["trace"] = _traced(one_step, s, cell, dev, spans, rank)
            result["traffic_bytes_per_step"] = result["trace"].pop(
                "traffic_bytes_per_step")
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    del state, step_fn, lookahead, losses
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if decoder:
        t0 = time.time()
        result["check"] = check(cell, seed, dev, checked, first_grad, change)
        result["check_s"] = time.time() - t0
    return result


def _traced(one_step, s0, cell, dev, spans, rank):
    """The traffic's ``traced_steps`` further steps under torch.profiler:
    the chrome trace is written under ``TMPDIR``, reduced
    (``trace.reduce``), its device time put down to the spans that
    launched it (``span_trace.by_span``) and deleted. ``counters``: the
    change a step of each program counter the cell's readers declare."""
    from torch.profiler import ProfilerActivity, profile
    from . import trace as trace_mod
    P = _program()
    traffic0 = dict(P["pg"].traffic)
    counters = program_counters(cell["per_layer"])
    counters0 = {key: dict(c) for key, c in counters.items()}
    k = cell["traffic"].get("traced_steps", 3)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    spans.on = False
    with profile(activities=acts) as prof:
        _sync(dev)
        t0 = time.time()
        done = 0
        for i in range(k):
            if one_step(s0 + i) is None:
                break
            done += 1
        _sync(dev)
        window = time.time() - t0
    fd, path = tempfile.mkstemp(prefix=f"trainbench-trace-rank{rank}-",
                                suffix=".json")
    os.close(fd)
    prof.export_chrome_trace(path)
    try:
        red = trace_mod.reduce(path)
        red["by_span"] = span_trace.by_span(path)
    finally:
        os.remove(path)
    moved = {kk: (P["pg"].traffic[kk] - traffic0[kk]) / max(done, 1)
             for kk in traffic0}
    red["counters"] = {
        key: {kk: (v - counters0[key].get(kk, 0)) / max(done, 1)
              for kk, v in c.items()} for key, c in counters.items()}
    red.update({"window_s": window, "steps": done,
                "traffic_bytes_per_step": moved})
    return red


def check(cell: dict, seed: int, dev, checked: dict, first_grad: dict,
          change: dict) -> dict:
    """Follow the checked steps with the plain reference and compare:
    each number beside its limit."""
    from .reference import train as ref_train
    cfgj, traffic = cell["config"], cell["traffic"]
    model = cfgj["model"]
    n = ref_coding.assignment(traffic["scheme"], traffic["machines"],
                              traffic["replication"]).shape[0]
    gb_rows = n * traffic["block_size"]
    tokens = inputs.tokens_for(cfgj, traffic, seed)
    k = len(checked["loss"])
    batches = [tokens.batch(gb_rows, s) for s in range(k)]
    fam = family_of(cell)
    params0 = inputs.make_params(fam, model, seed, dev)
    ref = ref_train.run(fam, model, traffic, seed, params0, batches,
                        checked["alive"])
    del params0
    rc = ref_change(fam, seed, dev, ref["params"])
    readings = compare_records(cell, checked, first_grad, change, ref, rc)
    del ref
    gc.collect()
    return readings


def ref_change(fam: ModuleType, seed: int, dev,
               trained: dict) -> Dict[str, float]:
    """Each leaf's change from its start, as family ``fam`` made it."""
    out = {}
    for path, x in trained.items():
        start = inputs.make_leaf(fam, path, x.shape, seed, dev)
        out[path] = float(torch.linalg.vector_norm(x - start))
    return out


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   keep=None) -> Dict[str, object]:
    keys = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in keys)
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in keys}
    top = sorted(keys, key=gaps.get, reverse=True)[:4]
    return {"value": gaps[top[0]], "leaf": top[0],
            "top": {k: [gaps[k], prog[k], ref[k]] for k in top},
            "median": med}


def compare_records(cell, checked, first_grad, change, ref, ref_chg) -> dict:
    """The four numbers the check compares, each beside its limit, from
    the records of the side under test (``checked``: each step's loss and
    its w and alive mask, or its alpha; the first gradient's and the
    change's norms by leaf) and the reference's."""
    traffic = cell["traffic"]
    A = ref_coding.assignment(traffic["scheme"], traffic["machines"],
                              traffic["replication"])
    # a step on which every machine straggled has w = 0 and loss 0 on
    # both sides
    losses = [0.0 if p == r else float(abs(p - r) / max(abs(r), 1e-30))
              for p, r in zip(checked["loss"], ref["losses"])]
    alpha = []
    for t, a_ref in enumerate(ref["alphas"]):
        if "w" in checked:
            w = checked["w"][t]
            off = np.abs(w[~np.asarray(checked["alive"][t], bool)])
            gap = max(float(np.max(np.abs(A @ w - a_ref))),
                      float(off.max()) if off.size else 0.0)
        else:
            gap = float(np.max(np.abs(checked["alpha"][t] - a_ref)))
        alpha.append(gap)
    med_g = statistics.median(ref["first_grad"].values())
    # leaves whose reference gradient is nought to rounding move under
    # Adam by round-off alone: left out of the change by this rule
    keep = {k for k, g in ref["first_grad"].items() if g >= 1e-3 * med_g}
    grad = worst_leaf_gap(first_grad, ref["first_grad"])
    chg = worst_leaf_gap(change, ref_chg, keep)
    limits = cell["limits"]
    every = {"loss_gap": max(losses), "grad_gap": grad["value"],
             "change_gap": chg["value"],
             "alpha_gap": max(alpha)}
    numbers = {k: v for k, v in every.items() if k in limits}
    return {"numbers": {k: {"value": v, "limit": limits[k]}
                        for k, v in numbers.items()},
            "every": every,
            "worst_leaf": {"grad_gap": grad["leaf"],
                           "change_gap": chg["leaf"]},
            "leaves": {"grad_gap": grad["top"], "change_gap": chg["top"],
                       "medians": [grad["median"], chg["median"]]},
            "norms": {"grad": {k: [first_grad[k], ref["first_grad"][k]]
                               for k in ref["first_grad"]},
                      "change": {k: [change[k], ref_chg[k]] for k in ref_chg}},
            "left_out_of_change": sorted(set(ref_chg) - keep),
            "losses": {"program": list(checked["loss"]),
                       "reference": ref["losses"]},
            "correct": all(math.isfinite(v) and v <= limits[k]
                           for k, v in numbers.items())}
