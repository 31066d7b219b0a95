"""Coded-vs-uncoded train-step benchmark on one device.

Port of ``benchmarks/train_step.py``, in process (the port has one
device and no mesh). On the card: granite-3-8b at full width cut to 2
layers (bf16 activations, float32 parameters, AdamW at lr 1e-4), m = 4
machines, expander d = 2, Bernoulli p = 0.2, 256-token sequences in
blocks of 4 -- ``chip_smoke.py``'s training shape. On the CPU
(``--device cpu``): the reference bench's qwen1.5-4b smoke variant and
AdamW at lr 1e-3, on 32-token sequences (the reference CI's chaos
smoke; its bench takes 64) to keep the CPU run short.

Rows (the reference's, on the same geometry): the replicated coded step
(autograd's combine), the dedup step (each unique block once, weighted
by v = A @ w), the manual collective (explicit per-machine gradients
through K3 ``coded_combine``), the uncoded baseline, and the dedup step
under int8 and sign (K4 ``quantized_combine``) and sign_packed (K5
``packed_sign_combine``). Each row: the median ``step_ms`` over the
timed steps (the first two are warm-up and not counted), unique tokens
a second, host decode us a step (``CodingRuntime.step_weights``) and
per mask batched (``decode_batch`` over 256 masks), comm bytes a step
against float32 at the same rows, and a ``memory`` column:
``torch.cuda.max_memory_allocated`` on the card (the tracemalloc peak
of host allocations on the CPU). The dedup row also holds the bytes
allocated just before its first step (parameters, AdamW state, batch,
weights; measured from the allocator, less what was allocated before
the build) beside the dry-run's argument bytes for the same step.

The chaos row runs the training entry point twice (``launch.train.main``):
clean, and with ``--chaos kill:1@3`` (int8, so K4 runs on 4 blocks, then
on 3 after the re-assignment), straggler sampling off on both.

The reference's streaming-vs-materialising manual pair waits for the
streaming combine (the distributed slice of the port); it is a
``pending`` entry, not a row.

Inline acceptance, the reference's: dedup < replicated, host decode <
0.2 x the replicated step, and under chaos one re-assignment to
m = 3 over two generations, detection within 4 steps, |loss gap| < 0.6.
"""

from __future__ import annotations

import gc
import time
import tracemalloc

import numpy as np
import torch

from repro_torch.configs import CodingConfig, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import compress as compress_mod
from repro_torch.data.pipeline import CodedBatcher, SyntheticLM
from repro_torch.dist import coded_train
from repro_torch.launch import dryrun, specs
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import make_test_layout
from repro_torch.models import model as M
from repro_torch.optim import optimizers as opt_mod

CARD = dict(arch="granite-3-8b", overrides={"n_layers": 2}, seq_len=256,
            block_size=4, lr=1e-4)
CPU = dict(arch="qwen1.5-4b", overrides=None, seq_len=32, block_size=4,
           lr=1e-3)
MACHINES = 4
CHAOS_SPEC = "kill:1@3"


def bench_config(dev):
    size = CARD if dev.type == "cuda" else CPU
    cfg = get_config(size["arch"])
    cfg = (cfg.with_overrides(**size["overrides"]) if size["overrides"]
           else cfg.smoke_variant())
    return cfg, size


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def dryrun_argument_bytes(cfg, seq_len: int, global_batch: int,
                          replication: int = 2) -> int:
    """The dry-run's argument bytes (parameters, AdamW state, the coded
    batch, w) of this bench's step with every machine on one device."""
    spec = specs.make_step_spec(
        cfg, ShapeSpec("bench_train", seq_len, global_batch, "train"),
        make_test_layout((MACHINES, 1)),
        CodingConfig(replication=replication))
    return dryrun.argument_bytes(spec, make_test_layout((1, 1)))


def measure_one(cfg, size, dev, scheme: str, decoding: str, *, steps: int,
                path: str = "replicated", collective: str = "gspmd",
                compress: str = "none") -> dict:
    dedup = path == "dedup"
    codec = None if compress == "none" else compress_mod.get_codec(compress)
    seq_len, block_size = size["seq_len"], size["block_size"]
    card = dev.type == "cuda"
    gc.collect()
    if card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    else:
        tracemalloc.start()
    coding = CodingConfig(scheme=scheme, replication=2, decoding=decoding,
                          straggler_p=0.2, seed=0)
    runtime = coded_train.CodingRuntime(coding, MACHINES, device=dev)
    assignment = runtime.assignment
    global_batch = assignment.n * block_size
    source = SyntheticLM(cfg.vocab_size, seq_len, seed=0)
    batcher = CodedBatcher(assignment, shuffle_seed=0)
    emit = batcher.unique_blocks if dedup else batcher.code_batch

    params = M.init_params(cfg, seed=0, device=dev)
    optimizer = opt_mod.get_optimizer("adamw", size["lr"])
    opt_state = optimizer.init(params)
    comp_rows = assignment.n if dedup else MACHINES
    comp_state = (compress_mod.init_state(params, comp_rows)
                  if codec else None)
    alpha_w = coded_train.alpha_bar_weights(assignment)
    if collective == "manual":
        step_fn = coded_train.make_manual_collective_train_step(
            cfg, optimizer, alpha_weights=alpha_w, compress=codec)
    else:
        step_fn = coded_train.make_train_step(
            cfg, optimizer, dedup=dedup,
            norm_scale=coded_train.dedup_norm_scale(assignment),
            alpha_weights=alpha_w, compress=codec)

    step_times, decode_times = [], []
    args_measured = None
    metrics = None
    with torch.no_grad():
        for step in range(steps):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in
                     emit(source.batch(global_batch, step)).items()}
            t0 = time.perf_counter()
            w, _ = runtime.step_weights()
            wv = runtime.block_weights(w) if dedup else w
            decode_times.append(time.perf_counter() - t0)
            wv = torch.from_numpy(np.asarray(wv, np.float32)).to(dev)
            if step == 0 and card:
                _sync(dev)
                args_measured = torch.cuda.memory_allocated(dev) - base
            t0 = time.perf_counter()
            if codec:
                params, opt_state, comp_state, metrics = step_fn(
                    params, opt_state, comp_state, batch, wv)
            else:
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     batch, wv)
            float(metrics["loss"])            # waits for the step
            step_times.append(time.perf_counter() - t0)
    if card:
        memory = {"peak_bytes": torch.cuda.max_memory_allocated(dev),
                  "source": "torch.cuda.max_memory_allocated"}
    else:
        memory = {"peak_bytes": tracemalloc.get_traced_memory()[1],
                  "source": "tracemalloc (host allocations)"}
        tracemalloc.stop()
    if dedup and codec is None:
        dry = dryrun_argument_bytes(cfg, seq_len, global_batch)
        memory.update(argument_bytes_dryrun=dry,
                      argument_bytes_measured=args_measured,
                      argument_bytes_rel_diff=(
                          None if args_measured is None
                          else abs(args_measured - dry) / dry))
    step_s = float(np.median(step_times[2:] or step_times))
    masks = np.random.default_rng(1).random((256, MACHINES)) >= 0.2
    t0 = time.perf_counter()
    runtime.decode_batch(masks)
    batched_us = (time.perf_counter() - t0) / masks.shape[0] * 1e6
    comm = compress_mod.comm_bytes_per_step(codec, comp_rows, params)
    comm_f32 = compress_mod.comm_bytes_per_step(None, comp_rows, params)
    final_loss = float(metrics["loss"])
    del params, opt_state, comp_state, metrics
    return {
        "scheme": scheme, "decoding": decoding, "path": path,
        "collective": collective, "compress": compress,
        "stream_chunk": 0, "memory": memory,
        "comm_bytes_per_step": comm,
        "comm_bytes_per_step_float32": comm_f32,
        "m_workers": MACHINES, "global_batch": global_batch,
        "seq_len": seq_len, "steps": steps,
        "step_ms": step_s * 1e3,
        "step_ms_all": [t * 1e3 for t in step_times],
        "tokens_per_s": global_batch * seq_len / step_s,
        "decode_us_per_step": float(np.mean(decode_times[1:]
                                            or decode_times)) * 1e6,
        "decode_us_per_mask_batched": batched_us,
        "decode_calls": runtime.decode_calls,
        "final_loss": final_loss,
    }


def measure_chaos(cfg, size, dev, steps: int) -> dict:
    """Kill machine 1 at step 3 through ``launch.train.main``; the same
    run without chaos is the clean baseline."""
    base = ["--steps", str(steps), "--seq-len", str(size["seq_len"]),
            "--block-size", str(size["block_size"]), "--machines",
            str(MACHINES), "--straggler-p", "0", "--compress", "int8",
            "--lr", str(size["lr"]), "--seed", "0", "--log-every",
            str(max(1, steps // 2)), "--device", dev.type]
    clean = train_mod.main(base, cfg=cfg)
    t0 = time.perf_counter()
    chaotic = train_mod.main(base + ["--chaos", CHAOS_SPEC], cfg=cfg)
    wall = time.perf_counter() - t0
    ch = chaotic["chaos"]
    return {
        "spec": CHAOS_SPEC, "steps": steps, "compress": "int8",
        "wall_s": wall,
        "steps_to_detect": ch["steps_to_detect"],
        "degraded_steps": ch["degraded_steps"],
        "reassignments": ch["reassignments"],
        "events": ch["events"],
        "m_final": ch["m_final"],
        "generations": ch["generations"],
        "final_loss": chaotic["last_loss"],
        "final_loss_clean": clean["last_loss"],
        "loss_gap": chaotic["last_loss"] - clean["last_loss"],
    }


def find_run(runs, **want) -> dict:
    return next(r for r in runs
                if all(r.get(k) == v for k, v in want.items()))


def main(dev: torch.device, fast: bool = True) -> dict:
    steps = 8 if fast else 24
    cfg, size = bench_config(dev)
    kw = dict(steps=steps)
    one = lambda *a, **k: measure_one(cfg, size, dev, *a,  # noqa: E731
                                      **kw, **k)
    runs = [
        one("expander", "optimal", path="replicated"),
        one("expander", "optimal", path="dedup"),
        one("expander", "optimal", path="replicated", collective="manual"),
        one("uncoded", "fixed", path="replicated"),
        one("expander", "optimal", path="dedup", compress="int8"),
        one("expander", "optimal", path="dedup", compress="sign"),
        one("expander", "optimal", path="dedup", compress="sign_packed"),
    ]
    report = {
        "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "dtype": cfg.dtype, "m_workers": MACHINES,
        "seq_len": size["seq_len"], "block_size": size["block_size"],
        "lr": size["lr"], "steps_timed": steps, "runs": runs,
        "pending": [{"rows": "streaming vs materialising manual pair "
                             "(m = 8, stream_chunk 1)",
                     "pending": "A3 streaming"}],
        "chaos": measure_chaos(cfg, size, dev, max(steps, 12)),
    }
    for run in runs:
        label = f"{run['scheme']}/{run['path']}/{run['collective']}"
        if run["compress"] != "none":
            label += f"/{run['compress']}"
        print(f"  {label}: {run['step_ms']:.1f} ms/step, "
              f"{run['tokens_per_s']:.0f} tok/s, decode "
              f"{run['decode_us_per_step']:.0f} us/step (batched "
              f"{run['decode_us_per_mask_batched']:.0f} us/mask), peak "
              f"{run['memory']['peak_bytes'] / 1e9:.2f} GB")
    repl = find_run(runs, scheme="expander", path="replicated",
                    collective="gspmd", compress="none")
    dedup = find_run(runs, scheme="expander", path="dedup",
                     compress="none")
    uncoded = find_run(runs, scheme="uncoded")
    if not dedup["step_ms"] < repl["step_ms"]:
        raise AssertionError(f"dedup step ({dedup['step_ms']} ms) must "
                             f"beat the replicated coded step "
                             f"({repl['step_ms']} ms)")
    if not repl["decode_us_per_step"] < 0.2 * repl["step_ms"] * 1e3:
        raise AssertionError("host decode must stay off the step's "
                             "critical path")
    print(f"  dedup/uncoded step ratio: "
          f"{dedup['step_ms'] / uncoded['step_ms']:.2f}x (replicated "
          f"{repl['step_ms'] / uncoded['step_ms']:.2f}x)")
    chaos = report["chaos"]
    if len(chaos["reassignments"]) != 1:
        raise AssertionError(f"expected one elastic re-assignment, got "
                             f"{chaos['reassignments']}")
    if chaos["m_final"] != 3 or chaos["generations"] != 2:
        raise AssertionError(f"chaos: m_final {chaos['m_final']}, "
                             f"generations {chaos['generations']}")
    if not all(v <= 4 for v in chaos["steps_to_detect"].values()):
        raise AssertionError(f"detection latency too high: "
                             f"{chaos['steps_to_detect']}")
    if not abs(chaos["loss_gap"]) < 0.6:
        raise AssertionError(f"chaos run ended {chaos['loss_gap']} off "
                             f"the clean run")
    print(f"  chaos {chaos['spec']}: detect {chaos['steps_to_detect']} "
          f"steps, degraded {chaos['degraded_steps']}, final loss "
          f"{chaos['final_loss']:.3f} vs clean "
          f"{chaos['final_loss_clean']:.3f}")
    return report
