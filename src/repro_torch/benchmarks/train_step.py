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
``packed_sign_combine``), and the reference's streaming-vs-materialising
manual pair: m = 8 machines, the manual collective materialising all 8
per-machine gradients, then streaming them one machine at a time
(``stream_chunk`` 1). Each row: the median ``step_ms`` over the timed
steps (the first two are warm-up and not counted), unique tokens a
second, host decode us a step (``CodingRuntime.step_weights``) and per
mask batched (``decode_batch`` over 256 masks), comm bytes a step
against float32 at the same rows, and a ``memory`` column: on the card
``torch.cuda.max_memory_allocated`` over the run and ``temp_bytes``, that
peak less what was allocated just before the first step; on the CPU,
for the manual rows (the streaming acceptance's), ``temp_bytes`` and
``peak_bytes`` are the peak of the bytes torch's allocator held above
the step's start during one more step, read from ``torch.profiler``'s
memory events (``tracemalloc`` does not see torch's allocator), and
``None`` for the other rows. The dedup row also holds the bytes allocated just before its
first step (parameters, AdamW state, batch, weights; measured from the
allocator, less what was allocated before the build) beside the
dry-run's argument bytes for the same step.

The chaos row runs the training entry point twice (``launch.train.main``):
clean, and with ``--chaos kill:1@3`` (int8, so K4 runs on 4 blocks, then
on 3 after the re-assignment), straggler sampling off on both.

Inline acceptance, the reference's: dedup < replicated, host decode <
0.2 x the replicated step, the streaming step's temporary bytes strictly
under the materialising step's, and under chaos one re-assignment to
m = 3 over two generations, detection within 4 steps, |loss gap| < 0.6.
The dedup-vs-replicated comparison is its own measurement
(``paired_step_ms``): the two steps alternate on the same parameters,
batch and weights, and the least of ``PAIRED_REPS`` times of each is
compared, so a host busy with other work slows both alike.
"""

from __future__ import annotations

import gc
import time

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
STREAM_MACHINES = 8
PAIRED_REPS = 7
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


def host_temp_bytes(fn) -> int:
    """The peak of the bytes torch's CPU allocator held above what it
    held when ``fn()`` started, from ``torch.profiler``'s memory
    events."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        fn()
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() == "[memory]"),
                    key=lambda e: e.start_ns())
    live = peak = 0
    for e in events:
        live += e.nbytes()
        peak = max(peak, live)
    return int(peak)


def _build(cfg, size, dev, scheme, decoding, *, path, collective,
           compress, machines, stream_chunk):
    """(runtime, emit, global_batch, params, opt_state, comp_state,
    step_fn) of one row."""
    dedup = path == "dedup"
    coding = CodingConfig(scheme=scheme, replication=2, decoding=decoding,
                          straggler_p=0.2, seed=0)
    runtime = coded_train.CodingRuntime(coding, machines, device=dev)
    assignment = runtime.assignment
    batcher = CodedBatcher(assignment, shuffle_seed=0)
    emit = batcher.unique_blocks if dedup else batcher.code_batch
    params = M.init_params(cfg, seed=0, device=dev)
    optimizer = opt_mod.get_optimizer("adamw", size["lr"])
    opt_state = optimizer.init(params)
    comp_rows = assignment.n if dedup else machines
    comp_state = (compress_mod.init_state(params, comp_rows)
                  if compress != "none" else None)
    codec = None if compress == "none" else compress_mod.get_codec(compress)
    alpha_w = coded_train.alpha_bar_weights(assignment)
    if collective == "manual":
        step_fn = coded_train.make_manual_collective_train_step(
            cfg, optimizer, alpha_weights=alpha_w, compress=codec,
            streaming_chunk=stream_chunk or None)
    else:
        step_fn = coded_train.make_train_step(
            cfg, optimizer, dedup=dedup,
            norm_scale=coded_train.dedup_norm_scale(assignment),
            alpha_weights=alpha_w, compress=codec)
    return (runtime, emit, assignment.n * size["block_size"], params,
            opt_state, comp_state, step_fn)


def measure_one(cfg, size, dev, scheme: str, decoding: str, *, steps: int,
                path: str = "replicated", collective: str = "gspmd",
                compress: str = "none", machines: int = MACHINES,
                stream_chunk: int = 0) -> dict:
    dedup = path == "dedup"
    codec = None if compress == "none" else compress_mod.get_codec(compress)
    seq_len = size["seq_len"]
    card = dev.type == "cuda"
    gc.collect()
    if card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    runtime, emit, global_batch, params, opt_state, comp_state, step_fn = \
        _build(cfg, size, dev, scheme, decoding, path=path,
               collective=collective, compress=compress, machines=machines,
               stream_chunk=stream_chunk)
    source = SyntheticLM(cfg.vocab_size, seq_len, seed=0)
    comp_rows = runtime.assignment.n if dedup else machines

    def one_step(batch, wv):
        if codec:
            return step_fn(params, opt_state, comp_state, batch, wv)
        return step_fn(params, opt_state, batch, wv)

    step_times, decode_times = [], []
    args_measured = before_step = None
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
                before_step = torch.cuda.memory_allocated(dev)
                args_measured = before_step - base
            t0 = time.perf_counter()
            out = one_step(batch, wv)
            if codec:
                params, opt_state, comp_state, metrics = out
            else:
                params, opt_state, metrics = out
            float(metrics["loss"])            # waits for the step
            step_times.append(time.perf_counter() - t0)
        if card:
            peak = torch.cuda.max_memory_allocated(dev)
            memory = {"peak_bytes": peak, "temp_bytes": peak - before_step,
                      "source": "torch.cuda.max_memory_allocated"}
        elif collective == "manual":
            temp = host_temp_bytes(lambda: one_step(batch, wv))
            memory = {"peak_bytes": temp, "temp_bytes": temp,
                      "source": "torch.profiler memory events (one step)"}
        else:
            memory = {"peak_bytes": None, "temp_bytes": None,
                      "source": "not measured on the CPU"}
    if dedup and codec is None:
        dry = dryrun_argument_bytes(cfg, seq_len, global_batch)
        memory.update(argument_bytes_dryrun=dry,
                      argument_bytes_measured=args_measured,
                      argument_bytes_rel_diff=(
                          None if args_measured is None
                          else abs(args_measured - dry) / dry))
    step_s = float(np.median(step_times[2:] or step_times))
    masks = np.random.default_rng(1).random((256, machines)) >= 0.2
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
        "stream_chunk": stream_chunk, "memory": memory,
        "comm_bytes_per_step": comm,
        "comm_bytes_per_step_float32": comm_f32,
        "m_workers": machines, "global_batch": global_batch,
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


def paired_step_ms(cfg, size, dev, reps: int = PAIRED_REPS) -> dict:
    """The dedup and replicated coded steps, alternating ``reps`` times
    on the same parameters, batch and weights (each after one warm-up
    call): the least time of each and their ratio."""
    rows = {}
    for path in ("replicated", "dedup"):
        runtime, emit, gb, params, opt_state, _, step_fn = _build(
            cfg, size, dev, "expander", "optimal", path=path,
            collective="gspmd", compress="none", machines=MACHINES,
            stream_chunk=0)
        w, _ = runtime.step_weights()
        wv = runtime.block_weights(w) if path == "dedup" else w
        source = SyntheticLM(cfg.vocab_size, size["seq_len"], seed=0)
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in emit(source.batch(gb, 0)).items()}
        rows[path] = (step_fn, params, opt_state, batch,
                      torch.from_numpy(np.asarray(wv, np.float32)).to(dev))
    times = {path: [] for path in rows}
    with torch.no_grad():
        for i in range(reps + 1):
            for path, (step_fn, params, opt_state, batch, wv) in \
                    rows.items():
                _sync(dev)
                t0 = time.perf_counter()
                float(step_fn(params, opt_state, batch, wv)[2]["loss"])
                if i:                                  # 0 is the warm-up
                    times[path].append(time.perf_counter() - t0)
    best = {path: min(t) * 1e3 for path, t in times.items()}
    return {"reps": reps, "replicated_ms": best["replicated"],
            "dedup_ms": best["dedup"],
            "dedup_over_replicated": best["dedup"] / best["replicated"],
            "replicated_ms_all": [t * 1e3 for t in times["replicated"]],
            "dedup_ms_all": [t * 1e3 for t in times["dedup"]]}


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
        one("expander", "optimal", path="replicated", collective="manual",
            machines=STREAM_MACHINES),
        one("expander", "optimal", path="replicated", collective="manual",
            machines=STREAM_MACHINES, stream_chunk=1),
    ]
    report = {
        "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "dtype": cfg.dtype, "m_workers": MACHINES,
        "seq_len": size["seq_len"], "block_size": size["block_size"],
        "lr": size["lr"], "steps_timed": steps, "runs": runs,
        "paired": paired_step_ms(cfg, size, dev),
        "chaos": measure_chaos(cfg, size, dev, max(steps, 12)),
    }
    for run in runs:
        label = f"{run['scheme']}/{run['path']}/{run['collective']}"
        if run["compress"] != "none":
            label += f"/{run['compress']}"
        if run["m_workers"] != MACHINES:
            label += f"/m{run['m_workers']}"
        if run["stream_chunk"]:
            label += f"/stream{run['stream_chunk']}"
        peak = run["memory"]["peak_bytes"]
        print(f"  {label}: {run['step_ms']:.1f} ms/step, "
              f"{run['tokens_per_s']:.0f} tok/s, decode "
              f"{run['decode_us_per_step']:.0f} us/step (batched "
              f"{run['decode_us_per_mask_batched']:.0f} us/mask), peak "
              + ("not measured" if peak is None
                 else f"{peak / 1e9:.2f} GB"))
    repl = find_run(runs, scheme="expander", path="replicated",
                    collective="gspmd", compress="none")
    dedup = find_run(runs, scheme="expander", path="dedup",
                     compress="none")
    uncoded = find_run(runs, scheme="uncoded")
    paired = report["paired"]
    if not paired["dedup_ms"] < paired["replicated_ms"]:
        raise AssertionError(f"dedup step (least of {paired['reps']}: "
                             f"{paired['dedup_ms']} ms) must beat the "
                             f"replicated coded step "
                             f"({paired['replicated_ms']} ms)")
    if not repl["decode_us_per_step"] < 0.2 * repl["step_ms"] * 1e3:
        raise AssertionError("host decode must stay off the step's "
                             "critical path")
    manual8 = find_run(runs, collective="manual",
                       m_workers=STREAM_MACHINES, stream_chunk=0)
    stream8 = find_run(runs, collective="manual",
                       m_workers=STREAM_MACHINES, stream_chunk=1)
    if not stream8["memory"]["temp_bytes"] < \
            manual8["memory"]["temp_bytes"]:
        raise AssertionError(
            f"streaming temp bytes ({stream8['memory']['temp_bytes']}) "
            f"must be under the materialising step's "
            f"({manual8['memory']['temp_bytes']})")
    temp_ratio = (stream8["memory"]["temp_bytes"]
                  / manual8["memory"]["temp_bytes"])
    print(f"  paired least step: dedup {paired['dedup_ms']:.1f} ms, "
          f"replicated {paired['replicated_ms']:.1f} ms "
          f"({paired['dedup_over_replicated']:.2f}x); streaming/"
          f"materialising temp bytes {temp_ratio:.2f}x")
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
