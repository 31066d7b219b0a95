"""End-to-end coded LM training driver on one device.

Port of ``repro.launch.train``: synthetic LM corpus -> coded block
partitioner -> coded train step, with host-side straggler sampling and
O(m) optimal decoding. Runs on the GPU unless ``--device cpu`` is
given; the weights are random, made on the device from ``--seed``, or
restored from ``--ckpt-dir``.

  python -m repro_torch.launch.train --arch granite-3-8b --steps 20 \\
      --scheme expander --decoding optimal --straggler-p 0.2

There is no mesh. The reference's worker count is its mesh's data-axis
size (4 on its CPU demo mesh); here ``--machines`` (default 4) stands in
for ``mesh.shape["data"]``, and the whole machine axis lives on the one
device. Paths: ``--dedup`` (default) runs each unique block once,
weighted by v = A @ w; ``--no-dedup`` materialises the replicated
(m, load, ...) machine batch; ``--collective manual`` reduces explicit
per-machine gradients through the ``coded_combine`` kernel (replicated
path only). ``--compress sign|sign_packed|int8`` quantizes per-row
gradients with error feedback and combines the payload through the
``quantized_combine`` / ``packed_sign_combine`` kernels. ``--scheme``
takes any scheme of the zoo (``expander``, ``frc``, ``uncoded``,
``cyclic_mds``, ``bibd``, ``random_regular``), and ``--adaptive
adaptive|always_optimal|always_fixed`` decides each step's decoder from
the online straggler estimate (summary key ``adaptive``).

The loop is the reference's host pipeline: batches are built on a worker
thread one step ahead of the device, straggler masks are sampled and
decoded ``--lookahead`` rounds at a time on that thread
(``coded_train.LookaheadPrefetcher``), and metrics stay on the device
until a ``--log-every`` boundary. A worker-thread failure re-raises on
the main loop. ``--ckpt-dir`` resumes from the newest intact checkpoint
(compressed, composite or params-only layout, the reference's format);
a params-only checkpoint warm-starts the parameters at step 0, which is
how reference parameters enter this driver.

``--chaos <spec>`` takes the masks from heartbeats instead of sampling
them: a seeded ``dist.chaos.ChaosInjector`` simulates each machine's
completion time per step (kills, rack failures, delays, flapping; the
grammar is in ``dist/chaos.py``), a ``dist.failures.HeartbeatMonitor``
derives the alive mask by deadline (``--heartbeat-deadline``, with
exponential backoff), and ``--dead-after`` consecutive misses declare a
machine dead. A death re-draws the code over the survivors
(``coded_train.elastic_reassign``) and rebuilds the batcher, the step and
(under ``--compress``) a zero residual over the new row count; the
parameters and optimizer state go on as they are. The loop runs one
generation per code. Every detection and re-assignment lands in the
summary's ``chaos`` object (``--event-log FILE`` writes it as JSON).
Chaos needs the dedup path, as in the reference.

``main(argv, cfg)`` takes a ``ModelConfig`` from a caller (it then
replaces ``--arch`` / ``--full-config``). ``--fsdp``, ``--stream-chunk``
and ``--production-mesh`` are accepted and refused: they wait for the
distributed slice of the port.
"""

from __future__ import annotations

import argparse
import json
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import CodingConfig, ModelConfig, get_config
from repro_torch.core import compress as compress_mod
from repro_torch.core import step_weights as sw
from repro_torch.data.pipeline import CodedBatcher, SyntheticLM
from repro_torch.dist import chaos as chaos_mod
from repro_torch.dist import coded_train, failures
from repro_torch.models import model as M
from repro_torch.optim import optimizers as opt_mod

DISTRIBUTED = "waits for the distributed slice of the port"


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--scheme", default="expander",
                    choices=("expander", "frc", "uncoded", "cyclic_mds",
                             "bibd", "random_regular"))
    ap.add_argument("--decoding", default="optimal",
                    choices=("optimal", "fixed"))
    ap.add_argument("--adaptive", default="none",
                    choices=("none", "adaptive", "always_optimal",
                             "always_fixed"))
    ap.add_argument("--straggler-model", default="bernoulli",
                    choices=("bernoulli", "markov", "adversarial"))
    ap.add_argument("--straggler-p", type=float, default=0.2)
    ap.add_argument("--replication", type=int, default=2)
    ap.add_argument("--machines", type=int, default=4,
                    help="coded workers m: the one-device stand-in for "
                         "the reference mesh's data-axis size")
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--block-size", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--dedup", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="run each unique block once, weighted by "
                         "v = A @ w; on by default under --collective "
                         "gspmd")
    ap.add_argument("--collective", default="gspmd",
                    choices=("gspmd", "manual"),
                    help="gradient combine: autograd's fused combine vs "
                         "the explicit coded_combine of per-machine "
                         "gradients (manual implies the replicated path)")
    ap.add_argument("--compress", default="none",
                    choices=("none", "sign", "sign_packed", "int8"))
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lookahead", type=int, default=8)
    ap.add_argument("--log-every", type=int, default=0,
                    help="steps between host metric fetches "
                         "(0: steps // 10)")
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="derive the masks from seeded virtual "
                         "heartbeats: kill:J@S / rack:J,K@S / "
                         "delay:J@S-E[:X] / flap:J@S-E[:K], separated "
                         "by ';' (dist/chaos.py); a death re-draws the "
                         "code over the survivors")
    ap.add_argument("--dead-after", type=int, default=3,
                    help="consecutive missed heartbeats before a "
                         "machine is declared dead (chaos mode)")
    ap.add_argument("--heartbeat-deadline", type=float, default=0.5,
                    help="base per-step deadline in virtual seconds "
                         "(chaos mode; backoff widens it per miss)")
    ap.add_argument("--event-log", default=None, metavar="FILE",
                    help="write the summary's chaos object to FILE as "
                         "JSON")
    # flags of a later slice: accepted, then refused with its name
    ap.add_argument("--stream-chunk", type=int, default=0)
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--production-mesh", action="store_true")
    return ap


def _check_args(ap, args) -> None:
    for flag, given in (("--stream-chunk", args.stream_chunk),
                        ("--fsdp", args.fsdp),
                        ("--production-mesh", args.production_mesh)):
        if given:
            ap.error(f"{flag} {DISTRIBUTED}")
    if args.collective == "manual" and args.microbatches != 1:
        ap.error("--microbatches is only supported with "
                 "--collective gspmd")
    if args.collective == "manual" and args.dedup:
        ap.error("--dedup is only supported with --collective gspmd")
    if args.compress != "none" and args.microbatches != 1:
        ap.error("--compress does not compose with --microbatches")
    if args.chaos:
        if args.collective != "gspmd" or args.dedup is False:
            # a re-assignment changes the machine count; the reference
            # absorbs it on the dedup path's block axis only
            ap.error("--chaos requires the default gspmd dedup path")
        if args.ckpt_dir:
            ap.error("--chaos does not compose with --ckpt-dir: a "
                     "checkpoint records no failure history, so a "
                     "resumed chaos run could not replay the observed "
                     "masks")
    elif args.event_log:
        ap.error("--event-log only applies under --chaos")


def _restore(args, params, opt_state, comp_state, compress, runtime):
    """The reference's resume: newest intact checkpoint at or before
    --steps, compressed -> composite -> params-only templates. Returns
    (start, params, opt_state, comp_state)."""
    usable = [s for s in ckpt.saved_steps(args.ckpt_dir)
              if s <= args.steps]
    if not usable:
        if ckpt.saved_steps(args.ckpt_dir):
            raise SystemExit(
                f"--ckpt-dir {args.ckpt_dir} only has checkpoints past "
                f"--steps {args.steps}; refusing to relabel a "
                "later-step state")
        return 0, params, opt_state, comp_state
    templates = []
    if compress:
        templates.append(("compressed", {"params": params,
                                         "opt_state": opt_state,
                                         "compress": comp_state}))
    templates += [("composite", {"params": params,
                                 "opt_state": opt_state}),
                  ("params", params)]
    step0, label, state = ckpt.restore_fallback(
        args.ckpt_dir, templates, max_step=args.steps)
    if step0 != usable[-1]:
        print(f"checkpoint(s) past step {step0} in {args.ckpt_dir} are "
              "unreadable; fell back to the newest intact step")
    if label == "params":
        print(f"restored params-only checkpoint from {args.ckpt_dir}; "
              "training from step 0")
        return 0, state, opt_state, comp_state
    if label == "compressed":
        comp_state = state["compress"]
    elif compress:
        print("checkpoint has no compression state; resuming with zero "
              "error-feedback residual")
    runtime.skip(step0)
    print(f"restored step-{step0} {label} checkpoint from "
          f"{args.ckpt_dir}")
    return step0, state["params"], state["opt_state"], comp_state


def main(argv=None, cfg: Optional[ModelConfig] = None) -> dict:
    ap = _parser()
    args = ap.parse_args(argv)
    _check_args(ap, args)
    dev = _device.resolve(args.device)
    if cfg is None:
        cfg = get_config(args.arch)
        if not args.full_config:
            cfg = cfg.smoke_variant()

    dedup = args.collective == "gspmd" and args.dedup is not False
    m_workers = args.machines
    coding = CodingConfig(
        scheme=args.scheme, replication=args.replication,
        decoding=args.decoding, straggler_model=args.straggler_model,
        straggler_p=args.straggler_p, seed=args.seed)
    adaptive = None if args.adaptive == "none" else args.adaptive
    # Chaos mode pushes each step's mask from the heartbeat monitor
    # instead of sampling it from the straggler model.
    injector = monitor = surv = None
    mask_source = None
    if args.chaos:
        schedule = chaos_mod.parse_chaos_spec(args.chaos, m_workers)
        injector = chaos_mod.ChaosInjector(schedule, m_workers,
                                           seed=args.seed)
        monitor = failures.HeartbeatMonitor(
            m_workers, deadline=args.heartbeat_deadline,
            dead_after=args.dead_after)
        surv = failures.SurvivorMap(m_workers)
        mask_source = sw.ObservedMaskSource(m_workers)
    runtime = coded_train.CodingRuntime(coding, m_workers,
                                        mask_source=mask_source,
                                        adaptive=adaptive, device=dev)
    lookahead = max(1, args.lookahead)
    log_every = args.log_every or max(1, args.steps // 10)
    source = SyntheticLM(cfg.vocab_size, args.seq_len, seed=args.seed)

    params = M.init_params(cfg, seed=args.seed, device=dev)
    optimizer = opt_mod.get_optimizer("adamw", args.lr)
    opt_state = optimizer.init(params)
    compress = None if args.compress == "none" else args.compress
    comp_rows = runtime.assignment.n if dedup else m_workers
    comp_state = (compress_mod.init_state(params, comp_rows)
                  if compress else None)
    codec = compress_mod.get_codec(compress) if compress else None
    comm_bytes = compress_mod.comm_bytes_per_step(codec, comp_rows, params)
    comm_bytes_f32 = compress_mod.comm_bytes_per_step(None, comp_rows,
                                                      params)
    start = 0
    if args.ckpt_dir:
        start, params, opt_state, comp_state = _restore(
            args, params, opt_state, comp_state, compress, runtime)

    losses = []
    metrics_hist = []          # device scalars, flushed at log points
    all_events = []            # chaos: serialized FailureEvents
    reassignments = []         # chaos: one record per re-draw

    def flush_metrics():
        # The raw coded loss is scaled by each step's straggler draw;
        # report the debiased loss / alpha_bar so steps compare.
        for h in metrics_hist:
            losses.append(float(h["loss"])
                          / max(float(h["alpha_bar"]), 1e-3))
        metrics_hist.clear()

    def save_ckpt(step: int):
        state = {"params": params, "opt_state": opt_state}
        if compress:
            state["compress"] = comp_state
        ckpt.save(args.ckpt_dir, state, step=step)
        print(f"saved step-{step} checkpoint to {args.ckpt_dir}")

    pool = ThreadPoolExecutor(max_workers=1)
    generation = 0
    step = start
    rebuild_started = None
    t0 = time.time()
    try:
        # One generation per code: the batcher and the step are built
        # anew when a re-assignment changes the assignment. Without
        # --chaos there is one generation.
        while step < args.steps:
            assignment = runtime.assignment
            global_batch = assignment.n * args.block_size
            batcher = CodedBatcher(assignment, shuffle_seed=args.seed)
            emit = batcher.unique_blocks if dedup else batcher.code_batch

            def host_batch(s, _emit=emit, _gb=global_batch):
                return _emit(source.batch(_gb, s))

            alpha_w = coded_train.alpha_bar_weights(assignment)
            if args.collective == "manual":
                train_step = coded_train.make_manual_collective_train_step(
                    cfg, optimizer, alpha_weights=alpha_w,
                    compress=compress)
            else:
                train_step = coded_train.make_train_step(
                    cfg, optimizer, n_microbatches=args.microbatches,
                    dedup=dedup,
                    norm_scale=coded_train.dedup_norm_scale(assignment),
                    alpha_weights=alpha_w, compress=compress)
            batch_np = host_batch(step)
            if compress and generation > 0:
                # the residual's rows follow the re-drawn block axis
                comp_state = compress_mod.init_state(
                    params, assignment.n if dedup else runtime.m)
            if rebuild_started is not None:
                reassignments[-1]["rebuild_s"] = round(
                    time.time() - rebuild_started, 3)
                rebuild_started = None
            # Observed masks (chaos) decode per step: a mask is not
            # known before its heartbeats.
            lookahead_w = None
            if not args.chaos:
                lookahead_w = coded_train.LookaheadPrefetcher(
                    runtime, pool, lookahead, args.steps - step)
            pending = None
            reassign_dead = None
            while step < args.steps:
                if pending is not None:
                    # re-raises a worker-thread failure here
                    batch_np = pending.result()
                if step + 1 < args.steps:
                    pending = pool.submit(host_batch, step + 1)
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in batch_np.items()}
                if args.chaos:
                    observed = monitor.observe(
                        step, injector.completion_times(step))
                    runtime.mask_source.push(surv.localize(observed))
                    w, alive = runtime.step_weights()
                else:
                    w, alive = lookahead_w.next()
                wv = runtime.block_weights(w) if dedup else w
                wv = torch.from_numpy(np.asarray(wv, np.float32)).to(dev)
                with torch.no_grad():
                    if compress:
                        params, opt_state, comp_state, metrics = \
                            train_step(params, opt_state, comp_state,
                                       batch, wv)
                    else:
                        params, opt_state, metrics = train_step(
                            params, opt_state, batch, wv)
                metrics_hist.append(metrics)
                if step % log_every == 0 or step == args.steps - 1:
                    flush_metrics()
                    print(f"step {step:4d} loss {losses[-1]:.4f} "
                          f"stragglers {int((~alive).sum())}/{runtime.m} "
                          f"({time.time() - t0:.1f}s)")
                if args.ckpt_dir and args.ckpt_every and \
                        (step + 1) % args.ckpt_every == 0 and \
                        step + 1 < args.steps:
                    save_ckpt(step + 1)
                step += 1
                if args.chaos:
                    new_events = monitor.drain_events()
                    for ev in new_events:
                        all_events.append(ev.to_json())
                        print(f"step {ev.step}: machine {ev.machine} "
                              f"{ev.kind} {ev.detail}")
                    reassign_dead = [ev.machine for ev in new_events
                                     if ev.kind == "dead"]
                    if reassign_dead:
                        break
            if reassign_dead:
                # The step that declared the death already decoded
                # around the machine (a miss zeroes its weight), so no
                # step is recomputed.
                if surv.alive_count - len(reassign_dead) < 1:
                    raise SystemExit(f"step {step}: all machines dead, "
                                     "cannot re-assign")
                flush_metrics()
                rebuild_started = time.time()
                local = [int(np.where(surv.survivors == d)[0][0])
                         for d in reassign_dead]
                surv.remove(reassign_dead)
                generation += 1
                runtime = coded_train.elastic_reassign(
                    runtime, local, generation=generation,
                    mask_source=sw.ObservedMaskSource(surv.alive_count))
                info = {"step": int(step), "generation": int(generation),
                        "dead": [int(d) for d in reassign_dead],
                        "survivors": surv.survivors.tolist(),
                        "m": surv.alive_count,
                        "scheme": runtime.coding.scheme,
                        "replication": int(runtime.coding.replication),
                        "n_blocks": int(runtime.assignment.n),
                        "rebuild_s": None}
                reassignments.append(info)
                all_events.append(
                    {"step": int(step), "kind": "reassign", "machine": -1,
                     "detail": {k: v for k, v in info.items()
                                if k != "step"}})
                print(f"step {step}: elastic re-assignment over "
                      f"m={surv.alive_count} survivors (generation "
                      f"{generation}, d={runtime.coding.replication})")
        flush_metrics()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.time() - t0
        if args.ckpt_dir:
            save_ckpt(args.steps)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    # The per-step coded loss is scaled by the straggler draw, so compare
    # window means; a resumed run sees only its own tail of the stream.
    if losses and start == 0:
        k = max(1, len(losses) // 4)
        first, last = np.mean(losses[:k]), np.mean(losses[-k:])
        assert last < first, \
            f"loss did not decrease ({first:.3f}->{last:.3f})"
    chaos_summary = None
    if args.chaos:
        detect = monitor.steps_to_detect()
        chaos_summary = {
            "spec": args.chaos,
            "events": all_events,
            "reassignments": reassignments,
            "dead_machines": monitor.dead_machines.tolist(),
            "steps_to_detect": {str(k): int(v) for k, v in detect.items()},
            "degraded_steps": int(sum(detect.values())),
            "m_final": surv.alive_count,
            "generations": generation + 1,
        }
        if args.event_log:
            with open(args.event_log, "w") as f:
                json.dump(chaos_summary, f, indent=1)
            print(f"wrote failure-event log to {args.event_log}")
    summary = {"first_loss": losses[0] if losses else None,
               "last_loss": losses[-1] if losses else None,
               "losses": losses, "start_step": start,
               "steps": args.steps, "m_workers": m_workers,
               "scheme": args.scheme, "decoding": args.decoding,
               "path": "dedup" if dedup else "replicated",
               "collective": args.collective,
               "compress": args.compress,
               "stream_chunk": 0, "fsdp": False,
               "comm_bytes_per_step": comm_bytes,
               "comm_bytes_per_step_float32": comm_bytes_f32,
               "decode_calls": runtime.decode_calls,
               "chaos": chaos_summary,
               "device": (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu"),
               "loop_s": wall}
    if runtime.policy is not None:
        est = runtime.estimator.estimate()
        summary["adaptive"] = {
            "policy": args.adaptive,
            "p_hat": est.p_hat,
            "persistence_hat": est.persistence_hat,
            "decision_counts": dict(runtime.decision_counts),
        }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
