"""End-to-end coded LM training driver on one device.

Port of ``repro.launch.train``: synthetic LM corpus -> coded block
partitioner -> coded train step, with host-side straggler sampling and
O(m) optimal decoding. Runs on the GPU unless ``--device cpu`` is
given; the weights are random, made on the device from ``--seed``, or
restored from ``--ckpt-dir``.

  python -m repro_torch.launch.train --arch granite-3-8b --steps 20 \\
      --scheme expander --decoding optimal --straggler-p 0.2

The reference's worker count is its mesh's data-axis size (4 on its CPU
demo mesh); here ``--machines`` (default 4) stands in for
``mesh.shape["data"]``, and on one process the whole machine axis lives
on the one device. Paths: ``--dedup`` (default) runs each unique block once,
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

Under ``torchrun`` (``WORLD_SIZE`` set) the same driver runs on W
worker ranks (``dist.process_group``: ``nccl`` on the card, ``gloo`` on
the CPU), where the reference runs on its mesh's worker axes:

  torchrun --nproc_per_node 4 -m repro_torch.launch.train --device cpu \\
      --collective manual --stream-chunk 1

Rank r owns machines ``[r*m/W, (r+1)*m/W)``, so ``--machines`` must be a
multiple of W. Rank 0 builds the coding runtime, decodes each step's w
and broadcasts it (one (m,) float32 vector); every rank builds the same
coded batch from the seed, computes the gradient of its rows, and the
ranks sum the partial combines (``coded_train``). Rank 0 prints.
``--stream-chunk N`` (with ``--collective manual``) streams the combine
over machine chunks; ``--fsdp`` shards the parameters and AdamW's
moments over the ranks (``dist.fsdp``), and checkpoints still hold the
whole tensors, so they restore into either placement; ``--production-
mesh`` runs only on the production layout's 256 ranks. Under
``--chaos`` every rank runs the same seeded injector and heartbeat
monitor, so the masks, failure events and re-assignments are the same
on every rank with nothing sent; rank 0 alone decodes w and broadcasts
it, as without chaos. A re-assignment to m' machines re-splits the
unique blocks and the compressed residual's rows over the ranks, or
keeps them whole on every rank when the m' blocks do not split over W
(``process_group.block_rows_split``, the reference's divisibility
fallback); only the starting m must be a multiple of W. Rank 0 writes
``--event-log``.

The layout is the reference's: on W ranks ``(W/2, 2)`` when W is even
and > 1, else ``(W, 1)``, and the production layout under
``--production-mesh``; "rank" above is the data coordinate, and W the
data axis's size. The model axis is executed (``dist.tensor_parallel``):
each rank holds its shards of the leaves ``safe_param_specs`` splits
(``fsdp_specs`` under ``--fsdp``) and runs the model on its model group;
the data rank 0 of every model coordinate decodes the same w, and
global rank 0 prints and writes. Checkpoints hold the whole tensors,
gathered over both axes, and restore into any layout. The summary
records the ``layout``, the bytes each group moved a step
(``collective_bytes_per_step``, the model group's under ``model_*``)
and each rank's resident bytes beside ``bytes_per_device``
(``resident_bytes.params_expected``).

``main(argv, cfg, model=...)`` takes a ``ModelConfig`` from a caller (it
then replaces ``--arch`` / ``--full-config``) and the model axis's size.
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
from repro_torch import tree as T
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import CodingConfig, ModelConfig, get_config
from repro_torch.core import compress as compress_mod
from repro_torch.core import step_weights as sw
from repro_torch.data.pipeline import CodedBatcher, SyntheticLM
from repro_torch.dist import chaos as chaos_mod
from repro_torch.dist import coded_train, failures
from repro_torch.dist import process_group as pg
from repro_torch.dist import tensor_parallel
from repro_torch.dist.fsdp import FSDP, resident_bytes
from repro_torch.dist.sharding import bytes_per_device, safe_param_specs
from repro_torch.models import model as M
from repro_torch.optim import optimizers as opt_mod


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
    ap.add_argument("--machines", type=int, default=None,
                    help="coded workers m, a multiple of the ranks W "
                         "(default 4; the production layout's 16 under "
                         "--production-mesh): the reference mesh's "
                         "data-axis size")
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
    ap.add_argument("--stream-chunk", type=int, default=0,
                    help="stream the manual combine over chunks of this "
                         "many machines per rank (0: materialise all "
                         "per-machine gradients; needs --collective "
                         "manual)")
    ap.add_argument("--fsdp", action="store_true",
                    help="shard params and AdamW moments over the "
                         "worker ranks (sharding.fsdp_specs)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the production layout's groups (data=16 x "
                         "model=16); needs WORLD_SIZE 256")
    return ap


def _check_args(ap, args) -> None:
    if args.stream_chunk < 0:
        ap.error("--stream-chunk must be >= 0")
    if args.stream_chunk and args.collective != "manual":
        ap.error("--stream-chunk requires --collective manual (the "
                 "streaming accumulator replaces the materialised "
                 "manual combine)")
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
    if runtime is not None:       # rank 0's mask stream
        runtime.skip(step0)
    print(f"restored step-{step0} {label} checkpoint from "
          f"{args.ckpt_dir}")
    return step0, state["params"], state["opt_state"], comp_state


def _check_layout(ap, args, workers, m: int) -> None:
    """The refusals that need the world size W."""
    size = workers.size
    if m % size:
        ap.error(f"--machines {m} must be a multiple of the {size} worker "
                 "ranks (rank r owns machines [r*m/W, (r+1)*m/W))")
    if args.stream_chunk and m % (size * args.stream_chunk):
        ap.error(f"--stream-chunk {args.stream_chunk} needs m = {m} "
                 f"divisible by worker ranks x chunk = {size} x "
                 f"{args.stream_chunk}")


def _shared_weights(w, m: int, workers, dev) -> np.ndarray:
    """Rank 0's decoded (m,) weights on every rank: one float32
    broadcast over the worker group."""
    w_t = (torch.from_numpy(np.asarray(w, np.float32)).to(dev)
           if w is not None else
           torch.empty(m, dtype=torch.float32, device=dev))
    return workers.broadcast_(w_t).cpu().numpy()


def main(argv=None, cfg: Optional[ModelConfig] = None, *,
         model: Optional[int] = None) -> dict:
    """``cfg``, a ``ModelConfig`` from a caller, replaces ``--arch`` and
    ``--full-config``. ``model`` fixes the model axis of the layout
    ``(W / model, model)`` on W ranks (default: the reference's pick,
    ``process_group.choose_model_size``; 1 keeps the data axis alone)."""
    ap = _parser()
    args = ap.parse_args(argv)
    _check_args(ap, args)
    dev = pg.device_of_rank(_device.resolve(args.device))
    formed = torch.distributed.is_initialized()
    try:
        try:
            workers = pg.init_workers(dev, production=args.production_mesh,
                                      model=model)
        except ValueError as exc:
            ap.error(f"--production-mesh: {exc}" if args.production_mesh
                     else str(exc))
        return _train(ap, args, cfg, dev, workers)
    finally:
        if not formed and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _train(ap, args, cfg, dev, workers) -> dict:
    # The data rank 0 of every model coordinate decodes (the same seeded
    # host code, so the same w); global rank 0 prints and writes.
    decoder = workers.rank == 0
    lead = decoder and (workers.model is None or workers.model.rank == 0)
    if cfg is None:
        cfg = get_config(args.arch)
        if not args.full_config:
            cfg = cfg.smoke_variant()

    dedup = args.collective == "gspmd" and args.dedup is not False
    m_workers = args.machines
    if m_workers is None:
        m_workers = (workers.layout.shape["data"]
                     if args.production_mesh else 4)
    _check_layout(ap, args, workers, m_workers)
    coding = CodingConfig(
        scheme=args.scheme, replication=args.replication,
        decoding=args.decoding, straggler_model=args.straggler_model,
        straggler_p=args.straggler_p, seed=args.seed)
    adaptive = None if args.adaptive == "none" else args.adaptive
    # Chaos mode pushes each step's mask from the heartbeat monitor
    # instead of sampling it from the straggler model. Every rank runs
    # the same seeded injector and monitor, so every rank sees the same
    # deaths and re-draws the same code.
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
    # Rank 0 samples and decodes; the others take w from its broadcast
    # and need only the assignment.
    runtime = None
    if decoder:
        runtime = coded_train.CodingRuntime(coding, m_workers,
                                            mask_source=mask_source,
                                            adaptive=adaptive, device=dev)
        assignment = runtime.assignment
    else:
        assignment = coded_train.make_assignment(coding, m_workers)
    lookahead = max(1, args.lookahead)
    log_every = args.log_every or max(1, args.steps // 10)
    source = SyntheticLM(cfg.vocab_size, args.seq_len, seed=args.seed)

    params = M.init_params(cfg, seed=args.seed, device=dev)
    optimizer = opt_mod.get_optimizer("adamw", args.lr)
    opt_state = optimizer.init(params)
    compress = None if args.compress == "none" else args.compress
    comp_rows = assignment.n if dedup else m_workers
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
    # Placement on the ranks: the model axis's shards
    # (``safe_param_specs``), FSDP's shards of those over the data axis,
    # and the residual keeps this rank's rows (all of them where the rows
    # stay whole) of its model shards.
    shapes = T.map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                         device="meta"), params)
    shards = (tensor_parallel.ModelShards(shapes, workers)
              if workers.model_size > 1 else None)
    if shards is not None:
        params = shards.shard(params)
        opt_state = {k: (shards.shard(v) if k in ("m", "v") else v)
                     for k, v in opt_state.items()}
        if compress:
            comp_state = {"residual": shards.shard(comp_state["residual"],
                                                   lead=1)}
    fsdp = FSDP(shapes, workers) if args.fsdp else None
    if fsdp is not None:
        params = fsdp.shard(params)
        opt_state = fsdp.opt_shard(opt_state)

    def rows_split() -> bool:
        return workers.distributed and (
            not dedup or pg.block_rows_split(comp_rows, workers.size))

    def rank_residual(state):
        if not rows_split():
            return state
        return {"residual": T.map(
            lambda x: x.clone(memory_format=torch.contiguous_format),
            pg.rank_rows(state["residual"], workers.size, workers.rank))}

    if compress:
        comp_state = rank_residual(comp_state)
    resident = {"params": resident_bytes(params),
                "opt_state": resident_bytes(opt_state),
                "params_expected": bytes_per_device(
                    shapes, (fsdp.specs if fsdp is not None else
                             safe_param_specs(shapes, workers.layout)),
                    workers.layout)}

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
        # every rank joins the gathers; rank 0 writes the whole tensors
        state = {"params": params, "opt_state": opt_state}
        if fsdp is not None:
            state = {"params": fsdp.gather(params),
                     "opt_state": fsdp.opt_gather(opt_state)}
        if shards is not None:
            state = {"params": shards.gather_tree(state["params"]),
                     "opt_state": {k: (shards.gather_tree(v)
                                       if k in ("m", "v") else v)
                                   for k, v in state["opt_state"].items()}}
        if compress:
            resid = (pg.gather_rows(comp_state["residual"], workers)
                     if rows_split() else comp_state["residual"])
            if shards is not None:
                resid = shards.gather_tree(resid, lead=1)
            state["compress"] = {"residual": resid}
        if lead:
            ckpt.save(args.ckpt_dir, state, step=step)
            print(f"saved step-{step} checkpoint to {args.ckpt_dir}")

    pool = ThreadPoolExecutor(max_workers=1)
    generation = 0
    step = start
    rebuild_started = None
    traffic0 = dict(pg.traffic)
    t0 = time.time()
    try:
        # One generation per code: the batcher and the step are built
        # anew when a re-assignment changes the assignment. Without
        # --chaos there is one generation.
        while step < args.steps:
            global_batch = assignment.n * args.block_size
            batcher = CodedBatcher(assignment, shuffle_seed=args.seed)
            emit = batcher.unique_blocks if dedup else batcher.code_batch

            def host_batch(s, _emit=emit, _gb=global_batch):
                return _emit(source.batch(_gb, s))

            alpha_w = coded_train.alpha_bar_weights(assignment)
            if args.collective == "manual":
                train_step = coded_train.make_manual_collective_train_step(
                    cfg, optimizer, alpha_weights=alpha_w,
                    compress=compress,
                    streaming_chunk=args.stream_chunk or None,
                    workers=workers, fsdp=fsdp, shards=shards)
            else:
                train_step = coded_train.make_train_step(
                    cfg, optimizer, n_microbatches=args.microbatches,
                    dedup=dedup,
                    norm_scale=coded_train.dedup_norm_scale(assignment),
                    alpha_weights=alpha_w, compress=compress,
                    workers=workers, fsdp=fsdp, shards=shards)
            batch_np = host_batch(step)
            if compress and generation > 0:
                # the residual's rows follow the re-drawn block axis,
                # re-split over the ranks; leaves keep the whole
                # parameter shapes (FSDP shards only params and moments)
                comp_rows = assignment.n if dedup else assignment.m
                comp_state = rank_residual({"residual": T.map(
                    lambda r: torch.zeros((comp_rows,) + tuple(r.shape[1:]),
                                          dtype=r.dtype, device=r.device),
                    comp_state["residual"])})
            if rebuild_started is not None:
                reassignments[-1]["rebuild_s"] = round(
                    time.time() - rebuild_started, 3)
                rebuild_started = None
            # Observed masks (chaos) decode per step: a mask is not
            # known before its heartbeats.
            lookahead_w = None
            if decoder and not args.chaos:
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
                alive = None
                if args.chaos:
                    observed = monitor.observe(
                        step, injector.completion_times(step))
                    if decoder:
                        runtime.mask_source.push(surv.localize(observed))
                        w, alive = runtime.step_weights()
                elif decoder:
                    w, alive = lookahead_w.next()
                if workers.distributed:
                    w = _shared_weights(w if decoder else None, assignment.m,
                                        workers, dev)
                wv = sw.block_weights(assignment, w) if dedup else w
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
                    if lead:
                        print(f"step {step:4d} loss {losses[-1]:.4f} "
                              f"stragglers {int((~alive).sum())}/"
                              f"{assignment.m} "
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
                        if lead:
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
                # the others derive the same code (elastic_coding is a
                # pure function) and need only its assignment
                coding = coded_train.elastic_coding(
                    coding, surv.alive_count, generation)
                if decoder:
                    runtime = coded_train.elastic_reassign(
                        runtime, local, generation=generation,
                        mask_source=sw.ObservedMaskSource(
                            surv.alive_count))
                    assignment = runtime.assignment
                else:
                    assignment = coded_train.make_assignment(
                        coding, surv.alive_count)
                info = {"step": int(step), "generation": int(generation),
                        "dead": [int(d) for d in reassign_dead],
                        "survivors": surv.survivors.tolist(),
                        "m": surv.alive_count,
                        "scheme": coding.scheme,
                        "replication": int(coding.replication),
                        "n_blocks": int(assignment.n),
                        "rebuild_s": None}
                reassignments.append(info)
                all_events.append(
                    {"step": int(step), "kind": "reassign", "machine": -1,
                     "detail": {k: v for k, v in info.items()
                                if k != "step"}})
                if lead:
                    print(f"step {step}: elastic re-assignment over "
                          f"m={surv.alive_count} survivors (generation "
                          f"{generation}, d={coding.replication})")
        flush_metrics()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.time() - t0
        if args.ckpt_dir:
            save_ckpt(args.steps)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    traffic = {k: pg.traffic[k] - traffic0[k] for k in traffic0}
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
        if args.event_log and lead:
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
               "stream_chunk": args.stream_chunk, "fsdp": args.fsdp,
               "world_size": workers.size,
               "layout": dict(workers.layout.shape),
               "comm_bytes_per_step": comm_bytes,
               "comm_bytes_per_step_float32": comm_bytes_f32,
               "decode_calls": runtime.decode_calls if decoder else 0,
               "chaos": chaos_summary,
               "resident_bytes": resident,
               "collective_bytes_per_step": {
                   k: v / max(1, args.steps - start)
                   for k, v in traffic.items()},
               "device": (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu"),
               "loop_s": wall}
    if runtime is not None and runtime.policy is not None:
        est = runtime.estimator.estimate()
        summary["adaptive"] = {
            "policy": args.adaptive,
            "p_hat": est.p_hat,
            "persistence_hat": est.persistence_hat,
            "decision_counts": dict(runtime.decision_counts),
        }
    if lead:
        print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
