"""Coded training on one device: the paper's update, for real.

Port of ``repro.dist.coded_train``. The parameter-server view
(Glasgow & Wootters, Algorithm 2) is

    theta <- theta - eta * sum_j w*_j g_j

over m coded workers, where g_j is worker j's sum of assigned block
gradients and w* comes from the O(m) optimal decoder applied to this
round's straggler mask. The coded batch carries a leading machine axis
of size m (``data.pipeline.CodedBatcher``); the weighted loss

    L(theta) = (1/N) sum_j w_j sum_l block_weight_{jl} * L_{jl}(theta)

is linear in w, so its autograd gradient IS the combine sum_j w_j g_j.

The same four execution models as the reference, on one device:

* replicated machines (``coded_loss_fn``): every block computed d
  times, once per machine that holds it;
* dedup blocks (``coded_loss_fn_dedup``): each unique block once,
  weighted by v = A @ w, the same gradient at ~1x the uncoded work;
* the compressed combine (``make_train_step(compress=...)``): per-row
  (machine or block) gradients quantized with error feedback and
  combined on the payload by the ``quantized_combine`` /
  ``packed_sign_combine`` kernels;
* the manual collective (``make_manual_collective_train_step``): the
  per-machine gradients materialised and reduced explicitly by the
  ``coded_combine`` kernel (``coded_allreduce``).

Every step runs on a group of W worker ranks (``dist.process_group``;
W = 1 without one). Each rank takes its block of the coded batch's
leading machine axis, machines ``[r*m/W, (r+1)*m/W)`` (or of the dedup
path's block axis, which falls back to all blocks on every rank when n
is not a multiple of W), and the partial combines are summed across the
ranks by one float32 ``all_reduce`` -- the reference's ``shard_map`` +
``psum`` over its worker axes. The manual collective can stream its
combine over machine chunks (``streaming_chunk``), and ``dist.fsdp``
shards the parameters and AdamW's moments over the ranks. With W = 1
every step computes what it computes without a group, bit for bit.

On a (data, model) layout each rank also holds only its model shards
(``dist.tensor_parallel``; pass ``shards``, a ``ModelShards``): the step
runs the model on its model group, the compressed codecs' row scales are
those of the whole rows (reduced over the model group, so K4 and K5
combine a rank's block of each whole row's payload), and the gradient
norm counts a split leaf's shards once each.

Per-row gradients (the reference's ``jax.vmap(jax.value_and_grad)``)
are one backward pass per row, written into a preallocated (rows, ...)
stack per leaf: rows are independent, so this computes the same
gradients and holds one row's activations at a time.

Host side, ``CodingRuntime`` draws one alive mask per step from its
``MaskSource``, decodes it through ``core.step_weights`` (or through the
decoder an adaptive policy picks for the step) and memoises repeated
masks; ``weights_lookahead`` decodes a horizon of masks in one batch,
and ``LookaheadPrefetcher`` runs it on the driver's worker thread,
bit-identically to the per-step stream. ``make_assignment`` builds any
scheme of the zoo. After permanent deaths ``elastic_reassign`` re-draws
the code over the survivors (``elastic_coding``, seeded by
``elastic_seed``), as the reference's chaos path does.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs import CodingConfig, ModelConfig
from repro_torch.core import compress as compress_mod
from repro_torch.core import step_weights as sw
from repro_torch.core.adaptive import (DecodingPolicy,
                                       OnlineStragglerEstimator,
                                       PolicyDecision, make_policy)
from repro_torch.core.assignment import (Assignment, bibd_assignment,
                                         cyclic_mds_assignment,
                                         expander_assignment,
                                         frc_assignment,
                                         random_matching_assignment,
                                         uncoded_assignment)
from repro_torch.dist import process_group as pg
from repro_torch.dist import tensor_parallel as tp
from repro_torch.kernels.coded_combine import ops as cc_ops
from repro_torch.models import model as M
from repro_torch.optim import optimizers as opt_mod
from repro_torch.spans import span


# ---------------------------------------------------------------------------
# Coded losses and gradients
# ---------------------------------------------------------------------------


def coded_loss_fn(params, coded_batch: Dict[str, torch.Tensor],
                  w: torch.Tensor, cfg: ModelConfig,
                  norm: Optional[float] = None) -> torch.Tensor:
    """Per-block weighted coded loss; grad == sum_j w_j g_j (Eq. 1).

    coded_batch leaves are (m, load, bs, ...) with a ``block_weight``
    (m, load) mask (0 on padding slots of irregular assignments); w is
    the (m,) decoding weights. The machine, load and batch axes flatten
    into one forward pass. ``norm`` overrides the normaliser (default:
    this batch's label count; a rank passes the whole batch's).
    """
    bw = coded_batch["block_weight"]
    m, load = bw.shape
    flat = {k: v.reshape((-1,) + tuple(v.shape[3:]))
            for k, v in coded_batch.items() if k != "block_weight"}
    per_seq = M.train_loss(params, flat, cfg, per_example=True)
    per_block = per_seq.reshape(m, load, -1).sum(dim=2)
    if norm is None:
        norm = coded_batch["labels"].numel()
    return (w[:, None] * bw * per_block).sum() / norm


def coded_loss_fn_dedup(params, block_batch: Dict[str, torch.Tensor],
                        v: torch.Tensor, cfg: ModelConfig,
                        norm_scale: float = 1.0,
                        norm: Optional[float] = None) -> torch.Tensor:
    """Per-unique-block weighted coded loss; grad == sum_j w_j g_j.

    block_batch leaves are (n, block_rows, ...) unique blocks
    (``CodedBatcher.unique_blocks``); v is the (n,) per-block weights
    A @ w. ``norm_scale = dedup_norm_scale(assignment)`` makes the loss
    value equal the replicated path's, not only its gradient; ``norm``
    overrides the whole normaliser, as in ``coded_loss_fn``.
    """
    labels = block_batch["labels"]
    n = labels.shape[0]
    flat = {k: x.reshape((-1,) + tuple(x.shape[2:]))
            for k, x in block_batch.items()}
    per_seq = M.train_loss(params, flat, cfg, per_example=True)
    per_block = per_seq.reshape(n, -1).sum(dim=1)
    if norm is None:
        norm = labels.numel() * norm_scale
    return (v * per_block).sum() / norm


def dedup_norm_scale(assignment: Assignment) -> float:
    """m*load/n: aligns the dedup loss normalisation with the replicated
    batch's (padded) label count."""
    return assignment.m * assignment.load / assignment.n


def value_and_grad(loss_fn: Callable, params):
    """(loss, grads) of ``loss_fn(params)``; grads is a tree like
    ``params``. The parameters themselves are left untouched: the
    forward runs on detached views that require grad. A parameter the
    loss does not read (the audio family's encoder on a batch with no
    ``src``) gets a zero gradient, as ``jax.grad`` gives it. It runs in
    the ``forward_backward`` span."""
    with span("forward_backward"):
        return _value_and_grad(loss_fn, params)


def _value_and_grad(loss_fn: Callable, params):
    live = T.map(lambda p: p.detach().requires_grad_(True), params)
    leaves = T.leaves(live)
    with torch.enable_grad():
        loss = loss_fn(live)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), T.like(params, grads)


def _per_row_values_and_grads(params, rows: int, row_loss: Callable):
    """(losses (rows,), grads tree with a leading rows axis): one
    backward pass per row, ``row_loss(params, i)``, each written into a
    preallocated stack per leaf, in the row's ``forward_backward``
    span."""
    leaves = T.leaves(params)
    dev = leaves[0].device
    stacks = [torch.empty((rows,) + tuple(p.shape), dtype=p.dtype,
                          device=dev) for p in leaves]
    losses = torch.empty(rows, dtype=torch.float32, device=dev)
    for i in range(rows):
        with span("forward_backward"):
            loss, grads = _value_and_grad(lambda p: row_loss(p, i), params)
            losses[i] = loss
            for s, g in zip(stacks, T.leaves(grads)):
                s[i].copy_(g)
            del grads
    return losses, T.like(params, stacks)


def _per_machine_values_and_grads(params, batch, cfg, norm=None):
    """Per-machine (loss_j, g_j) over the replicated (m, load, ...)
    batch: the materialised form the manual collective and the
    compressed replicated path reduce. ``norm`` overrides the loss
    normaliser (default: the whole batch's label count)."""
    bw = batch["block_weight"]
    m, load = bw.shape
    if norm is None:
        norm = batch["labels"].numel()
    data = {k: v for k, v in batch.items() if k != "block_weight"}

    def machine_loss(p, j):
        flat = {k: x[j].reshape((-1,) + tuple(x.shape[3:]))
                for k, x in data.items()}
        per_seq = M.train_loss(p, flat, cfg, per_example=True)
        per_block = per_seq.reshape(load, -1).sum(dim=1)
        return (bw[j] * per_block).sum() / norm

    return _per_row_values_and_grads(params, m, machine_loss)


def _split(tree_of_tuples, k: int):
    return [T.map(lambda t: t[i], tree_of_tuples) for i in range(k)]


def _quantize_rows(grads, residual, codec, error_feedback: bool,
                   shards=None):
    """Row-wise quantize of g (+ residual) per leaf, flat payloads.

    Returns (q_tree, scale_tree, new_residual_tree, shapes_tree): payload
    leaves are flat (rows, D) -- (rows, ceil(D/8)) for a packed codec --
    and ``shapes_tree`` holds each leaf's combined-output shape. Under
    ``shards`` a split leaf's rows are its model block, and its scales
    are the whole rows' (``tensor_parallel.row_across``).
    """
    split = ({} if shards is None or shards.size == 1 else
             {i: shards.widths[i] for i in shards.split_leaves()})
    widths = T.like(grads, [split.get(i) for i in
                            range(len(T.leaves(grads)))])

    def one(g, r, width):
        rows = g.shape[0]
        flat = g.reshape(rows, -1).float()
        pre = flat + r.reshape(rows, -1) if error_feedback else flat
        q, s = codec.compress(pre, None if width is None else
                              tp.row_across(shards.model, width))
        new_r = ((pre - codec.decompress(q, s, d=flat.shape[1]))
                 .reshape(g.shape) if error_feedback else r)
        return q, s, new_r, tuple(g.shape[1:])
    return _split(T.map(one, grads, residual, widths), 4)


def compress_combine_tree(grads, residual, w, codec, *,
                          error_feedback: bool = True, shards=None):
    """Quantize per-row gradients and run the fused combine per leaf.

    ``grads`` leaves carry a leading row axis (m machines or n unique
    blocks, or this rank's block of them), ``residual`` is the matching
    error-feedback tree and ``w`` the rows' weights (machine w or block
    v = A @ w). Per leaf: compress ``g + e`` row-wise, combine the
    payload through ``quantized_combine`` (or ``packed_sign_combine``
    for a packed codec), and keep ``e' = (g + e) - dequant``. Returns
    (combined float32 tree, new residual tree).
    """
    q, s, new_r, shapes = _quantize_rows(grads, residual, codec,
                                         error_feedback, shards)
    return _compressed_allreduce(q, s, w, codec, shapes), new_r


# ---------------------------------------------------------------------------
# The coded allreduces over the worker group
# ---------------------------------------------------------------------------


def _sum_over(tree, workers):
    """One float32 ``all_reduce`` (SUM) per leaf over the worker ranks,
    in place; the identity with no group or W = 1."""
    if workers is not None and workers.distributed:
        for x in T.leaves(tree):
            workers.all_reduce_(x)
    return tree


def coded_allreduce(grads, w: torch.Tensor, workers=None):
    """The paper combine ``sum_j w_j g_j`` as an explicit collective
    (the reference's ``_coded_psum_allreduce``): the leaves carry this
    rank's (m/W, ...) machine rows and ``w`` their weights; the
    ``coded_combine`` kernel reduces the local rows, one launch per
    leaf, and one float32 ``all_reduce`` over ``workers`` sums the
    partial combines. With no group (or W = 1) it is the local combine
    alone, over all m rows."""
    return _sum_over(cc_ops.coded_combine_tree(grads, w), workers)


def quantized_coded_allreduce(q_tree, scale_tree, w: torch.Tensor,
                              workers=None):
    """``coded_allreduce`` carrying the quantized payload: (rows, D) int8
    (or float32) leaves with (rows,) scales, reduced locally by
    ``quantized_combine``, so what a machine hands the combine is the
    codec's wire payload; the partial combines are summed in float32."""
    return _sum_over(cc_ops.quantized_combine_tree(q_tree, scale_tree, w),
                     workers)


def packed_sign_coded_allreduce(q_tree, scale_tree, w: torch.Tensor,
                                shapes, workers=None):
    """``coded_allreduce`` carrying the 1-bit packed sign payload (1/32
    of the float32 bytes), reduced locally by ``packed_sign_combine``;
    ``shapes`` is the tree of combined-output shapes."""
    return _sum_over(cc_ops.packed_sign_combine_tree(q_tree, scale_tree, w,
                                                     shapes), workers)


def _compressed_allreduce(q_tree, scale_tree, w, codec, shapes,
                          workers=None):
    """Codec-dispatching combine over flat row payloads."""
    if codec.packed:
        return packed_sign_coded_allreduce(q_tree, scale_tree, w, shapes,
                                           workers)
    out = quantized_coded_allreduce(q_tree, scale_tree, w, workers)
    return T.map(lambda x, s: x.reshape(s), out, shapes)


def _n_worker_shards(workers) -> int:
    """W: the worker ranks the machine axis is block-split over."""
    return 1 if workers is None else workers.size


def _to_stream_chunks(leaf, n_shards: int, chunk: int):
    """(m, ...) -> (T, n_shards * chunk, ...) machine regrouping.

    The machine axis is block-split over the worker ranks (rank s owns
    machines [s*m/W, (s+1)*m/W)), so a loop over contiguous machine
    chunks would serialise the ranks. This regrouping makes step t carry
    ``chunk`` consecutive machines *from every rank*, and the slice's
    leading axis stays block-contiguous per rank: rank s's machines of
    step t are slots [s*chunk, (s+1)*chunk).
    """
    m = leaf.shape[0]
    per = m // n_shards
    x = leaf.reshape((n_shards, per // chunk, chunk) + tuple(leaf.shape[1:]))
    x = torch.movedim(x, 1, 0)
    return x.reshape((per // chunk, n_shards * chunk)
                     + tuple(leaf.shape[1:]))


def _from_stream_chunks(leaf, n_shards: int, chunk: int):
    """(T, n_shards * chunk, ...) -> (m, ...): the exact inverse of
    ``_to_stream_chunks`` (the residual's way home)."""
    t = leaf.shape[0]
    x = leaf.reshape((t, n_shards, chunk) + tuple(leaf.shape[2:]))
    x = torch.movedim(x, 0, 1)
    return x.reshape((n_shards * t * chunk,) + tuple(leaf.shape[2:]))


def _rank_share(batch, w, workers, *, blocks: bool):
    """(this rank's rows of ``batch``, of ``w``, whether the rows are
    split across ranks). Machine rows must split over W; the dedup
    path's blocks (``blocks``) stay whole on every rank when they do
    not (``process_group.block_rows_split``)."""
    size = _n_worker_shards(workers)
    n = int(w.shape[0])
    if size == 1 or (blocks and not pg.block_rows_split(n, size)):
        return batch, w, False
    if n % size:
        raise ValueError(f"m = {n} machines do not split over {size} "
                         "worker ranks")
    rows = pg.row_block(n, size, workers.rank)
    # a fresh w: the combine kernels take 16-byte aligned weights
    return {k: v[rows] for k, v in batch.items()}, w[rows].clone(), True


def _cross_rank(grads, workers, split: bool, fsdp):
    """Finish the cross-rank sum of this rank's partial gradients: under
    FSDP the reduce-scatter to this rank's shards, else one all_reduce
    when the rows were split (whole rows need no sum)."""
    with span("allreduce"):
        if fsdp is not None:
            return fsdp.reduce(grads, summed=not split)
        return _sum_over(grads, workers) if split else grads


def _sum_loss(loss, workers, split: bool):
    with span("allreduce"):
        if split:
            loss = loss.reshape(1).clone()
            workers.all_reduce_(loss)
            loss = loss.reshape(())
    return loss


def alpha_bar_weights(assignment: Assignment) -> np.ndarray:
    """(m,) vector a with a . w == mean(A @ w): the on-device form of the
    alpha-bar debias divisor (colsum(A)/n)."""
    return (assignment.A.sum(axis=0) / assignment.n).astype(np.float32)


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------


def _finisher(optimizer, alpha_weights, dedup: bool, fsdp=None,
              shards=None):
    """The shared tail of every step: optimizer update (on this rank's
    shards under FSDP or a model group), then metrics (loss, grad_norm,
    extras, alpha_bar) kept on the device."""
    aw = (None if alpha_weights is None
          else torch.as_tensor(np.asarray(alpha_weights, np.float32)))
    if fsdp is None and (shards is None or shards.size == 1):
        norm_of = opt_mod.global_norm
    else:
        def norm_of(grads):
            return tp.global_norm(grads, shards, fsdp)

    def finish(params, opt_state, loss, grads, w, extra=None):
        with span("optimizer"):
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = opt_mod.apply_updates(params, updates)
        with span("step_metrics"):
            metrics = {"loss": loss, "grad_norm": norm_of(grads)}
            if extra:
                metrics.update(extra)
            if dedup:
                metrics["alpha_bar"] = w.mean()
            elif aw is not None:
                metrics["alpha_bar"] = torch.dot(aw.to(w.device), w)
        return params, opt_state, metrics

    return finish


def _comm_metric(codec, w, params):
    comm = compress_mod.comm_bytes_per_step(codec, int(w.shape[0]), params)
    return {"comm_bytes": torch.tensor(float(comm), device=w.device)}


def _full(params, fsdp):
    """The parameters for the forward: gathered over the data ranks
    under FSDP (a model group's ranks keep their model blocks)."""
    return params if fsdp is None else fsdp.gather(params)


def _on_model_group(step, workers):
    """``step`` run on ``workers``' model group
    (``tensor_parallel.executing``); as it is at model = 1."""
    model = None if workers is None else workers.model
    if model is None or model.size == 1:
        return step

    @functools.wraps(step)
    def run(*args, **kw):
        with tp.executing(model):
            return step(*args, **kw)
    return run


def make_train_step(cfg: ModelConfig, optimizer: opt_mod.Optimizer,
                    n_microbatches: int = 1, *, dedup: bool = False,
                    norm_scale: float = 1.0, alpha_weights=None,
                    compress=None, error_feedback: bool = True,
                    workers=None, fsdp=None, shards=None):
    """(params, opt_state, coded_batch, w) -> (params, opt_state,
    metrics).

    ``n_microbatches`` > 1 accumulates float32 gradients over equal
    splits of the per-block batch axis; the mean equals the single-shot
    step. ``dedup=True`` takes ``CodedBatcher.unique_blocks`` output and
    per-block weights v = A @ w (pass ``norm_scale=dedup_norm_scale(A)``).
    Metrics stay on the device: loss, grad_norm and alpha_bar
    (``mean(v)`` on the dedup path, ``alpha_weights . w`` otherwise).

    ``compress`` (a ``core.compress`` codec name or Codec) switches to
    the compressed combine: ``(params, opt_state, comp_state, batch, w)
    -> (params, opt_state, comp_state, metrics)``, with per-row
    gradients quantized with error feedback and combined on the payload;
    metrics gain ``comm_bytes``. It does not compose with microbatches.

    ``workers`` (a ``process_group.Workers``) runs the step on W ranks:
    every rank passes the whole batch and w, computes the gradient of
    its rows and the ranks sum them; the residual state then holds this
    rank's rows only. ``fsdp`` (a ``dist.fsdp.FSDP`` over the same
    workers) takes and returns this rank's shards of the parameters and
    of the optimizer state. On a layout with a model axis ``shards`` (a
    ``tensor_parallel.ModelShards``) places the parameters, and the step
    runs on ``workers.model``.
    """
    nm = int(n_microbatches)
    if nm < 1:
        raise ValueError("n_microbatches must be >= 1")
    finish = _finisher(optimizer, alpha_weights, dedup, fsdp, shards)

    if compress is not None:
        if nm != 1:
            raise ValueError("compress does not compose with "
                             "n_microbatches > 1")
        codec = compress_mod.get_codec(compress)

        def compressed_step(params, opt_state, comp_state, batch, w):
            full = _full(params, fsdp)
            local, w_l, split = _rank_share(batch, w, workers,
                                            blocks=dedup)
            if dedup:
                norm = batch["labels"].numel() * norm_scale

                def block_loss(p, i):
                    blk = {k: v[i] for k, v in local.items()}
                    return M.train_loss(p, blk, cfg,
                                        per_example=True).sum() / norm

                losses, grads = _per_row_values_and_grads(
                    full, local["labels"].shape[0], block_loss)
            else:
                losses, grads = _per_machine_values_and_grads(
                    full, local, cfg, norm=batch["labels"].numel())
            del full
            loss = _sum_loss((w_l * losses).sum(), workers, split)
            with span("combine"):
                combined, new_resid = compress_combine_tree(
                    grads, comp_state["residual"], w_l, codec,
                    error_feedback=error_feedback, shards=shards)
            del grads
            combined = _cross_rank(combined, workers, split, fsdp)
            params, opt_state, metrics = finish(
                params, opt_state, loss, combined, w,
                extra=_comm_metric(codec, w, params))
            return params, opt_state, {"residual": new_resid}, metrics

        return _on_model_group(compressed_step, workers)

    def loss_fn(p, b, wv, norm):
        if dedup:
            return coded_loss_fn_dedup(p, b, wv, cfg, norm=norm)
        return coded_loss_fn(p, b, wv, cfg, norm=norm)

    def norm_of(labels: int):
        # the whole batch's normaliser (every rank's rows), or one
        # microbatch's share of it
        return labels * norm_scale if dedup else labels

    def step(params, opt_state, batch, w):
        norm = norm_of(batch["labels"].numel())
        full = _full(params, fsdp)
        local, w_l, split = _rank_share(batch, w, workers, blocks=dedup)
        if nm == 1:
            loss, grads = value_and_grad(
                lambda p: loss_fn(p, local, w_l, norm), full)
        else:
            # microbatch split along the per-block batch axis:
            # replicated leaves are (m, load, bs, ...), dedup (n, bs, ...)
            bax = 1 if dedup else 2

            def micro(leaf, i):
                bs_ = leaf.shape[bax]
                if bs_ % nm:
                    raise ValueError(f"block batch {bs_} not divisible "
                                     f"by {nm} microbatches")
                return leaf.narrow(bax, i * (bs_ // nm), bs_ // nm)

            grads = T.map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), full)
            loss = torch.zeros((), dtype=torch.float32, device=w.device)
            norm = norm_of(batch["labels"].numel() // nm)
            for i in range(nm):
                mb = {k: micro(v, i) for k, v in local.items()
                      if k != "block_weight"}
                if not dedup:
                    mb["block_weight"] = local["block_weight"]
                l_i, g_i = value_and_grad(
                    lambda p: loss_fn(p, mb, w_l, norm), full)
                grads = T.map(torch.add, grads, g_i)
                loss = loss + l_i
            grads = T.map(lambda g: g / nm, grads)
            loss = loss / nm
        del full
        grads = _cross_rank(grads, workers, split, fsdp)
        loss = _sum_loss(loss, workers, split)
        return finish(params, opt_state, loss, grads, w)

    return _on_model_group(step, workers)


def make_manual_collective_train_step(cfg: ModelConfig,
                                      optimizer: opt_mod.Optimizer,
                                      alpha_weights=None, compress=None,
                                      error_feedback: bool = True,
                                      streaming_chunk: Optional[int]
                                      = None, *, workers=None,
                                      fsdp=None, shards=None):
    """Replicated-path train step whose combine is the explicit
    ``coded_allreduce`` instead of autograd's fused one: each rank's
    per-machine gradients g_j are materialised (m/W x the gradient
    memory), reduced by the ``coded_combine`` kernel, and summed across
    the ranks. ``compress`` quantizes them (with error feedback) before
    the combine, which then runs on the payload; the step's signature
    then carries the residual state (this rank's m/W machine rows) as
    its third argument, as in ``make_train_step``.

    ``streaming_chunk`` bounds how many per-machine gradients are live
    at once: a loop over T = m / (W * chunk) steps takes ``chunk``
    machines of every rank per step (``_to_stream_chunks``), combines
    them (quantizing first under ``compress``) and accumulates into one
    float32 tree; the residual chunks go back to machine order through
    ``_from_stream_chunks``. The combine is linear in the g_j, so
    streaming only reassociates the sum. The ranks sum their
    accumulators once, after the last chunk, where the reference's scan
    runs its psum per chunk: the same sum, reassociated, at 1/T of the
    bytes. It needs m divisible by W * chunk. Without it the step is
    the same loop over one chunk of all m/W rows.
    """
    codec = (None if compress is None
             else compress_mod.get_codec(compress))
    finish = _finisher(optimizer, alpha_weights, dedup=False, fsdp=fsdp,
                       shards=shards)
    chunk = None
    if streaming_chunk is not None:
        chunk = int(streaming_chunk)
        if chunk < 1:
            raise ValueError("streaming_chunk must be >= 1")

    def combine(params, batch, w, residual):
        n_shards = _n_worker_shards(workers)
        m = int(w.shape[0])
        if m % n_shards:
            raise ValueError(f"m = {m} machines do not split over "
                             f"{n_shards} worker ranks")
        # materialising is the loop over one chunk of all m/W rows
        c = m // n_shards if chunk is None else chunk
        if m % (n_shards * c):
            raise ValueError(
                f"streaming needs m divisible by worker ranks x chunk = "
                f"{n_shards} x {c}, got m={m}")
        n_steps = m // (n_shards * c)
        rank = 0 if workers is None else workers.rank
        mine = slice(rank * c, (rank + 1) * c)
        norm = batch["labels"].numel()
        b_xs = {k: _to_stream_chunks(v, n_shards, c)
                for k, v in batch.items()}
        w_xs = _to_stream_chunks(w, n_shards, c)
        full = _full(params, fsdp)
        g_acc = l_acc = r_xs = r_ys = None
        if residual is not None:
            # this rank's m/W rows as (T, chunk, ...) views; over more
            # than one chunk the new residual is written chunk by chunk
            # in the same layout
            r_xs = T.map(lambda x: _to_stream_chunks(x, 1, c), residual)
            if n_steps > 1:
                r_ys = T.map(torch.empty_like, r_xs)
        for t in range(n_steps):
            cb = {k: v[t, mine] for k, v in b_xs.items()}
            w_c = w_xs[t, mine].clone()       # aligned for the kernels
            losses, grads = _per_machine_values_and_grads(full, cb, cfg,
                                                          norm=norm)
            # the chunk's stack goes before the next chunk's is made
            with span("combine"):
                if codec is None:
                    contrib = coded_allreduce(grads, w_c)
                    del grads
                else:
                    q_t, s_t, new_r, shapes = _quantize_rows(
                        grads, T.map(lambda x: x[t], r_xs), codec,
                        error_feedback, shards)
                    del grads
                    if r_ys is None:      # the only chunk: no copy
                        r_ys = T.map(lambda r: r.unsqueeze(0), new_r)
                    else:
                        T.map(lambda y, r: y[t].copy_(r), r_ys, new_r)
                    del new_r
                    contrib = _compressed_allreduce(q_t, s_t, w_c, codec,
                                                    shapes)
                    del q_t, s_t
                # the first contribution seeds the float32 accumulator
                # (no copy for float32 gradients)
                g_acc = (T.map(torch.Tensor.float, contrib)
                         if g_acc is None
                         else T.map(torch.Tensor.add_, g_acc, contrib))
                l_i = (w_c * losses).sum()
                l_acc = l_i if l_acc is None else l_acc + l_i
                del contrib
        del full
        split = n_shards > 1
        grads = _cross_rank(g_acc, workers, split, fsdp)
        loss = _sum_loss(l_acc, workers, split)
        new_resid = (None if r_ys is None else
                     T.map(lambda y: _from_stream_chunks(y, 1, c), r_ys))
        return grads, loss, new_resid

    if codec is not None:
        def compressed_step(params, opt_state, comp_state, batch, w):
            grads, loss, new_resid = combine(params, batch, w,
                                             comp_state["residual"])
            params, opt_state, metrics = finish(
                params, opt_state, loss, grads, w,
                extra=_comm_metric(codec, w, params))
            return params, opt_state, {"residual": new_resid}, metrics

        return _on_model_group(compressed_step, workers)

    def step(params, opt_state, batch, w):
        grads, loss, _ = combine(params, batch, w, None)
        return finish(params, opt_state, loss, grads, w)

    return _on_model_group(step, workers)


# ---------------------------------------------------------------------------
# Serving and the host-side coding runtime
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig):
    """(params, batch) -> last-position logits (B, V_pad); the batch may
    carry a vlm ``prefix`` and an audio ``src``."""
    def step(params, batch):
        return M.prefill(params, batch["tokens"], cfg,
                         prefix=batch.get("prefix"), src=batch.get("src"))
    return step


def make_serve_step(cfg: ModelConfig, window: Optional[int] = None):
    """(params, token, cache) -> (logits, cache)."""
    def step(params, token, cache):
        return M.decode_step(params, token, cache, cfg, window=window)
    return step


def make_assignment(coding: CodingConfig, m: int) -> Assignment:
    """Instantiate the block assignment for m coded workers."""
    if coding.scheme == "expander":
        return expander_assignment(m, coding.replication,
                                   vertex_transitive=True,
                                   seed=coding.seed)
    if coding.scheme == "frc":
        return frc_assignment(m, coding.replication)
    if coding.scheme == "uncoded":
        return uncoded_assignment(m)
    if coding.scheme == "cyclic_mds":
        return cyclic_mds_assignment(m, coding.replication)
    if coding.scheme == "bibd":
        # The design whose machine count is m: the affine plane of order
        # q = r - 1 has q^2 + q = (r-1)r machines, else a symmetric
        # design puts one machine on each point (v = m, k = r).
        r = coding.replication
        if m == (r - 1) * r:
            return bibd_assignment((r - 1) ** 2, r - 1, design="affine")
        return bibd_assignment(m, r, design="symmetric")
    if coding.scheme == "random_regular":
        return random_matching_assignment(m, coding.replication,
                                          seed=coding.seed)
    raise ValueError(f"unknown scheme {coding.scheme!r} "
                     "(expander | frc | uncoded | cyclic_mds | bibd "
                     "| random_regular)")


def elastic_seed(seed: int, generation: int) -> int:
    """The seed of elastic generation ``generation`` of a run seeded
    ``seed``: a pure function, so a running driver's re-assignment and a
    fresh driver launched on the survivors derive the same code."""
    if generation < 0:
        raise ValueError("generation must be >= 0")
    return seed + 1_000_003 * generation


def elastic_coding(coding: CodingConfig, m_new: int,
                   generation: int) -> CodingConfig:
    """The CodingConfig of generation ``generation`` over ``m_new``
    survivors.

    The replication degree degrades to the largest feasible d' <= d
    (the expander needs d | 2m', the FRC d | m'); one survivor, or two
    under the expander, fall back to uncoded. Deterministic, so a fresh
    run on the survivors rebuilds the same assignment."""
    if m_new < 1:
        raise ValueError("need at least one survivor")
    seed = elastic_seed(coding.seed, generation)
    if m_new == 1 or (coding.scheme == "expander" and m_new == 2):
        return dataclasses.replace(coding, scheme="uncoded",
                                   replication=1, seed=seed)
    d = min(coding.replication, m_new)
    if coding.scheme == "expander":
        # d = 2 (the cycle) always divides 2m', so this stops at a
        # valid graph scheme for m' >= 3.
        while d > 2 and (2 * m_new) % d:
            d -= 1
        d = max(d, 2)
    elif coding.scheme == "frc":
        while d > 1 and m_new % d:
            d -= 1
    return dataclasses.replace(coding, replication=d, seed=seed)


def elastic_reassign(runtime: "CodingRuntime", dead, *, generation: int,
                     mask_source: Optional[sw.MaskSource] = None
                     ) -> "CodingRuntime":
    """Re-draw the code over the survivors after permanent deaths.

    ``dead`` holds logical machine ids of ``runtime`` (the driver's
    ``SurvivorMap`` translates original ids). Returns a new
    ``CodingRuntime`` over m' = m - len(dead) machines with the
    generation's coding (``elastic_coding``), a new debias scale and an
    empty decode cache; ``debias``, ``debias_trials``, ``cache_size``,
    ``adaptive`` and ``device`` carry over. Training goes on from the
    live parameters and optimizer state, and the trajectory after the
    death equals a fresh run on the survivors from the same state.
    """
    dead = np.atleast_1d(np.asarray(dead, dtype=np.int64))
    if np.unique(dead).size != dead.size:
        raise ValueError("duplicate dead machine ids")
    if dead.size and (dead.min() < 0 or dead.max() >= runtime.m):
        raise ValueError(f"dead ids {dead.tolist()} out of range for "
                         f"m={runtime.m}")
    m_new = runtime.m - int(dead.size)
    coding = elastic_coding(runtime.coding, m_new, generation)
    return CodingRuntime(coding, m_new, debias=runtime.debias,
                         debias_trials=runtime.debias_trials,
                         cache_size=runtime.cache_size,
                         mask_source=mask_source,
                         adaptive=runtime.adaptive,
                         device=runtime.device)


@dataclasses.dataclass
class CodingRuntime:
    """Host bridge: assignment + straggler process + per-step weights.

    ``step_weights()`` takes this round's alive mask from the mask
    source (by default sampled from the configured straggler model) and
    returns the debiased decoding weights w (w_j = 0 on stragglers),
    memoised by (method, p, mask). The alpha-bar debias scale is
    estimated once at construction: one batched decode of a Bernoulli
    mask batch on ``device`` (``None`` means the card, which that decode
    reaches only at >= 200,000 mask entries), or, for the adversarial
    model, the exact scale of its one fixed mask.

    ``adaptive`` (None | "adaptive" | "always_optimal" | "always_fixed"
    | a ``DecodingPolicy``) makes every round decide its decoder from
    the online straggler estimate before the round's mask is observed,
    then observe it; None keeps the configured ``decoding``.
    """

    coding: CodingConfig
    m: int
    debias: bool = True
    debias_trials: int = 256
    cache_size: int = 4096
    mask_source: Optional[sw.MaskSource] = None
    adaptive: Optional[object] = None
    device: Optional[object] = None

    def __post_init__(self):
        self.assignment = make_assignment(self.coding, self.m)
        self.model = sw.make_straggler_model(
            self.assignment, self.coding.straggler_model,
            self.coding.straggler_p)
        self.rng = np.random.default_rng(self.coding.seed)
        if self.mask_source is None:
            self.mask_source = sw.SampledMaskSource(self.model,
                                                    self.rng, self.m)
        elif self.mask_source.m != self.m:
            raise ValueError(
                f"mask source is over m={self.mask_source.m} machines, "
                f"runtime has m={self.m}")
        self.policy: Optional[DecodingPolicy] = None
        self.estimator: Optional[OnlineStragglerEstimator] = None
        self.last_decision: Optional[PolicyDecision] = None
        self.decision_counts: Dict[str, int] = {}
        if self.adaptive is not None:
            self.policy = make_policy(self.adaptive,
                                      p=self.coding.straggler_p)
            # the configured p is the estimator's prior
            self.estimator = OnlineStragglerEstimator(
                self.m, prior_p=min(max(self.coding.straggler_p, 0.0),
                                    0.99))
        self.scale = 1.0
        # A policy may decode optimally on any step, so it needs the
        # optimal decode's scale, which applies to optimal decodes only.
        if self.debias and (self.coding.decoding == "optimal"
                            or self.policy is not None):
            if self.coding.straggler_model == "adversarial":
                _, alpha = sw.step_weights(
                    self.assignment, self.model.sample(self.rng),
                    method="optimal")
                self.scale = float(
                    np.sqrt(alpha.size) /
                    max(np.linalg.norm(alpha), 1e-30))
            else:
                # Offset seed: the same seed would fit the scale on the
                # run's own first `debias_trials` masks.
                self.scale = sw.debias_scale_mc(
                    self.assignment, p=self.coding.straggler_p,
                    trials=self.debias_trials,
                    seed=self.coding.seed + 0x5EED, device=self.device)
        self._cache: Dict[tuple, np.ndarray] = {}
        self.decode_calls = 0
        self.steps_sampled = 0

    def skip(self, rounds: int) -> None:
        """Fast-forward the mask stream by ``rounds`` rounds without
        decoding (checkpoint resume)."""
        if rounds < 0:
            raise ValueError("rounds must be >= 0")
        self.mask_source.skip(rounds)
        self.steps_sampled += rounds

    def _remember(self, key, w: np.ndarray) -> None:
        if len(self._cache) >= self.cache_size:
            # FIFO eviction: i.i.d. masks at large m never repeat.
            self._cache.pop(next(iter(self._cache)))
        self._cache[key] = w

    def weights_for(self, alive: np.ndarray, *,
                    method: Optional[str] = None,
                    p: Optional[float] = None) -> np.ndarray:
        """Memoised decode of one (m,) alive mask -> w float32.

        ``method`` and ``p`` default to the configured decoding; a
        policy passes its decision. The memo key carries (method, p), so
        two decoders never alias, and the debias scale applies to
        optimal decodes only."""
        alive = np.asarray(alive, dtype=bool)
        if alive.shape != (self.m,):
            raise ValueError(f"mask must be ({self.m},), "
                             f"got {alive.shape}")
        if method is None:
            method = self.coding.decoding
        if p is None:
            p = self.coding.straggler_p
        key = (method, float(p), alive.tobytes())
        w = self._cache.get(key)
        if w is None:
            scale = self.scale if method == "optimal" else 1.0
            w, _ = sw.step_weights(self.assignment, alive, method=method,
                                   p=p, scale=scale)
            w = w.astype(np.float32)
            self._remember(key, w)
            self.decode_calls += 1
        return w

    def _decide(self) -> PolicyDecision:
        """One decision from the estimator's past-only state (decide,
        use, then observe)."""
        decision = self.policy.decide(self.estimator.estimate())
        self.last_decision = decision
        self.decision_counts[decision.method] = \
            self.decision_counts.get(decision.method, 0) + 1
        return decision

    def _policy_weights(self, alive: np.ndarray) -> np.ndarray:
        decision = self._decide()
        w = self.weights_for(alive, method=decision.method, p=decision.p)
        self.estimator.observe(alive)
        return w

    def step_weights(self) -> Tuple[np.ndarray, np.ndarray]:
        """One round: (w (m,) float32, alive (m,) bool)."""
        alive = self.mask_source.next_mask()
        self.steps_sampled += 1
        if self.policy is not None:
            return self._policy_weights(alive), alive
        return self.weights_for(alive), alive

    def suggested_lookahead(self) -> int:
        """The policy's prefetch horizon for the current estimate (>= 1;
        1 without a policy). Consumes no round."""
        if self.policy is None:
            return 1
        return self.policy.decide(self.estimator.estimate()).lookahead

    def decode_batch(self, masks) -> Tuple[np.ndarray, np.ndarray]:
        """Batched (T, m) masks -> (W, alphas)."""
        return sw.batched_step_weights(
            self.assignment, masks, method=self.coding.decoding,
            p=self.coding.straggler_p, scale=self.scale)

    def block_weights(self, w: np.ndarray) -> np.ndarray:
        """Machine weights -> per-block v = A @ w for the dedup step."""
        return sw.block_weights(self.assignment, w).astype(np.float32)

    def weights_lookahead(self, horizon: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """Pre-sample the next ``horizon`` rounds and decode the novel
        masks in one ``decode_batch`` call: (W (horizon, m) float32,
        alive (horizon, m) bool), bit-identical to ``horizon`` calls of
        ``step_weights``. Under a policy each round decides, decodes and
        observes in turn through ``weights_for``, as ``step_weights``
        does."""
        if horizon < 1:
            raise ValueError("horizon must be >= 1")
        alive = np.stack(
            [self.mask_source.next_mask() for _ in range(horizon)])
        self.steps_sampled += horizon
        if self.policy is not None:
            return np.stack([self._policy_weights(a) for a in alive]), alive
        keys = [(self.coding.decoding, float(self.coding.straggler_p),
                 a.tobytes()) for a in alive]
        # This horizon's rows are gathered locally: eviction while
        # inserting novel decodes must not drop a row still needed.
        w_by_key = {k: self._cache[k] for k in keys if k in self._cache}
        novel = {}   # key -> row in the batched decode
        for t, k in enumerate(keys):
            if k not in w_by_key and k not in novel:
                novel[k] = t
        if novel:
            W_new, _ = self.decode_batch(alive[sorted(novel.values())])
            self.decode_calls += len(novel)
            for k, w_new in zip(sorted(novel, key=novel.get), W_new):
                w_by_key[k] = w_new.astype(np.float32)
                self._remember(k, w_by_key[k])
        W = np.stack([w_by_key[k] for k in keys])
        return W, alive


class LookaheadPrefetcher:
    """``weights_lookahead`` on the driver's worker thread, one chunk
    ahead of the device, bit-identically: the same calls in the same
    order against the same runtime, chunk sizes capped by the remaining
    step budget. The runtime is touched only from the worker thread
    after construction; ``block_weights`` (pure) stays safe to call from
    the main thread."""

    def __init__(self, runtime: CodingRuntime, pool, horizon: int,
                 total_steps: int):
        if horizon < 1:
            raise ValueError("horizon must be >= 1")
        self.runtime = runtime
        self.pool = pool
        self.horizon = horizon
        self.remaining = total_steps
        self._chunk = None
        self._cursor = 0
        self._future = self._submit()

    def _submit(self):
        k = min(self.horizon, self.remaining)
        if k < 1:
            return None
        self.remaining -= k
        return self.pool.submit(self.runtime.weights_lookahead, k)

    def next(self) -> Tuple[np.ndarray, np.ndarray]:
        """The next round's (w (m,) float32, alive (m,) bool)."""
        if self._chunk is None or self._cursor == len(self._chunk[0]):
            if self._future is None:
                raise RuntimeError("lookahead stream exhausted")
            self._chunk = self._future.result()
            self._cursor = 0
            self._future = self._submit()
        W, alive = self._chunk
        t = self._cursor
        self._cursor += 1
        return W[t], alive[t]
