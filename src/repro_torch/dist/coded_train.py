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

The reference reduces the manual collective inside a ``shard_map``: each
worker shard combines its local machines, then a psum over the shards.
Here the group is one shard holding all m machines -- the reference's
own ``make_test_mesh((1, 1))`` case -- so the local combine is the whole
reduction and the psum is the identity. Streaming the combine over
machine chunks, FSDP and the elastic re-assignment wait for the
distributed slice; the adaptive decoding policy for the harness slice.

Per-row gradients (the reference's ``jax.vmap(jax.value_and_grad)``)
are one backward pass per row, written into a preallocated (rows, ...)
stack per leaf: rows are independent, so this computes the same
gradients and holds one row's activations at a time.

Host side, ``CodingRuntime`` draws one alive mask per step from its
``MaskSource``, decodes it through ``core.step_weights`` and memoises
repeated masks; ``weights_lookahead`` decodes a horizon of masks in one
batch, and ``LookaheadPrefetcher`` runs it on the driver's worker
thread, bit-identically to the per-step stream.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs import CodingConfig, ModelConfig
from repro_torch.core import compress as compress_mod
from repro_torch.core import step_weights as sw
from repro_torch.core.assignment import (Assignment, expander_assignment,
                                         frc_assignment,
                                         uncoded_assignment)
from repro_torch.kernels.coded_combine import ops as cc_ops
from repro_torch.models import model as M
from repro_torch.optim import optimizers as opt_mod


# ---------------------------------------------------------------------------
# Coded losses and gradients
# ---------------------------------------------------------------------------


def coded_loss_fn(params, coded_batch: Dict[str, torch.Tensor],
                  w: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Per-block weighted coded loss; grad == sum_j w_j g_j (Eq. 1).

    coded_batch leaves are (m, load, bs, ...) with a ``block_weight``
    (m, load) mask (0 on padding slots of irregular assignments); w is
    the (m,) decoding weights. The machine, load and batch axes flatten
    into one forward pass.
    """
    bw = coded_batch["block_weight"]
    m, load = bw.shape
    flat = {k: v.reshape((-1,) + tuple(v.shape[3:]))
            for k, v in coded_batch.items() if k != "block_weight"}
    per_seq = M.train_loss(params, flat, cfg, per_example=True)
    per_block = per_seq.reshape(m, load, -1).sum(dim=2)
    norm = coded_batch["labels"].numel()
    return (w[:, None] * bw * per_block).sum() / norm


def coded_loss_fn_dedup(params, block_batch: Dict[str, torch.Tensor],
                        v: torch.Tensor, cfg: ModelConfig,
                        norm_scale: float = 1.0) -> torch.Tensor:
    """Per-unique-block weighted coded loss; grad == sum_j w_j g_j.

    block_batch leaves are (n, block_rows, ...) unique blocks
    (``CodedBatcher.unique_blocks``); v is the (n,) per-block weights
    A @ w. ``norm_scale = dedup_norm_scale(assignment)`` makes the loss
    value equal the replicated path's, not only its gradient.
    """
    labels = block_batch["labels"]
    n = labels.shape[0]
    flat = {k: x.reshape((-1,) + tuple(x.shape[2:]))
            for k, x in block_batch.items()}
    per_seq = M.train_loss(params, flat, cfg, per_example=True)
    per_block = per_seq.reshape(n, -1).sum(dim=1)
    norm = labels.numel() * norm_scale
    return (v * per_block).sum() / norm


def dedup_norm_scale(assignment: Assignment) -> float:
    """m*load/n: aligns the dedup loss normalisation with the replicated
    batch's (padded) label count."""
    return assignment.m * assignment.load / assignment.n


def value_and_grad(loss_fn: Callable, params):
    """(loss, grads) of ``loss_fn(params)``; grads is a tree like
    ``params``. The parameters themselves are left untouched: the
    forward runs on detached views that require grad."""
    live = T.map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = loss_fn(live)
        grads = torch.autograd.grad(loss, T.leaves(live))
    return loss.detach(), T.like(params, grads)


def _per_row_values_and_grads(params, rows: int, row_loss: Callable):
    """(losses (rows,), grads tree with a leading rows axis): one
    backward pass per row, ``row_loss(params, i)``, each written into a
    preallocated stack per leaf."""
    leaves = T.leaves(params)
    dev = leaves[0].device
    stacks = [torch.empty((rows,) + tuple(p.shape), dtype=p.dtype,
                          device=dev) for p in leaves]
    losses = torch.empty(rows, dtype=torch.float32, device=dev)
    for i in range(rows):
        loss, grads = value_and_grad(lambda p: row_loss(p, i), params)
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


def _quantize_rows(grads, residual, codec, error_feedback: bool):
    """Row-wise quantize of g (+ residual) per leaf, flat payloads.

    Returns (q_tree, scale_tree, new_residual_tree, shapes_tree): payload
    leaves are flat (rows, D) -- (rows, ceil(D/8)) for a packed codec --
    and ``shapes_tree`` holds each leaf's combined-output shape.
    """
    def one(g, r):
        rows = g.shape[0]
        flat = g.reshape(rows, -1).float()
        pre = flat + r.reshape(rows, -1) if error_feedback else flat
        q, s = codec.compress(pre)
        new_r = ((pre - codec.decompress(q, s, d=flat.shape[1]))
                 .reshape(g.shape) if error_feedback else r)
        return q, s, new_r, tuple(g.shape[1:])
    return _split(T.map(one, grads, residual), 4)


def compress_combine_tree(grads, residual, w, codec, *,
                          error_feedback: bool = True):
    """Quantize per-row gradients and run the fused combine per leaf.

    ``grads`` leaves carry a leading row axis (m machines or n unique
    blocks), ``residual`` is the matching error-feedback tree and ``w``
    the (rows,) weights (machine w or block v = A @ w). Per leaf:
    compress ``g + e`` row-wise, combine the payload through
    ``quantized_combine`` (or ``packed_sign_combine`` for a packed
    codec), and keep ``e' = (g + e) - dequant``. Returns (combined
    float32 tree, new residual tree).
    """
    q, s, new_r, shapes = _quantize_rows(grads, residual, codec,
                                         error_feedback)
    return _compressed_allreduce(q, s, w, codec, shapes), new_r


# ---------------------------------------------------------------------------
# The coded allreduces, over a group of one shard
# ---------------------------------------------------------------------------


def coded_allreduce(grads, w: torch.Tensor):
    """The paper combine ``sum_j w_j g_j`` as an explicit reduction: the
    leaves carry the (m, ...) machine axis and the ``coded_combine``
    kernel reduces it, one launch per leaf."""
    return cc_ops.coded_combine_tree(grads, w)


def quantized_coded_allreduce(q_tree, scale_tree, w: torch.Tensor):
    """``coded_allreduce`` carrying the quantized payload: (m, D) int8
    (or float32) leaves with (m,) scales, reduced by
    ``quantized_combine``."""
    return cc_ops.quantized_combine_tree(q_tree, scale_tree, w)


def packed_sign_coded_allreduce(q_tree, scale_tree, w: torch.Tensor,
                                shapes):
    """``coded_allreduce`` carrying the 1-bit packed sign payload;
    ``shapes`` is the tree of combined-output shapes."""
    return cc_ops.packed_sign_combine_tree(q_tree, scale_tree, w, shapes)


def _compressed_allreduce(q_tree, scale_tree, w, codec, shapes):
    """Codec-dispatching combine over flat row payloads."""
    if codec.packed:
        return packed_sign_coded_allreduce(q_tree, scale_tree, w, shapes)
    out = quantized_coded_allreduce(q_tree, scale_tree, w)
    return T.map(lambda x, s: x.reshape(s), out, shapes)


def alpha_bar_weights(assignment: Assignment) -> np.ndarray:
    """(m,) vector a with a . w == mean(A @ w): the on-device form of the
    alpha-bar debias divisor (colsum(A)/n)."""
    return (assignment.A.sum(axis=0) / assignment.n).astype(np.float32)


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------


def _finisher(optimizer, alpha_weights, dedup: bool):
    """The shared tail of every step: optimizer update, then metrics
    (loss, grad_norm, extras, alpha_bar) kept on the device."""
    aw = (None if alpha_weights is None
          else torch.as_tensor(np.asarray(alpha_weights, np.float32)))

    def finish(params, opt_state, loss, grads, w, extra=None):
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = opt_mod.apply_updates(params, updates)
        metrics = {"loss": loss, "grad_norm": opt_mod.global_norm(grads)}
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


def make_train_step(cfg: ModelConfig, optimizer: opt_mod.Optimizer,
                    n_microbatches: int = 1, *, dedup: bool = False,
                    norm_scale: float = 1.0, alpha_weights=None,
                    compress=None, error_feedback: bool = True):
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
    """
    nm = int(n_microbatches)
    if nm < 1:
        raise ValueError("n_microbatches must be >= 1")
    finish = _finisher(optimizer, alpha_weights, dedup)

    if compress is not None:
        if nm != 1:
            raise ValueError("compress does not compose with "
                             "n_microbatches > 1")
        codec = compress_mod.get_codec(compress)

        def compressed_step(params, opt_state, comp_state, batch, w):
            if dedup:
                norm = batch["labels"].numel() * norm_scale

                def block_loss(p, i):
                    blk = {k: v[i] for k, v in batch.items()}
                    return M.train_loss(p, blk, cfg,
                                        per_example=True).sum() / norm

                losses, grads = _per_row_values_and_grads(
                    params, batch["labels"].shape[0], block_loss)
            else:
                losses, grads = _per_machine_values_and_grads(
                    params, batch, cfg)
            loss = (w * losses).sum()
            combined, new_resid = compress_combine_tree(
                grads, comp_state["residual"], w, codec,
                error_feedback=error_feedback)
            del grads
            params, opt_state, metrics = finish(
                params, opt_state, loss, combined, w,
                extra=_comm_metric(codec, w, params))
            return params, opt_state, {"residual": new_resid}, metrics

        return compressed_step

    def loss_fn(p, b, wv):
        if dedup:
            return coded_loss_fn_dedup(p, b, wv, cfg,
                                       norm_scale=norm_scale)
        return coded_loss_fn(p, b, wv, cfg)

    def step(params, opt_state, batch, w):
        if nm == 1:
            loss, grads = value_and_grad(lambda p: loss_fn(p, batch, w),
                                         params)
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
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=w.device)
            for i in range(nm):
                mb = {k: micro(v, i) for k, v in batch.items()
                      if k != "block_weight"}
                if not dedup:
                    mb["block_weight"] = batch["block_weight"]
                l_i, g_i = value_and_grad(lambda p: loss_fn(p, mb, w),
                                          params)
                grads = T.map(torch.add, grads, g_i)
                loss = loss + l_i
            grads = T.map(lambda g: g / nm, grads)
            loss = loss / nm
        return finish(params, opt_state, loss, grads, w)

    return step


def make_manual_collective_train_step(cfg: ModelConfig,
                                      optimizer: opt_mod.Optimizer,
                                      alpha_weights=None, compress=None,
                                      error_feedback: bool = True,
                                      streaming_chunk: Optional[int]
                                      = None):
    """Replicated-path train step whose combine is the explicit
    ``coded_allreduce`` instead of autograd's fused one: the per-machine
    gradients g_j are materialised (m x the gradient memory) and reduced
    by the ``coded_combine`` kernel. ``compress`` quantizes them (with
    error feedback) before the combine, which then runs on the payload;
    the step's signature then carries the residual state as its third
    argument, as in ``make_train_step``. ``streaming_chunk`` waits for
    the distributed slice and raises.
    """
    if streaming_chunk is not None:
        if int(streaming_chunk) < 1:
            raise ValueError("streaming_chunk must be >= 1")
        raise NotImplementedError(
            "streaming_chunk waits for the distributed slice of the port")
    codec = (None if compress is None
             else compress_mod.get_codec(compress))
    finish = _finisher(optimizer, alpha_weights, dedup=False)

    if codec is not None:
        def compressed_step(params, opt_state, comp_state, batch, w):
            losses, grads = _per_machine_values_and_grads(
                params, batch, cfg)
            loss = (w * losses).sum()
            q_tree, s_tree, new_resid, shapes = _quantize_rows(
                grads, comp_state["residual"], codec, error_feedback)
            del grads
            combined = _compressed_allreduce(q_tree, s_tree, w, codec,
                                             shapes)
            params, opt_state, metrics = finish(
                params, opt_state, loss, combined, w,
                extra=_comm_metric(codec, w, params))
            return params, opt_state, {"residual": new_resid}, metrics

        return compressed_step

    def step(params, opt_state, batch, w):
        losses, grads = _per_machine_values_and_grads(params, batch, cfg)
        grads = coded_allreduce(grads, w)
        loss = (w * losses).sum()
        return finish(params, opt_state, loss, grads, w)

    return step


# ---------------------------------------------------------------------------
# Serving and the host-side coding runtime
# ---------------------------------------------------------------------------


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
    raise ValueError(f"unknown scheme {coding.scheme!r} "
                     "(expander | frc | uncoded; the scheme zoo is not "
                     "ported yet)")


@dataclasses.dataclass
class CodingRuntime:
    """Host bridge: assignment + straggler process + per-step weights.

    ``step_weights()`` takes this round's alive mask from the mask
    source (by default sampled from the configured straggler model) and
    returns the debiased decoding weights w (w_j = 0 on stragglers),
    memoised by mask. The alpha-bar debias scale is estimated once at
    construction: one batched decode of a Bernoulli mask batch, or, for
    the adversarial model, the exact scale of its one fixed mask. The
    adaptive decoding policy (``adaptive``) waits for the harness slice:
    only None is accepted.
    """

    coding: CodingConfig
    m: int
    debias: bool = True
    debias_trials: int = 256
    cache_size: int = 4096
    mask_source: Optional[sw.MaskSource] = None
    adaptive: Optional[object] = None

    def __post_init__(self):
        if self.adaptive is not None:
            raise NotImplementedError(
                "the adaptive decoding policy (core/adaptive.py) waits "
                "for the harness slice of the port")
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
        self.scale = 1.0
        if self.debias and self.coding.decoding == "optimal":
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
                    seed=self.coding.seed + 0x5EED)
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

    def _key(self, alive: np.ndarray) -> tuple:
        return (self.coding.decoding, float(self.coding.straggler_p),
                alive.tobytes())

    def weights_for(self, alive: np.ndarray) -> np.ndarray:
        """Memoised decode of one (m,) alive mask -> w float32."""
        alive = np.asarray(alive, dtype=bool)
        if alive.shape != (self.m,):
            raise ValueError(f"mask must be ({self.m},), "
                             f"got {alive.shape}")
        key = self._key(alive)
        w = self._cache.get(key)
        if w is None:
            method = self.coding.decoding
            scale = self.scale if method == "optimal" else 1.0
            w, _ = sw.step_weights(self.assignment, alive, method=method,
                                   p=self.coding.straggler_p, scale=scale)
            w = w.astype(np.float32)
            self._remember(key, w)
            self.decode_calls += 1
        return w

    def step_weights(self) -> Tuple[np.ndarray, np.ndarray]:
        """One round: (w (m,) float32, alive (m,) bool)."""
        alive = self.mask_source.next_mask()
        self.steps_sampled += 1
        return self.weights_for(alive), alive

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
        ``step_weights``."""
        if horizon < 1:
            raise ValueError("horizon must be >= 1")
        alive = np.stack(
            [self.mask_source.next_mask() for _ in range(horizon)])
        self.steps_sampled += horizon
        keys = [self._key(a) for a in alive]
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
