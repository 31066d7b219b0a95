"""Continuous-batching serving engine over the coded serve step.

One *pool step* at fixed width n_slots wraps
``dist.coded_train.make_serve_step``: every iteration each row either
consumes a forced prompt token (prefill replay) or its previously
generated token (decode), the row's logits are scaled by its combine
weight alpha (1.0 except at a coded first token), and greedy argmax
produces the next token, all on the device without a host sync. The
host loop queues steps and hands generated-token buffers to a worker
thread once per ``log_every`` iterations, which copies them to the host
and scatters them into per-request streams.

Rows are independent through every kernel of the step (per-row KV
write positions, per-row norms and attention), so the same step at the
same pool width produces bit-identical per-request token streams under
any admission order. Port of ``repro.serve.engine``.

Over a worker group (``workers``: the data group, with its model group)
every rank runs the same host scheduler and coded prefill (the same
seed), holds its shards of the parameters (``safe_param_specs``, the
reference's ``device_put``) and its block of the pool's slots
(``cache_specs``), and decodes those slots on its model group; the new
tokens are all-gathered over the data group, so every scheduler sees
the same streams.
"""

from __future__ import annotations

import functools
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import CodingConfig, ModelConfig
from repro_torch.dist import coded_train
from repro_torch.dist import tensor_parallel as tp
from repro_torch import tree as T
from repro_torch.models import model as M

from .cache_pool import CachePool, slot_rows
from .coded import CodedPrefillLayer, UncodedPrefillLayer
from .latency import ReplicaLatencyModel
from .scheduler import ContinuousScheduler, Request


def validate_budget(cfg: ModelConfig, prompt_len: int,
                    max_new_tokens: int, max_len: int, *,
                    window: Optional[int] = None) -> None:
    """Reject a generation budget the decode cache cannot hold, up
    front.

    Windowed attention wraps its cache, so only the full-attention
    capacity check applies there; any declared config ``max_seq_len``
    caps both.
    """
    if prompt_len < 1:
        raise ValueError("prompt_len must be >= 1")
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    total = prompt_len + max_new_tokens
    w = window if window is not None else cfg.sliding_window
    if w is None and total > max_len:
        raise ValueError(
            f"prompt_len + max_new_tokens = {total} overflows the "
            f"decode cache (--max-len {max_len}) for full causal "
            f"attention; raise --max-len or shorten the request")
    max_seq = getattr(cfg, "max_seq_len", None)
    if max_seq and total > max_seq:
        raise ValueError(
            f"prompt_len + max_new_tokens = {total} exceeds the "
            f"config's max_seq_len {max_seq}")


class PoolStep:
    """The fixed-width pool step. ``calls`` counts the steps taken.

    It takes and returns whole-width token rows; over a worker group it
    steps this rank's slots (``cache_pool.slot_rows``) on its model
    group and all-gathers the new tokens over the data ranks."""

    def __init__(self, cfg: ModelConfig, window: Optional[int],
                 workers=None):
        self.serve_step = coded_train.make_serve_step(cfg, window=window)
        self.vocab = cfg.vocab_size
        self.workers = workers
        self.calls = 0

    @torch.no_grad()
    def __call__(self, params, cache, prev_tok, forced_tok, use_forced,
                 alpha):
        tok = torch.where(use_forced, forced_tok, prev_tok)
        w = self.workers
        rows = slot_rows(tok.shape[0], w)
        with tp.executing(None if w is None else w.model):
            logits, cache = self.serve_step(params, tok[rows], cache)
        scores = alpha[rows, None] * logits[:, :self.vocab]
        nxt = torch.argmax(scores, dim=-1).to(torch.int32)
        if rows.stop - rows.start != tok.shape[0]:
            nxt = w.all_gather_(torch.empty_like(tok), nxt)
        self.calls += 1
        return nxt, cache


@functools.lru_cache(maxsize=8)
def pool_step(cfg: ModelConfig, window: Optional[int],
              workers=None) -> PoolStep:
    """The pool step shared (via the cache key) by the engine, the
    sequential reference loop and the tests, so all of them run the
    identical computation."""
    return PoolStep(cfg, window, workers)


def place_params(params, cfg: ModelConfig, workers=None):
    """The serving parameters of this rank, from the whole tree: its
    shards on its model group (``safe_param_specs``) when the model axis
    is above 1, with the block weights cast once into ``cfg.dtype``.
    Nothing of the whole tensors is kept: a shard the cast leaves in its
    dtype is copied out of them."""
    if workers is None or workers.model_size == 1:
        return M.cast_block_weights(params, cfg)
    views = tp.ModelShards(params, workers).shard(params, copy=False)
    return T.map(lambda x, v: x.clone() if x is v else x,
                 M.cast_block_weights(views, cfg), views)


def params_device(params) -> torch.device:
    return params["embed"]["table"].device


class ServeEngine:
    """Admission queue + cache pool + coded prefill + async host loop.

    Runs on the device that holds ``params``. The block weights are cast
    once into ``cfg.dtype`` here (see ``models.model.cast_block_weights``;
    a no-op on placed parameters). Over a worker group (``workers``,
    module docstring) ``params`` are this rank's, as ``place_params``
    gives them, and ``workers`` places the pool and the step.
    """

    def __init__(self, cfg: ModelConfig, params, *, n_slots: int = 8,
                 max_len: int = 128,
                 coding: Optional[CodingConfig] = None,
                 m_replicas: int = 8,
                 latency: Optional[ReplicaLatencyModel] = None,
                 scheduler: Optional[ContinuousScheduler] = None,
                 log_every: int = 16, workers=None):
        if cfg.arch_type in ("vlm", "audio"):
            raise ValueError(
                f"arch_type {cfg.arch_type!r} needs a per-request "
                "prefix/src side channel the pool does not carry")
        self.cfg = cfg
        self.window = cfg.sliding_window
        self.device = params_device(params)
        self.pool = CachePool(cfg, n_slots, max_len, device=self.device,
                              workers=workers)
        self.scheduler = scheduler or ContinuousScheduler(n_slots)
        if self.scheduler.n_slots != n_slots:
            raise ValueError("scheduler width != n_slots")
        self.step_fn = pool_step(cfg, self.window, workers)
        self.params = M.cast_block_weights(params, cfg)
        self.log_every = max(1, log_every)
        if coding is not None and coding.scheme != "uncoded":
            self.prefill = CodedPrefillLayer(coding, m_replicas, latency)
        elif coding is not None:
            self.prefill = UncodedPrefillLayer(coding, m_replicas,
                                               latency)
        else:
            self.prefill = None
        self.records: Dict[int, dict] = {}
        self._tok = torch.zeros(n_slots, dtype=torch.int32,
                                device=self.device)
        self._alpha_pending = np.ones(n_slots, np.float32)

    def submit(self, request: Request) -> None:
        validate_budget(self.cfg, int(request.prompt.shape[0]),
                        request.max_new_tokens, self.pool.max_len,
                        window=self.window)
        if request.uid in self.records:
            raise ValueError(f"duplicate request uid {request.uid}")
        self.records[request.uid] = {
            "tokens": [], "shard": None, "alpha": 1.0,
            "ttft_ms": None, "retries": 0,
            "enqueued_iter": self.scheduler.iterations,
            "admitted_iter": None, "done_iter": None}
        self.scheduler.submit(request)

    def _admit(self, admitted) -> None:
        mask = np.zeros(self.pool.n_slots, bool)
        for b, _ in admitted:
            mask[b] = True
        self.pool.reset_slots(mask)
        it = self.scheduler.iterations
        services = None
        if self.prefill is not None:
            shards = self.prefill.assign_shards(len(admitted))
            services = self.prefill.serve_shards(shards)
        for k, (b, req) in enumerate(admitted):
            rec = self.records[req.uid]
            rec["admitted_iter"] = it
            if services is not None:
                svc = services[k]
                rec.update(shard=svc.shard, alpha=svc.alpha,
                           ttft_ms=svc.ttft_ms, retries=svc.retries)
                self._alpha_pending[b] = svc.alpha
            else:
                self._alpha_pending[b] = 1.0

    def _flush(self, buf) -> None:
        if not buf:
            return
        toks = torch.stack([t for t, _ in buf]).cpu().numpy()
        for tok, (_, emits) in zip(toks, buf):
            for b, uid, _ in emits:
                self.records[uid]["tokens"].append(int(tok[b]))

    def _host(self, arr) -> torch.Tensor:
        """A host array on the device without waiting for the device: a
        copy from pageable memory would block until the queued steps
        finish, so the copy goes through pinned memory instead."""
        t = torch.from_numpy(arr)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def run(self) -> dict:
        """Drain the queue; returns a summary dict (per-request tokens
        via ``results()``)."""
        sched = self.scheduler
        B = self.pool.n_slots
        t0 = time.perf_counter()
        iters0 = sched.iterations
        buf: List = []
        pending = None
        with ThreadPoolExecutor(max_workers=1) as host:
            while sched.has_work():
                plan = sched.plan()
                if plan.admitted:
                    self._admit(plan.admitted)
                alpha = np.ones(B, np.float32)
                for b, uid, is_first in plan.emits:
                    if is_first:
                        alpha[b] = self._alpha_pending[b]
                for uid in plan.finished:
                    self.records[uid]["done_iter"] = sched.iterations
                # A new token tensor every step: the flush thread still
                # reads the earlier ones.
                self._tok, self.pool.cache = self.step_fn(
                    self.params, self.pool.cache, self._tok,
                    self._host(plan.forced_tok),
                    self._host(plan.use_forced), self._host(alpha))
                if plan.emits:
                    buf.append((self._tok, tuple(plan.emits)))
                if len(buf) >= self.log_every:
                    if pending is not None:
                        pending.result()
                    pending = host.submit(self._flush, buf)
                    buf = []
            if pending is not None:
                pending.result()
            self._flush(buf)
        dt = time.perf_counter() - t0
        new_tokens = sum(len(r["tokens"]) for r in self.records.values())
        ttfts = [r["ttft_ms"] for r in self.records.values()
                 if r["ttft_ms"] is not None]
        summary = {
            "requests": len(self.records),
            "new_tokens": new_tokens,
            "tokens_per_s": new_tokens / max(dt, 1e-9),
            "iterations": sched.iterations - iters0,
            "admissions": sched.admitted_total,
            "retries": sum(r["retries"]
                           for r in self.records.values()),
            "decode_calls": (self.prefill.decode_calls
                             if self.prefill is not None else 0),
        }
        if ttfts:
            summary["ttft_p50_ms"] = float(np.percentile(ttfts, 50))
            summary["ttft_p99_ms"] = float(np.percentile(ttfts, 99))
        return summary

    def results(self) -> Dict[int, np.ndarray]:
        return {uid: np.asarray(r["tokens"], np.int32)
                for uid, r in self.records.items()}
