"""Iteration-level scheduling for the serving engine.

The engine advances EVERY pool row by one token per device step: rows
still in their prefill phase consume the next prompt token, rows in
the decode phase consume their previously generated token. Prefill is
therefore not a separate long-running kernel that could starve decode
-- the interleave is total, one token of everything per iteration
(Orca-style continuous batching), and a long prompt only occupies its
own row.

``ContinuousScheduler`` admits from the queue whenever a slot frees;
``SequentialScheduler`` is the static-batching discipline (admit a
full batch, drain it completely, admit the next) that the independent
oracle in ``reference.sequential_serve`` also implements. Scheduling
must change *when* tokens appear, never *what* they are -- pinned by
the engine-vs-``sequential_serve`` tests.

Copy of ``repro.serve.scheduler`` (pure host bookkeeping).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    uid: int
    prompt: np.ndarray            # (P,) int32 token ids
    max_new_tokens: int

    def __post_init__(self):
        p = np.asarray(self.prompt, np.int32)
        if p.ndim != 1 or p.size == 0:
            raise ValueError("prompt must be a non-empty 1-D token "
                             f"array, got shape {p.shape}")
        object.__setattr__(self, "prompt", p)
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")


@dataclasses.dataclass
class _Slot:
    uid: int
    prompt: np.ndarray
    max_new: int
    consumed: int = 0             # prompt tokens consumed so far
    emitted: int = 0              # generated tokens recorded so far


@dataclasses.dataclass
class IterationPlan:
    """One device step's worth of host decisions."""
    admitted: List[Tuple[int, Request]]       # (slot, request)
    forced_tok: np.ndarray                    # (B,) int32 prompt feed
    use_forced: np.ndarray                    # (B,) bool
    emits: List[Tuple[int, int, bool]]        # (slot, uid, is_first)
    finished: List[int]                       # uids done this iteration


class ContinuousScheduler:
    """Admit whenever a slot is free (bounded by ``max_admit``)."""

    def __init__(self, n_slots: int, max_admit: Optional[int] = None):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        self.n_slots = n_slots
        self.max_admit = max_admit or n_slots
        self.queue: collections.deque = collections.deque()
        self.slots: List[Optional[_Slot]] = [None] * n_slots
        self.iterations = 0
        self.admitted_total = 0

    def submit(self, request: Request) -> None:
        self.queue.append(request)

    def has_work(self) -> bool:
        return bool(self.queue) or any(
            s is not None for s in self.slots)

    def _admissions(self) -> List[Tuple[int, Request]]:
        out = []
        for b in range(self.n_slots):
            if len(out) >= self.max_admit or not self.queue:
                break
            if self.slots[b] is None:
                out.append((b, self.queue.popleft()))
        return out

    def plan(self) -> IterationPlan:
        admitted = self._admissions()
        for b, req in admitted:
            self.slots[b] = _Slot(req.uid, req.prompt,
                                  req.max_new_tokens)
            self.admitted_total += 1
        forced = np.zeros(self.n_slots, np.int32)
        use_forced = np.zeros(self.n_slots, bool)
        emits, finished = [], []
        for b, s in enumerate(self.slots):
            if s is None:
                continue
            P = s.prompt.shape[0]
            if s.consumed < P:
                forced[b] = s.prompt[s.consumed]
                use_forced[b] = True
                s.consumed += 1
                if s.consumed == P:
                    # the last prompt token's output is the first
                    # generated token
                    emits.append((b, s.uid, True))
                    s.emitted = 1
            else:
                emits.append((b, s.uid, False))
                s.emitted += 1
            if s.consumed == P and s.emitted >= s.max_new:
                finished.append(s.uid)
                self.slots[b] = None    # reusable from next iteration
        self.iterations += 1
        return IterationPlan(admitted, forced, use_forced, emits,
                             finished)


class SequentialScheduler(ContinuousScheduler):
    """Static batching: admit only into an entirely idle pool."""

    def _admissions(self) -> List[Tuple[int, Request]]:
        if any(s is not None for s in self.slots):
            return []
        return super()._admissions()
