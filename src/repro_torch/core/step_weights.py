"""Straggler-sample -> decode -> step weights: the host pipeline.

Copy of ``repro.core.step_weights``: the straggler-model factory, the
mask sources (sampled, replayed, observed), the GCOD mask-stream
protocol (``sample_mask_stream``), per-mask machine weights w* and alpha
(``step_weights``), the per-block combine weights v = A @ w
(``block_weights``), the serving support predicate (``served_blocks``),
the batched form (``batched_step_weights``) and the Monte-Carlo debias
scale (``debias_scale_mc``, with ``debias_scale`` from its single
source, ``kernels.batched_alpha.ops``). All of it is NumPy, so seeded
streams are bit-identical to the reference.
"""

from __future__ import annotations

import collections
from typing import Tuple

import numpy as np

from ..kernels.batched_alpha.ops import debias_scale
from .assignment import Assignment
from .batched_decoding import batched_alpha, batched_fixed_alpha, fixed_w
from .decoding import decode
from .stragglers import (AdversarialStragglers, BernoulliStragglers,
                         FixedCountStragglers, MarkovStragglers,
                         StragglerModel)
from .sweep import bernoulli_uniforms

STRAGGLER_MODELS = ("bernoulli", "markov", "adversarial", "fixed_count")


def make_straggler_model(assignment: Assignment, name: str, p: float, *,
                         persistence: float = 10.0) -> StragglerModel:
    """Build one of the ``core.stragglers`` processes from its config
    string. All models emit (m,) alive masks via ``sample(rng)``."""
    m = assignment.m
    if name == "bernoulli":
        return BernoulliStragglers(m=m, p=p)
    if name == "markov":
        return MarkovStragglers(m=m, p=p, persistence=persistence)
    if name == "adversarial":
        return AdversarialStragglers(assignment=assignment, p=p)
    if name == "fixed_count":
        return FixedCountStragglers(m=m, p=p)
    raise ValueError(f"unknown straggler model {name!r}; "
                     f"known: {STRAGGLER_MODELS}")


class MaskSource:
    """Where a round's (m,) alive mask comes from: sampled from a
    straggler process, observed from heartbeats, or replayed from a
    recorded stream. ``next_mask()`` yields one round's mask;
    ``skip(rounds)`` fast-forwards the stream for checkpoint resume."""

    m: int

    def next_mask(self) -> np.ndarray:
        raise NotImplementedError

    def skip(self, rounds: int) -> None:
        if rounds < 0:
            raise ValueError("rounds must be >= 0")
        for _ in range(rounds):
            self.next_mask()


class SampledMaskSource(MaskSource):
    """Masks drawn from a ``core.stragglers`` process. Holds (not
    copies) the model and RNG, so a runtime that wraps its own
    ``(model, rng)`` pair consumes the reference's RNG stream."""

    def __init__(self, model: StragglerModel,
                 rng: np.random.Generator, m: int):
        self.model = model
        self.rng = rng
        self.m = m

    def next_mask(self) -> np.ndarray:
        return self.model.sample(self.rng)


class ReplayedMaskSource(MaskSource):
    """Replays a recorded (T, m) mask stream round for round; raises
    when the recording is exhausted rather than resampling."""

    def __init__(self, masks):
        masks = np.asarray(masks, dtype=bool)
        if masks.ndim != 2:
            raise ValueError(f"masks must be (T, m), got {masks.shape}")
        self.masks = masks
        self.m = masks.shape[1]
        self.cursor = 0

    def next_mask(self) -> np.ndarray:
        if self.cursor >= self.masks.shape[0]:
            raise RuntimeError(
                f"replayed mask stream exhausted after "
                f"{self.masks.shape[0]} rounds")
        row = self.masks[self.cursor]
        self.cursor += 1
        return row.copy()

    def skip(self, rounds: int) -> None:
        if rounds < 0:
            raise ValueError("rounds must be >= 0")
        if self.cursor + rounds > self.masks.shape[0]:
            raise RuntimeError("cannot skip past the recorded stream")
        self.cursor += rounds


class ObservedMaskSource(MaskSource):
    """Push-based source for masks derived from real heartbeats: the
    driver pushes each round's mask before asking for weights. Pulling
    without a pushed mask raises, and so does ``skip``: an observed
    stream cannot be fast-forwarded."""

    def __init__(self, m: int):
        self.m = m
        self._queue: collections.deque = collections.deque()

    def push(self, alive: np.ndarray) -> None:
        alive = np.asarray(alive, dtype=bool)
        if alive.shape != (self.m,):
            raise ValueError(f"mask must be ({self.m},), "
                             f"got {alive.shape}")
        self._queue.append(alive.copy())

    def next_mask(self) -> np.ndarray:
        if not self._queue:
            raise RuntimeError(
                "no observed mask pushed for this round (push() the "
                "heartbeat-derived mask before requesting weights)")
        return self._queue.popleft()

    def skip(self, rounds: int) -> None:
        raise RuntimeError(
            "observed mask streams cannot be fast-forwarded; resume "
            "re-observes the cluster instead of replaying RNG")


def sample_mask_stream(assignment: Assignment,
                       straggler_model: StragglerModel, *, steps: int,
                       shuffle: bool, rng: np.random.Generator
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """GCOD's RNG consumption protocol: the rho permutation draw (when
    shuffling), then one straggler mask per step. Returns (rho, masks)
    with masks of shape (steps, m)."""
    n = assignment.n
    rho = rng.permutation(n) if shuffle else np.arange(n)
    if steps:
        masks = np.stack(
            [straggler_model.sample(rng) for _ in range(steps)])
    else:
        masks = np.zeros((0, assignment.m), dtype=bool)
    return rho, masks


def step_weights(assignment: Assignment, alive: np.ndarray, *,
                 method: str = "optimal", p: float = 0.0,
                 scale: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """One mask -> (w (m,), alpha (n,)), both scaled by ``scale``.

    Thin dispatch onto ``decoding.decode`` (the O(m) graph decoder /
    FRC closed form / pseudoinverse / Section VIII fixed weights);
    stragglers keep w = 0 under any scale.
    """
    res = decode(assignment, alive, method=method, p=p)
    return res.w * scale, res.alpha * scale


def block_weights(assignment: Assignment, w: np.ndarray) -> np.ndarray:
    """Per-block combine weights v = A @ w from machine weights w.

    Accepts a scalar (m,) weight vector -> (n,), or a batched (T, m)
    stack -> (T, n).
    """
    w = np.asarray(w)
    if w.ndim == 1:
        if w.shape[0] != assignment.m:
            raise ValueError(f"w must be ({assignment.m},), got {w.shape}")
        return assignment.A @ w
    if w.ndim == 2:
        if w.shape[1] != assignment.m:
            raise ValueError(f"W must be (T, {assignment.m}), "
                             f"got {w.shape}")
        return w @ assignment.A.T
    raise ValueError(f"w must be (m,) or (T, m), got ndim={w.ndim}")


def served_blocks(assignment: Assignment, w: np.ndarray,
                  eps: float = 1e-3) -> np.ndarray:
    """Which blocks the decoded weights can actually reconstruct:
    alpha_i = (A w)_i > eps.

    A prefill shard with no usable combine weight has no output to
    emit, so the engine retries it next round: w_j = 0 on stragglers
    implies alpha_i > 0 only when some arrived replica covers block i.

    Accepts (m,) -> (n,) bool, or batched (T, m) -> (T, n) bool.
    """
    return block_weights(assignment, w) > eps


def batched_step_weights(assignment: Assignment, masks, *,
                         method: str = "optimal", p: float = 0.0,
                         scale: float = 1.0
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """A (T, m) mask batch -> (W (T, m), alphas (T, n)).

    Fixed decoding is fully vectorised; optimal decoding loops the
    scalar ``decoding.decode`` dispatch once per mask, since w* needs
    the spanning-tree back-substitution.
    """
    masks = np.asarray(masks, dtype=bool)
    if masks.ndim != 2 or masks.shape[1] != assignment.m:
        raise ValueError(f"masks must be (T, {assignment.m}), "
                         f"got {masks.shape}")
    if method == "fixed":
        W = fixed_w(masks, assignment.replication_factor, p)
        alphas = batched_fixed_alpha(assignment, masks, p)
    elif method != "optimal":
        raise ValueError(f"unknown method {method!r}")
    else:
        results = [decode(assignment, a, method="optimal")
                   for a in masks]
        W = np.stack([r.w for r in results]) if results else \
            np.zeros((0, assignment.m))
        alphas = np.stack([r.alpha for r in results]) if results else \
            np.zeros((0, assignment.n))
    return W * scale, alphas * scale


def debias_scale_mc(assignment: Assignment, *, p: float,
                    method: str = "optimal", trials: int = 256,
                    seed: int = 0, backend: str = "auto",
                    device=None) -> float:
    """Monte-Carlo alpha-bar debias factor under Bernoulli(p)
    stragglers: one ``batched_alpha`` call over the sweep protocol's
    shared-uniform draw. ``backend`` and ``device`` go to
    ``batched_alpha``: at ``backend="auto"`` a batch of at least
    200,000 mask entries takes the torch propagator on ``device``
    (``None`` means the card), unless ``device`` is the CPU."""
    if trials <= 0:
        raise ValueError("trials must be positive")
    masks = bernoulli_uniforms(assignment.m, trials, seed) >= p
    alphas = batched_alpha(assignment, masks, method=method, p=p,
                           backend=backend, device=device)
    return debias_scale(alphas)
