"""Online straggler estimation + per-step decoding policy.

The paper fixes its decoding strategy ahead of time from the *true*
straggler parameter p: Section VIII's fixed weights w = 1/(d(1-p))
need p, the alpha-bar debias scale needs p, and the lookahead depth
worth prefetching depends on how stagnant the straggler set is. On a
real cluster none of those are known -- but every round's alive mask
is observed, and the ``MaskSource`` abstraction (``core.step_weights``)
makes the mask stream a first-class object. This module closes the loop:

- ``OnlineStragglerEstimator`` consumes the observed mask stream and
  maintains p-hat (running straggle fraction, beta-prior smoothed)
  plus the 2x2 alive/straggle transition matrix of the per-machine
  Markov chain -- enough to recover both Bernoulli(p) and the
  stagnant-cluster ``MarkovStragglers`` process (Section VIII's
  empirical observation).
- ``DecodingPolicy.decide(estimate)`` maps an estimate to a
  ``PolicyDecision`` -- which decoder to run this step (optimal vs
  Section VIII fixed), with which p, and how deep a lookahead to
  prefetch. ``StaticPolicy`` reproduces the existing fixed-ahead-of-
  time behaviour exactly (the bit-identity anchor pinned in
  tests/test_adaptive.py); ``AdaptivePolicy`` switches on p-hat and
  scales lookahead with the estimated straggler persistence.
- ``replay_policy`` / ``policy_regret_report`` replay a recorded mask
  stream under each policy and report mean normalized decoding error
  against the omniscient baseline (always-optimal: optimal decoding is
  pointwise at least as good as any fixed-w choice, since the fixed
  weights lie inside the optimal decoder's feasible set). The
  BENCH_sweep.json adaptive-regret row is this report on a seeded
  markov stream; acceptance is adaptive regret < the best *static*
  fixed-decoding policy's regret.

Estimation protocol (shared with ``CodingRuntime``): a policy decides
from the estimator's state *before* the current round's mask is
observed -- the decision may only use the past -- and the estimator
observes the mask afterwards. p-hat is quantized (``P_HAT_DECIMALS``)
inside ``AdaptivePolicy`` so consecutive near-identical estimates hit
the runtime's memoized decode cache instead of thrashing it.

Copy of ``repro.core.adaptive``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from .assignment import Assignment
from .decoding import decode, normalized_error

# AdaptivePolicy quantizes p-hat to this many decimals: decisions (and
# the runtime's (method, p, mask) cache keys) stay stable while the
# estimate drifts by less than half a grid step.
P_HAT_DECIMALS = 3

ALIVE, STRAGGLE = 0, 1  # transition-matrix state indices


@dataclasses.dataclass(frozen=True)
class StragglerEstimate:
    """Snapshot of the estimator's belief after ``steps`` rounds."""

    p_hat: float
    transition_hat: np.ndarray  # (2, 2) row-stochastic, rows=from-state
    persistence_hat: float      # mean straggle sojourn, 1/P(S->A)
    steps: int


class OnlineStragglerEstimator:
    """Running estimate of the straggler process from observed masks.

    p-hat is the posterior-mean straggle fraction under a
    Beta(prior_weight * prior_p, prior_weight * (1 - prior_p)) prior
    over machine-rounds -- the prior keeps early decisions sane (and
    ``estimate()`` total before any mask arrives) without biasing the
    long-run limit. The transition matrix is counted over consecutive
    masks per machine with Laplace (+1) smoothing per row, so
    ``persistence_hat`` is finite even before a straggle->alive exit
    has been observed.
    """

    def __init__(self, m: int, *, prior_p: float = 0.1,
                 prior_weight: float = 4.0):
        if m <= 0:
            raise ValueError(f"m must be positive, got {m}")
        if not 0.0 <= prior_p < 1.0:
            raise ValueError(f"prior_p must be in [0, 1), got {prior_p}")
        if prior_weight <= 0:
            raise ValueError("prior_weight must be positive")
        self.m = m
        self.prior_p = float(prior_p)
        self.prior_weight = float(prior_weight)
        self.steps = 0
        self._machine_rounds = 0
        self._straggled = 0
        self._trans = np.zeros((2, 2), dtype=np.int64)
        self._prev_straggle: Optional[np.ndarray] = None

    def observe(self, alive: np.ndarray) -> None:
        alive = np.asarray(alive, dtype=bool)
        if alive.shape != (self.m,):
            raise ValueError(f"mask must be ({self.m},), got {alive.shape}")
        straggle = ~alive
        self.steps += 1
        self._machine_rounds += self.m
        self._straggled += int(straggle.sum())
        prev = self._prev_straggle
        if prev is not None:
            self._trans[ALIVE, ALIVE] += int(np.sum(~prev & ~straggle))
            self._trans[ALIVE, STRAGGLE] += int(np.sum(~prev & straggle))
            self._trans[STRAGGLE, ALIVE] += int(np.sum(prev & ~straggle))
            self._trans[STRAGGLE, STRAGGLE] += int(np.sum(prev & straggle))
        self._prev_straggle = straggle.copy()

    def estimate(self) -> StragglerEstimate:
        p_hat = ((self.prior_weight * self.prior_p + self._straggled)
                 / (self.prior_weight + self._machine_rounds))
        trans = (self._trans + 1).astype(np.float64)  # Laplace smoothing
        trans /= trans.sum(axis=1, keepdims=True)
        persistence = 1.0 / max(trans[STRAGGLE, ALIVE], 1e-9)
        return StragglerEstimate(p_hat=float(p_hat),
                                 transition_hat=trans,
                                 persistence_hat=float(persistence),
                                 steps=self.steps)


@dataclasses.dataclass(frozen=True)
class PolicyDecision:
    """One step's decoding choice: which decoder, with which p, and
    how deep a lookahead is worth prefetching."""

    method: str          # "optimal" | "fixed"
    p: float             # p fed to the decoder (fixed weights need it)
    lookahead: int = 1   # suggested prefetch horizon, >= 1


class DecodingPolicy:
    def decide(self, estimate: StragglerEstimate) -> PolicyDecision:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class StaticPolicy(DecodingPolicy):
    """The pre-adaptive behaviour as a policy: a fixed decision every
    step, ignoring the estimate. ``StaticPolicy("optimal", p)`` is the
    omniscient baseline; a grid of ``StaticPolicy("fixed", p)`` over
    candidate p values is the comparison set the adaptive policy must
    beat in the BENCH_sweep.json regret row."""

    method: str = "optimal"
    p: float = 0.0
    lookahead: int = 1

    def __post_init__(self):
        if self.method not in ("optimal", "fixed"):
            raise ValueError(f"unknown method {self.method!r}")
        if self.lookahead < 1:
            raise ValueError("lookahead must be >= 1")

    def decide(self, estimate: StragglerEstimate) -> PolicyDecision:
        return PolicyDecision(method=self.method, p=self.p,
                              lookahead=self.lookahead)


@dataclasses.dataclass(frozen=True)
class AdaptivePolicy(DecodingPolicy):
    """Estimate-driven per-step decoding.

    - Decoder: Section VIII's fixed weights are a near-free
      approximation of the optimal decode when stragglers are rare
      (w = 1/(d(1-p)) -> 1/d as p -> 0, and with every machine alive
      the optimal decode *is* uniform 1/d for a regular scheme), so
      below ``threshold`` the policy decodes fixed with p = p-hat; at
      or above it, the optimal decoder's accuracy is worth the O(m)
      component sweep. p-hat is quantized to ``P_HAT_DECIMALS`` so the
      runtime's decode memo keys repeat.
    - Lookahead: under a stagnant straggler set (Section VIII), masks
      repeat for ~persistence steps, so prefetching that many rounds
      of weights is free accuracy for the overlap engine; capped at
      ``max_lookahead``.
    """

    threshold: float = 0.05
    max_lookahead: int = 8

    def __post_init__(self):
        if not 0.0 <= self.threshold <= 1.0:
            raise ValueError("threshold must be in [0, 1]")
        if self.max_lookahead < 1:
            raise ValueError("max_lookahead must be >= 1")

    def decide(self, estimate: StragglerEstimate) -> PolicyDecision:
        p_hat = round(min(max(estimate.p_hat, 0.0), 0.999),
                      P_HAT_DECIMALS)
        method = "optimal" if p_hat >= self.threshold else "fixed"
        lookahead = int(np.clip(round(estimate.persistence_hat), 1,
                                self.max_lookahead))
        return PolicyDecision(method=method, p=p_hat, lookahead=lookahead)


POLICIES = ("adaptive", "always_optimal", "always_fixed")


def make_policy(spec, *, p: float = 0.0) -> DecodingPolicy:
    """Config-string -> policy (pass a ``DecodingPolicy`` through).

    ``always_optimal`` / ``always_fixed`` are the static anchors --
    the former is the omniscient baseline and the bit-identity pin for
    ``CodingRuntime(adaptive=...)``; ``p`` parameterizes them (the
    true p when known, as in the runtime's config)."""
    if isinstance(spec, DecodingPolicy):
        return spec
    if spec == "adaptive":
        return AdaptivePolicy()
    if spec == "always_optimal":
        return StaticPolicy(method="optimal", p=p)
    if spec == "always_fixed":
        return StaticPolicy(method="fixed", p=p)
    raise ValueError(f"unknown policy {spec!r}; known: {POLICIES}")


def replay_policy(assignment: Assignment, masks, policy: DecodingPolicy,
                  *, prior_p: float = 0.1,
                  prior_weight: float = 4.0) -> Dict[str, np.ndarray]:
    """Replay a recorded (T, m) mask stream under one policy.

    Per round: decide from the estimator's *past-only* state, decode
    the round's mask with that decision, then observe the mask -- the
    exact protocol ``CodingRuntime`` runs online, so replayed errors
    match what the runtime would have realized. Returns per-step
    normalized errors plus the decision trace (methods, ps,
    lookaheads) for burn-in analysis.
    """
    masks = np.asarray(masks, dtype=bool)
    if masks.ndim != 2 or masks.shape[1] != assignment.m:
        raise ValueError(f"masks must be (T, {assignment.m}), "
                         f"got {masks.shape}")
    est = OnlineStragglerEstimator(assignment.m, prior_p=prior_p,
                                   prior_weight=prior_weight)
    errors = np.zeros(masks.shape[0])
    methods, ps, lookaheads = [], [], []
    for t, alive in enumerate(masks):
        decision = policy.decide(est.estimate())
        res = decode(assignment, alive, method=decision.method,
                     p=decision.p)
        errors[t] = normalized_error(res.alpha)
        methods.append(decision.method)
        ps.append(decision.p)
        lookaheads.append(decision.lookahead)
        est.observe(alive)
    return {"errors": errors, "methods": np.array(methods),
            "ps": np.array(ps), "lookaheads": np.array(lookaheads)}


def policy_regret_report(assignment: Assignment, masks,
                         policies: Dict[str, DecodingPolicy], *,
                         burn_in: int = 0) -> Dict[str, Dict[str, float]]:
    """Mean error + regret per policy over one shared mask stream.

    The omniscient baseline is the always-optimal static policy:
    optimal decoding minimizes ||A w - 1|| over all w supported on the
    live machines, so no per-step method choice can beat it pointwise
    -- regret >= 0 up to float rounding for every policy. ``burn_in``
    drops the first rounds from the means (the estimator's prior
    dominates there), matching how the benchmark row scores the
    adaptive policy's steady state.
    """
    masks = np.asarray(masks, dtype=bool)
    if burn_in < 0 or burn_in >= masks.shape[0]:
        raise ValueError(f"burn_in must be in [0, {masks.shape[0]}), "
                         f"got {burn_in}")
    omniscient = replay_policy(assignment, masks,
                               StaticPolicy(method="optimal"))
    base = float(np.mean(omniscient["errors"][burn_in:]))
    report: Dict[str, Dict[str, float]] = {
        "omniscient": {"mean_error": base, "regret": 0.0}}
    for name, policy in policies.items():
        replay = replay_policy(assignment, masks, policy)
        mean = float(np.mean(replay["errors"][burn_in:]))
        report[name] = {"mean_error": mean, "regret": mean - base}
    return report
