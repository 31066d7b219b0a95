"""Straggler-sample -> decode -> step weights: the host pipeline.

Copy of the part of ``repro.core.step_weights`` that serving reaches:
the straggler-model factory, per-mask machine weights w* and alpha
(``step_weights``), the per-block combine weights v = A @ w
(``block_weights``), the serving support predicate
(``served_blocks``) and the batched form (``batched_step_weights``).
The mask sources and the Monte-Carlo debias scale wait for the
training slice. All of it is NumPy, so seeded streams are bit-identical
to the reference.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .assignment import Assignment
from .batched_decoding import batched_fixed_alpha, fixed_w
from .decoding import decode
from .stragglers import (AdversarialStragglers, BernoulliStragglers,
                         FixedCountStragglers, MarkovStragglers,
                         StragglerModel)

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
