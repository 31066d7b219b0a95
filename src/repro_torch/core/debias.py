"""Proposition B.1: black-box debiasing of any assignment scheme.

Given any (A, w) scheme with (1/N) E|alpha - 1|^2 <= eps, construct
(A-hat, w) with E[alpha-hat] = 1 at the cost of at most doubling the
computational load: keep the rows with E[alpha_i] >= delta = 1 -
sqrt(2 eps), rescale each row i by 1/E[alpha_i], and re-fill the dropped
rows by duplicating the first t retained rows.

Copy of ``repro.core.debias``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from .assignment import Assignment


def estimate_mean_alpha(assignment: Assignment,
                        decode_fn: Callable[[np.ndarray], np.ndarray],
                        p: float, trials: int = 200,
                        seed: int = 0) -> np.ndarray:
    """Monte-Carlo E[alpha] under Bernoulli(p) stragglers; decode_fn maps
    an alive mask to alpha."""
    rng = np.random.default_rng(seed)
    acc = np.zeros(assignment.n, dtype=np.float64)
    for _ in range(trials):
        alive = rng.random(assignment.m) >= p
        acc += decode_fn(alive)
    return acc / trials


def debias_assignment(assignment: Assignment, mean_alpha: np.ndarray,
                      eps: float) -> Assignment:
    """Prop B.1 construction. ``mean_alpha`` is E[alpha] (exact or
    estimated); ``eps`` the normalized decoding error bound."""
    if eps >= 0.5:
        raise ValueError("Prop B.1 needs eps < 1/2")
    delta = 1.0 - np.sqrt(2.0 * eps)
    keep = np.nonzero(mean_alpha >= delta)[0]
    n = assignment.n
    if keep.size < (n + 1) // 2:
        raise ValueError(
            f"only {keep.size}/{n} rows have E[alpha] >= {delta:.3f}; "
            "eps bound violated")
    D = 1.0 / mean_alpha[keep]
    A_s = assignment.A[keep] * D[:, None]
    t = n - keep.size
    A_hat = np.vstack([A_s, A_s[:t]])
    return Assignment(A=A_hat, name=assignment.name + "+debiased",
                      graph=None)
