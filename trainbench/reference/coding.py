"""Plain NumPy coding: the block assignment, the optimal decoder, the
alpha-bar debias scale and the block shuffle, from the definitions of
Glasgow & Wootters, "Approximate Gradient Coding with Optimal Decoding"
(arXiv:2006.09638).

- A graph scheme puts data blocks on the vertices of a d-regular graph and
  coded machines on its edges: machine j holds the blocks at the two ends
  of edge j, so A (n blocks x m machines) has two ones a column. At d = 2
  the graph is the cycle C_n, n = 2m/d, with edge j = (j, j + 1 mod n).
- Optimal decoding picks the machine weights w, zero on stragglers, that
  minimise |A w - 1|_2; alpha = A w is unique (the projection of 1 onto
  the span of the arrived machines' columns) even where w is not.
- The debias scale is |1|_2 / |E[alpha]|_2, with E[alpha] the mean over
  256 Bernoulli(p) straggler masks drawn from ``seed + 0x5EED``, where a
  machine straggles when its uniform draw is below p.
- The blocks are taken from the global batch in the order of a seeded
  permutation rho (the paper's Algorithm 2 shuffle).

Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np

DEBIAS_TRIALS = 256
DEBIAS_SEED_OFFSET = 0x5EED


def assignment(scheme: str, m: int, d: int) -> np.ndarray:
    """(n, m) block-by-machine matrix."""
    if scheme != "expander" or d != 2:
        raise NotImplementedError(
            f"the plain reference knows the expander at d = 2 (the cycle), "
            f"not {scheme} at d = {d}")
    n = 2 * m // d
    A = np.zeros((n, m))
    for j in range(m):
        A[j, j] = 1.0
        A[(j + 1) % n, j] = 1.0
    return A


def optimal_alpha(A: np.ndarray, alive: np.ndarray) -> np.ndarray:
    """alpha = A w* with w* = argmin_{w: w_j = 0 off alive} |A w - 1|."""
    alive = np.asarray(alive, bool)
    n = A.shape[0]
    if not alive.any():
        return np.zeros(n)
    cols = A[:, alive]
    w, *_ = np.linalg.lstsq(cols, np.ones(n), rcond=None)
    return cols @ w


def debias_scale(A: np.ndarray, p: float, seed: int) -> float:
    m = A.shape[1]
    u = np.random.default_rng(seed + DEBIAS_SEED_OFFSET).random(
        (DEBIAS_TRIALS, m))
    mean = np.mean([optimal_alpha(A, row >= p) for row in u], axis=0)
    return float(np.sqrt(A.shape[0]) / max(np.linalg.norm(mean), 1e-30))


def block_order(n: int, seed: int) -> np.ndarray:
    """rho: block i of the step is the global batch's block rho[i]."""
    return np.random.default_rng(seed).permutation(n)
