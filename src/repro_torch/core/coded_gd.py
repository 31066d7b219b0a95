"""Algorithms 2 & 3: coded gradient descent (logical view).

``GCOD`` simulates Algorithm 2 exactly: at each round a straggler mask is
sampled, the parameter server decodes w*, and the update uses
sum_j w*_j g_j. ``sgd_alg`` is Algorithm 3, the stochastically equivalent
form parameterised by the distribution of alpha, used for the m=6552
simulations in Section VIII-B.

This module is the *single-host* reference; ``repro_torch.dist.coded_train``
implements the same update on model gradients. Copy of
``repro.core.coded_gd``; ``device`` is handed to the batched decoder.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np

from .assignment import Assignment
from .batched_decoding import batched_alpha
from .step_weights import sample_mask_stream as _sample_mask_stream
from .stragglers import StragglerModel, BernoulliStragglers


@dataclasses.dataclass
class LeastSquares:
    """min_theta |X theta - Y|_2^2 partitioned into n blocks (Section
    VIII data model). f_i = sum over block i of (x^T theta - y)^2."""

    X: np.ndarray
    Y: np.ndarray
    n_blocks: int

    def __post_init__(self):
        N = self.X.shape[0]
        if N % self.n_blocks:
            raise ValueError("n_blocks must divide N")
        self.block_size = N // self.n_blocks

    @classmethod
    def synthetic(cls, N: int, k: int, noise: float, n_blocks: int,
                  seed: int = 0) -> "LeastSquares":
        rng = np.random.default_rng(seed)
        X = rng.normal(size=(N, k)) / np.sqrt(k)
        theta = rng.normal(size=k)
        Y = X @ theta + noise * rng.normal(size=N)
        return cls(X=X, Y=Y, n_blocks=n_blocks)

    def minimizer(self) -> np.ndarray:
        return np.linalg.lstsq(self.X, self.Y, rcond=None)[0]

    def block_gradients(self, theta: np.ndarray) -> np.ndarray:
        """(n_blocks, k) matrix of per-block gradients of f_i."""
        resid = self.X @ theta - self.Y  # (N,)
        per_point = 2.0 * self.X * resid[:, None]  # (N, k)
        return per_point.reshape(self.n_blocks, self.block_size, -1).sum(1)

    def loss(self, theta: np.ndarray) -> float:
        return float(np.sum((self.X @ theta - self.Y) ** 2))


@dataclasses.dataclass
class GDTrace:
    thetas: List[np.ndarray]
    errors: List[float]  # |theta_t - theta*|^2
    alphas: List[np.ndarray]


def precompute_alphas(assignment: Assignment,
                      straggler_model: StragglerModel, *, steps: int,
                      method: str = "optimal", p: float = 0.0,
                      shuffle: bool = True, seed: int = 0,
                      backend: str = "auto",
                      device=None) -> np.ndarray:
    """Sample the exact mask stream ``gcod(..., shuffle=shuffle,
    seed=seed)`` would consume and decode it in one batched call.

    Feeding the result back via ``gcod(..., alphas=...)`` reproduces the
    sampling-in-the-loop run bit-for-bit while skipping per-step
    decoding -- useful when the same (assignment, model, seed) trace is
    re-run across a step-size grid, as the Figure 4/5 harness does.
    """
    rng = np.random.default_rng(seed)
    _, masks = _sample_mask_stream(assignment, straggler_model,
                                   steps=steps, shuffle=shuffle, rng=rng)
    return batched_alpha(assignment, masks, method=method, p=p,
                         backend=backend, device=device)


def gcod(problem: LeastSquares, assignment: Assignment,
         straggler_model: StragglerModel, *, steps: int, lr: float,
         method: str = "optimal", p: float = 0.0,
         shuffle: bool = True, seed: int = 0,
         theta0: Optional[np.ndarray] = None,
         lr_schedule: Optional[Callable[[int], float]] = None,
         alphas: Optional[np.ndarray] = None,
         backend: str = "auto", device=None) -> GDTrace:
    """Algorithm 2 (GCOD). ``method`` selects optimal vs fixed decoding;
    ``shuffle`` applies the random block permutation rho.

    All straggler masks are sampled up front and decoded by the batched
    engine (the straggler model only touches the RNG while sampling, so
    this reorders nothing). ``alphas`` (steps, n) bypasses sampling and
    decoding entirely -- see ``precompute_alphas``.
    """
    rng = np.random.default_rng(seed)
    n = assignment.n
    if problem.n_blocks != n:
        raise ValueError("problem blocks must match assignment rows")
    # With precomputed alphas no masks are drawn (steps=0), leaving the
    # rho draw -- and hence the trajectory -- identical either way.
    rho, masks = _sample_mask_stream(
        assignment, straggler_model, shuffle=shuffle, rng=rng,
        steps=steps if alphas is None else 0)
    if alphas is None:
        alphas = batched_alpha(assignment, masks, method=method, p=p,
                               backend=backend, device=device)
    else:
        alphas = np.asarray(alphas, dtype=np.float64)
        if alphas.shape != (steps, n):
            raise ValueError(
                f"alphas must be ({steps}, {n}), got {alphas.shape}")
    theta_star = problem.minimizer()
    theta = np.zeros(problem.X.shape[1]) if theta0 is None else theta0.copy()
    trace = GDTrace(thetas=[theta.copy()],
                    errors=[float(np.sum((theta - theta_star) ** 2))],
                    alphas=[])
    for t in range(steps):
        alpha = alphas[t]
        # alpha acts on shuffled blocks: block rho(i) receives alpha_i.
        block_grads = problem.block_gradients(theta)  # (n, k)
        g = (alpha[:, None] * block_grads[rho]).sum(axis=0)
        step = lr if lr_schedule is None else lr_schedule(t)
        theta = theta - step * g
        trace.thetas.append(theta.copy())
        trace.errors.append(float(np.sum((theta - theta_star) ** 2)))
        trace.alphas.append(alpha.copy())
    return trace


def uncoded_gd(problem: LeastSquares, m: int, p: float, *, steps: int,
               lr: float, seed: int = 0,
               lr_schedule: Optional[Callable[[int], float]] = None,
               alphas: Optional[np.ndarray] = None,
               device=None) -> GDTrace:
    """Ignore-stragglers baseline: m machines, one block each, surviving
    gradients summed with weight 1/(1-p) (unbiased)."""
    from .assignment import uncoded_assignment

    assignment = uncoded_assignment(m)
    model = BernoulliStragglers(m=m, p=p)
    return gcod(problem, assignment, model, steps=steps, lr=lr,
                method="fixed", p=p, seed=seed, lr_schedule=lr_schedule,
                alphas=alphas, device=device)


def sgd_alg(problem: LeastSquares,
            sample_beta: Optional[
                Callable[[np.random.Generator], np.ndarray]] = None, *,
            steps: int, lr: float, shuffle: bool = True, seed: int = 0,
            lr_schedule: Optional[Callable[[int], float]] = None,
            betas: Optional[np.ndarray] = None) -> GDTrace:
    """Algorithm 3 (SGD-ALG): update with externally supplied beta
    draws. Stochastically equivalent to GCOD when beta ~ P_{alpha*}.

    Betas come either from ``sample_beta`` (one draw per step, as
    before) or as a precomputed ``betas`` (steps, n) batch, e.g. from
    ``precompute_alphas`` / ``batched_alpha``.
    """
    if (sample_beta is None) == (betas is None):
        raise ValueError("provide exactly one of sample_beta / betas")
    if betas is not None:
        betas = np.asarray(betas, dtype=np.float64)
        if betas.shape != (steps, problem.n_blocks):
            raise ValueError(
                f"betas must be ({steps}, {problem.n_blocks}), "
                f"got {betas.shape}")
    rng = np.random.default_rng(seed)
    n = problem.n_blocks
    rho = rng.permutation(n) if shuffle else np.arange(n)
    theta_star = problem.minimizer()
    theta = np.zeros(problem.X.shape[1])
    trace = GDTrace(thetas=[theta.copy()],
                    errors=[float(np.sum((theta - theta_star) ** 2))],
                    alphas=[])
    for t in range(steps):
        beta = betas[t] if betas is not None else sample_beta(rng)
        block_grads = problem.block_gradients(theta)
        g = (beta[:, None] * block_grads[rho]).sum(axis=0)
        step = lr if lr_schedule is None else lr_schedule(t)
        theta = theta - step * g
        trace.thetas.append(theta.copy())
        trace.errors.append(float(np.sum((theta - theta_star) ** 2)))
        trace.alphas.append(beta)
    return trace
