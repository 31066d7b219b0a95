"""Closed-form theoretical bounds from the paper, used by tests and
benchmarks to validate the implementation against the paper's claims.
Copy of ``repro.core.theory``.
"""

from __future__ import annotations

import numpy as np


def lower_bound_any_decoding(p: float, d: float) -> float:
    """Prop A.3: (1/n) E|alpha-bar - 1|^2 >= p^d / (1 - p^d) for any
    unbiased decoding with replication factor d. The FRC meets this."""
    pd = p ** d
    return pd / (1.0 - pd)


def lower_bound_fixed_decoding(p: float, d: float) -> float:
    """Prop A.1: fixed-coefficient unbiased decoding has
    (1/n) E|alpha-bar - 1|^2 >= p / (d (1 - p))."""
    return p / (d * (1.0 - p))


def lower_bound_fixed_cov(p: float, d: float) -> float:
    """Remark A.2: |Cov(alpha-bar)|_2 >= 2p/(d(1-p)) for graph schemes."""
    return 2.0 * p / (d * (1.0 - p))


def adversarial_bound_graph(p: float, d: float, lam: float) -> float:
    """Cor V.2: for a d-regular graph scheme with spectral expansion
    lambda, worst-case (1/n)|alpha - 1|^2 <= (2d - lam)/(2d) * p/(1-p)."""
    return (2.0 * d - lam) / (2.0 * d) * p / (1.0 - p)


def adversarial_bound_ramanujan(p: float, d: float) -> float:
    """Cor V.3 with lam = d - o(d): ~ p / (2 (1 - p))."""
    return 0.5 * p / (1.0 - p)


def adversarial_lower_bound_graph(p: float) -> float:
    """Remark V.4: any graph scheme suffers >= p/2 (isolating mp/d
    vertices)."""
    return p / 2.0


def frc_adversarial_error(p: float) -> float:
    """Table I: the FRC's worst case is p (whole groups erased)."""
    return p


def frc_random_error(p: float, d: float) -> float:
    """[8]: the FRC achieves the Prop A.3 optimum exactly."""
    return lower_bound_any_decoding(p, d)


def sgd_iterations_bound(eps: float, eps0: float, mu: float, L: float,
                         Lp: float, r: float, s: float, n: int) -> float:
    """Cor VI.2: iterations for SGD-ALG to reach E|x_k - x*|^2 <= eps.

    r = (1/n) E|beta - 1|^2, s = |Cov(beta)|_2, sigma^2 folded into r
    via the caller (we expose the raw formula; sigma^2 enters the last
    term)."""
    raise NotImplementedError("use sgd_iterations with explicit sigma2")


def sgd_iterations(eps: float, eps0: float, mu: float, L: float, Lp: float,
                   r: float, s: float, n: int, sigma2: float) -> float:
    """Cor VI.2 iteration count."""
    return 2.0 * np.log(2.0 * eps0 / eps) * (
        s * Lp / mu + L / mu
        + r * (1.0 + 1.0 / (n - 1)) * sigma2 / (mu ** 2 * eps))


def sgd_step_size(eps: float, mu: float, L: float, Lp: float, r: float,
                  s: float, n: int, sigma2: float) -> float:
    """Cor VI.2 step size."""
    return mu * eps / (2 * mu * eps * (s * Lp + L)
                       + 2 * r * (1 + 1 / (n - 1)) * sigma2)


def adversarial_noise_floor(mu: float, Lp: float, r: float,
                            sigma2: float) -> float:
    """Cor VII.2: |theta_k - theta*|^2 converges to
    <= 4 r sigma^2 / (mu - sqrt(mu r L'))^2, provided mu > r L'."""
    gap = mu - np.sqrt(mu * r * Lp)
    if gap <= 0:
        return np.inf
    return 4.0 * r * sigma2 / gap ** 2
