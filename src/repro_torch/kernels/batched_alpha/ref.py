"""Plain versions of the fused debias + error reduction.

``fused_error_np`` is the reference's float64 NumPy oracle, copied: the
CPU path of the Monte-Carlo pipeline, which keeps ``monte_carlo_error``
bit-identical to ``repro.core`` off the card. ``fused_error`` is the
plain float32 torch version of the CUDA kernel (same arithmetic, another
summation order), which the kernel is held against on the card.
"""

import numpy as np
import torch


def fused_error_np(alphas: np.ndarray, scale: float) -> np.ndarray:
    """errs_t = (1/n) |scale * alpha_t - 1|_2^2.

    alphas: (trials, n) float64; scale: the debias factor
    sqrt(n)/|E[alpha]|_2 (or 1.0). Returns (trials,) float64.
    """
    d = alphas * scale - 1.0
    return np.mean(d * d, axis=1)


def fused_error(alphas: torch.Tensor, scale: float) -> torch.Tensor:
    """alphas (trials, n) float32 -> (trials,) float32: the kernel's
    d = a * scale - 1, sum of d * d, times float32(1/n)."""
    d = alphas.float() * float(np.float32(scale)) - 1.0
    return (d * d).sum(dim=1) * float(np.float32(1.0 / alphas.shape[1]))
