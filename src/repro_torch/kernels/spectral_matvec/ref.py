"""Plain versions of the tall-skinny Gram matvec.

The ``*_np`` functions are the reference's float64 NumPy oracles, copied:
the CPU path of the matrix-free spectral pipeline, where float64 is what
lets the matrix-free covariance norm match the dense SVD to ~1e-8
relative and keeps every row bit-identical to ``repro.core``. The torch
functions are the plain float32 versions of the CUDA kernel (products
and sums written out, no matrix-product call), which the kernel is held
against on the card.
"""

import numpy as np
import torch


def gram_matvec_np(x: np.ndarray, v: np.ndarray) -> np.ndarray:
    """x: (R, k), v: (k,) -> x^T (x v), all float64.

    Two passes over x (the tall operand) and never materializes the
    (k, k) Gram matrix -- O(R * k) per call.
    """
    x = np.asarray(x, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)
    return x.T @ (x @ v)


def gram_matvec_block_np(x: np.ndarray, V: np.ndarray) -> np.ndarray:
    """x: (R, k), V: (k, b) -> x^T (x V), all float64.

    The block-Lanczos form of the Gram matvec (b right-hand sides per
    sweep over x); still never materializes the (k, k) Gram matrix.
    """
    x = np.asarray(x, dtype=np.float64)
    V = np.asarray(V, dtype=np.float64)
    return x.T @ (x @ V)


def gram_matvec_batch_np(x: np.ndarray, v: np.ndarray) -> np.ndarray:
    """x: (B, R, k), v: (B, k) -> (B, k) per-slice x_b^T (x_b v_b), the
    per-slice GEMV loop (definitionally consistent with the single-slice
    oracle)."""
    x = np.asarray(x, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)
    if x.shape[0] == 0:
        return np.zeros_like(v)
    return np.stack([gram_matvec_np(x[i], v[i]) for i in range(x.shape[0])])


def gram_matvec(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """x (R, k); v (k,) or (bv, k) -> float32 X^T (X v), shaped like the
    kernel's: y = X V^T row by row, then y^T X."""
    vec = v.ndim == 1
    x = x.float()
    V = v.float().reshape(-1, x.shape[1])
    y = (x[:, None, :] * V[None]).sum(-1)             # (R, bv)
    out = (y[:, :, None] * x[:, None, :]).sum(0)      # (bv, k)
    return out[0] if vec else out


def gram_matvec_batch(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """x (B, R, k); v (B, k) -> (B, k) float32 per-slice X_b^T (X_b v_b)."""
    x = x.float()
    y = (x * v.float()[:, None, :]).sum(-1)           # (B, R)
    return (y[..., None] * x).sum(1)
