"""Plain PyTorch versions of the three combines (the CUDA kernels'
oracles), and the exact float64 NumPy references of the quantized
combines.

Each plain version is the accumulation chain ``acc = acc + u[b] * x[b]``
over the rows in order, in float32, one rounded multiply and one rounded
add per row -- the arithmetic the kernels do, so on the card a kernel
and its plain version agree bit for bit. The reference's own
``coded_combine`` ref is an einsum (``w @ g``), which sums in another
order; the two agree to float32 rounding.
"""

import numpy as np
import torch


def _chain(rows, u: torch.Tensor, to_f32) -> torch.Tensor:
    acc = None
    for b in range(u.shape[0]):
        term = u[b] * to_f32(rows[b])
        acc = torch.zeros_like(term) + term if acc is None else acc + term
    return acc


def coded_combine(grads: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out = sum_b w[b] * grads[b]: grads (n, D), w (n,); float32
    accumulation, output in grads.dtype."""
    if grads.shape[0] == 0:
        return torch.zeros(grads.shape[1:], dtype=grads.dtype,
                           device=grads.device)
    return _chain(grads, w.float(), lambda r: r.float()).to(grads.dtype)


def quantized_combine(q: torch.Tensor, scales: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """Dequantize-weight-combine: q (n, D) int8 (or float32) payload,
    scales and w (n,) -> (D,) float32, with u = w * scales folded first.
    No float32 (n, D) tile is formed: one row is converted at a time."""
    u = w.float() * scales.float()
    if q.shape[0] == 0:
        return torch.zeros(q.shape[1], device=q.device)
    return _chain(q, u, lambda r: r.float())


def packed_sign_combine(q: torch.Tensor, scales: torch.Tensor,
                        w: torch.Tensor, d: int) -> torch.Tensor:
    """q (n, ceil(d/8)) uint8 little-endian bit planes (bit 1 is +1),
    scales and w (n,) -> (d,) float32. Padding bits (positions >= d)
    are dropped."""
    u = w.float() * scales.float()
    if q.shape[0] == 0:
        return torch.zeros(d, device=q.device)
    shifts = torch.arange(8, dtype=torch.uint8, device=q.device)

    def signs(row):
        bits = ((row[:, None] >> shifts) & 1).reshape(-1)[:d]
        return 2.0 * bits.float() - 1.0
    return _chain(q, u, signs)


def quantized_combine_np(q: np.ndarray, scales: np.ndarray,
                         w: np.ndarray) -> np.ndarray:
    """The exact combine in float64, rounded once to float32 (the
    reference's ``ref.quantized_combine_np``). ``u_b = w_b * s_b`` is one
    float32 multiply; a float32 product is exact in float64. On
    power-of-two w and scales with integer payloads every float32
    partial sum is exact too, so a float32 kernel must match this bit
    for bit there."""
    u = (np.asarray(w, np.float32)
         * np.asarray(scales, np.float32)).astype(np.float64)
    acc = np.zeros(np.asarray(q).shape[1], np.float64)
    for b in range(q.shape[0]):
        acc = acc + u[b] * np.asarray(q[b]).astype(np.float64)
    return acc.astype(np.float32)


def packed_sign_combine_np(q: np.ndarray, scales: np.ndarray,
                           w: np.ndarray, d: int) -> np.ndarray:
    """Exact float64 oracle of ``packed_sign_combine``, unpacked by
    ``np.unpackbits(bitorder="little")`` -- independent of the shifts
    above, so it checks the bit order as well as the arithmetic."""
    u = (np.asarray(w, np.float32)
         * np.asarray(scales, np.float32)).astype(np.float64)
    bits = np.unpackbits(np.asarray(q, np.uint8), axis=1,
                         bitorder="little")[:, :d]
    signs = 2.0 * bits.astype(np.float64) - 1.0
    acc = np.zeros(d, np.float64)
    for b in range(q.shape[0]):
        acc = acc + u[b] * signs[b]
    return acc.astype(np.float32)
