"""ctypes binding of ``csrc/spectral_matvec.cu`` (built by
``kernels.build``): the Gram matvec X^T (X V^T) over one operand or a
stack of them, on the card only."""

from __future__ import annotations

import ctypes

import torch

from .. import _launch, build

_MAX_SMEM_FLOATS = 12288   # kMaxSmemFloats in the source: rows * bv
_TARGET_CTAS = 2 * 132     # two CTAs per SM of an H100 SXM
_typed = set()


def _lib() -> ctypes.CDLL:
    lib = build.load("spectral_matvec")
    if "spectral_matvec" not in _typed:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.gram_matvec_launch.argtypes = [P, P, P, P, I, I, I, I, I, P]
        lib.gram_matvec_launch.restype = I
        lib.spectral_matvec_error_string.argtypes = [I]
        lib.spectral_matvec_error_string.restype = ctypes.c_char_p
        _typed.add("spectral_matvec")
    return lib


def rows_per_strip(R: int, B: int, bv: int) -> int:
    """Rows of X per CTA: enough strips to give the card about two CTAs
    per SM over all B slices, few enough that the (strips, B, bv, k)
    partials stay within an eighth of X, and no more rows than the
    (rows, bv) projection tile can hold in shared memory."""
    target = max(1, -(-_TARGET_CTAS // B))
    strips = max(1, min(target, R // (8 * bv), R))
    return min(-(-R // strips), _MAX_SMEM_FLOATS // bv)


def _gram(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """x (B, R, k), v (B, bv, k), float32 on the card -> (B, bv, k)."""
    for t, what in ((x, "x"), (v, "v")):
        if t.device.type != "cuda":
            raise ValueError(f"gram_matvec {what} must be a CUDA tensor, "
                             f"got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"gram_matvec: {what} must be float32, got "
                            f"{t.dtype}")
    x, v = x.contiguous(), v.contiguous()
    B, R, k = x.shape
    bv = v.shape[1]
    if v.shape != (B, bv, k) or v.device != x.device:
        raise ValueError(f"gram_matvec: v must be ({B}, bv, {k}) on "
                         f"{x.device}, got {tuple(v.shape)}")
    if min(B, R, k, bv) < 1 or bv > _MAX_SMEM_FLOATS:
        raise ValueError(f"gram_matvec: need B, R, k >= 1 and 1 <= bv <= "
                         f"{_MAX_SMEM_FLOATS}, got x {tuple(x.shape)} and "
                         f"{bv} right-hand sides")
    out = torch.empty((B, bv, k), dtype=torch.float32, device=x.device)
    rows = rows_per_strip(R, B, bv)
    strips = -(-R // rows)
    partial = torch.empty((strips, B, bv, k), dtype=torch.float32,
                          device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.gram_matvec_launch(
            x.data_ptr(), v.data_ptr(), partial.data_ptr(), out.data_ptr(),
            B, R, k, bv, rows, _launch.stream_handle(x.device))
    _launch.raise_on_error(rc, lib.spectral_matvec_error_string)
    return out


def gram_matvec(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """x (R, k); v (k,) or (bv, k) -> float32 X^T (X v): (k,) for a 1-D
    v, (bv, k) for stacked right-hand sides (the block-Lanczos form)."""
    vec = v.ndim == 1
    out = _gram(x[None], v.reshape(1, -1, x.shape[1]))[0]
    return out[0] if vec else out


def gram_matvec_batch(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """x (B, R, k); v (B, k) -> (B, k) float32 per-slice X_b^T (X_b v_b):
    the lockstep-Lanczos form, one launch pair for the whole stack."""
    return _gram(x, v[:, None, :])[:, 0]
