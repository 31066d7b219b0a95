"""ctypes binding of ``csrc/batched_alpha.cu`` (built by
``kernels.build``): the fused debias + error reduction, on the card
only."""

from __future__ import annotations

import ctypes

import torch

from .. import _launch, build

_typed = set()


def _lib() -> ctypes.CDLL:
    lib = build.load("batched_alpha")
    if "batched_alpha" not in _typed:
        P, F, L = ctypes.c_void_p, ctypes.c_float, ctypes.c_longlong
        lib.fused_error_launch.argtypes = [P, F, F, P, L, L, P]
        lib.fused_error_launch.restype = ctypes.c_int
        lib.batched_alpha_error_string.argtypes = [ctypes.c_int]
        lib.batched_alpha_error_string.restype = ctypes.c_char_p
        _typed.add("batched_alpha")
    return lib


def fused_error(alphas: torch.Tensor, scale: float) -> torch.Tensor:
    """alphas (trials, n) float32 on the card, scale a Python float ->
    (trials,) float32 errors (1/n)|scale * alpha_t - 1|^2, with the
    scale and 1/n rounded to float32 as the TPU kernel rounds them."""
    if alphas.ndim != 2:
        raise ValueError(f"fused_error: alphas must be (trials, n), got "
                         f"{tuple(alphas.shape)}")
    if alphas.device.type != "cuda":
        raise ValueError(f"fused_error alphas must be a CUDA tensor, got "
                         f"{alphas.device}")
    if alphas.dtype != torch.float32:
        raise TypeError(f"fused_error: alphas must be float32, got "
                        f"{alphas.dtype}")
    alphas = alphas.contiguous()
    trials, n = alphas.shape
    out = torch.empty(trials, dtype=torch.float32, device=alphas.device)
    lib = _lib()
    with torch.cuda.device(alphas.device):
        rc = lib.fused_error_launch(
            alphas.data_ptr(), float(scale), 1.0 / n, out.data_ptr(),
            trials, n, _launch.stream_handle(alphas.device))
    _launch.raise_on_error(rc, lib.batched_alpha_error_string)
    return out
