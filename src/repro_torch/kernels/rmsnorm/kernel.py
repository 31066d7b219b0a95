"""ctypes binding of ``csrc/rmsnorm.cu`` (built by ``kernels.build``)."""

from __future__ import annotations

import ctypes

import torch

from .. import _launch, build

_typed = set()


def _lib() -> ctypes.CDLL:
    lib = build.load("rmsnorm")
    if "rmsnorm" not in _typed:
        lib.rmsnorm_launch.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p]
        lib.rmsnorm_launch.restype = ctypes.c_int
        lib.rmsnorm_error_string.argtypes = [ctypes.c_int]
        lib.rmsnorm_error_string.restype = ctypes.c_char_p
        _typed.add("rmsnorm")
    return lib


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d) float32/bfloat16 on the card; scale: (d,). Returns
    y in x's dtype and shape. Raises when the kernel cannot run."""
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"scale must be ({d},), got {tuple(scale.shape)}")
    code = _launch.dtype_code(x, "rmsnorm x")
    x = x.contiguous()
    # The kernel reads the scale as fp32, which is what the reference
    # does with it (scale.astype(float32)); a float32 scale is not copied.
    scale = scale.to(torch.float32).contiguous()
    _launch.check_cuda(x, "rmsnorm x")
    _launch.check_cuda(scale, "rmsnorm scale")
    if scale.device != x.device:
        raise ValueError("x and scale must be on the same device")
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.rmsnorm_launch(code, x.data_ptr(), scale.data_ptr(),
                                out.data_ptr(), rows, d, float(eps),
                                _launch.stream_handle(x.device))
    _launch.raise_on_error(rc, lib.rmsnorm_error_string)
    return out
