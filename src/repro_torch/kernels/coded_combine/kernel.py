"""ctypes binding of ``csrc/coded_combine.cu`` (built by
``kernels.build``): the three combines, each on the card only."""

from __future__ import annotations

import ctypes

import torch

from .. import _launch, build

_PAYLOAD_CODES = {torch.float32: 0, torch.int8: 2}
_typed = set()


def _lib() -> ctypes.CDLL:
    lib = build.load("coded_combine")
    if "coded_combine" not in _typed:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for fn in (lib.coded_combine_launch, lib.quantized_combine_launch):
            fn.argtypes = [I, P, P, P, I, L, P]
            fn.restype = I
        lib.packed_sign_combine_launch.argtypes = [P, P, P, I, L, L, P]
        lib.packed_sign_combine_launch.restype = I
        lib.coded_combine_error_string.argtypes = [I]
        lib.coded_combine_error_string.restype = ctypes.c_char_p
        _typed.add("coded_combine")
    return lib


def _rows_and_weights(x: torch.Tensor, u: torch.Tensor, what: str):
    if x.ndim != 2:
        raise ValueError(f"{what}: payload must be (n, D), got "
                         f"{tuple(x.shape)}")
    if u.shape != (x.shape[0],):
        raise ValueError(f"{what}: weights must be ({x.shape[0]},), got "
                         f"{tuple(u.shape)}")
    x = x.contiguous()
    u = u.to(device=x.device, dtype=torch.float32).contiguous()
    _launch.check_cuda(x, f"{what} payload")
    _launch.check_cuda(u, f"{what} weights")
    return x, u


def _run(fn_name: str, *args, device) -> None:
    lib = _lib()
    with torch.cuda.device(device):
        rc = getattr(lib, fn_name)(*args, _launch.stream_handle(device))
    _launch.raise_on_error(rc, lib.coded_combine_error_string)


def coded_combine(grads: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """grads (n, D) float32/bfloat16 and w (n,) on the card -> (D,) in
    grads.dtype."""
    code = _launch.dtype_code(grads, "coded_combine grads")
    grads, w = _rows_and_weights(grads, w, "coded_combine")
    n, d = grads.shape
    out = torch.empty(d, dtype=grads.dtype, device=grads.device)
    _run("coded_combine_launch", code, grads.data_ptr(), w.data_ptr(),
         out.data_ptr(), n, d, device=grads.device)
    return out


def quantized_combine(q: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """q (n, D) int8 or float32 and the folded weights u = w * scales
    (n,) on the card -> (D,) float32."""
    code = _PAYLOAD_CODES.get(q.dtype)
    if code is None:
        raise TypeError(f"quantized_combine: payload dtype {q.dtype} is "
                        "not supported (int8 or float32)")
    q, u = _rows_and_weights(q, u, "quantized_combine")
    n, d = q.shape
    out = torch.empty(d, dtype=torch.float32, device=q.device)
    _run("quantized_combine_launch", code, q.data_ptr(), u.data_ptr(),
         out.data_ptr(), n, d, device=q.device)
    return out


def packed_sign_combine(q: torch.Tensor, u: torch.Tensor,
                        d: int) -> torch.Tensor:
    """q (n, ceil(d/8)) uint8 and u = w * scales (n,) on the card ->
    (d,) float32."""
    if q.dtype != torch.uint8:
        raise TypeError(f"packed_sign_combine: payload must be uint8, "
                        f"got {q.dtype}")
    q, u = _rows_and_weights(q, u, "packed_sign_combine")
    n, db = q.shape
    out = torch.empty(d, dtype=torch.float32, device=q.device)
    _run("packed_sign_combine_launch", q.data_ptr(), u.data_ptr(),
         out.data_ptr(), n, db, d, device=q.device)
    return out
