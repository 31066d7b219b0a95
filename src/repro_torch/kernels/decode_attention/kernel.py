"""ctypes binding of ``csrc/decode_attention.cu`` (built by
``kernels.build``)."""

from __future__ import annotations

import ctypes

import torch

from .. import _launch, build

HEAD_DIMS = (32, 64, 128, 256)
_typed = set()


def _lib() -> ctypes.CDLL:
    lib = build.load("decode_attention")
    if "decode_attention" not in _typed:
        lib.decode_attention_launch.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p]
        lib.decode_attention_launch.restype = ctypes.c_int
        lib.decode_attention_error_string.argtypes = [ctypes.c_int]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        _typed.add("decode_attention")
    return lib


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, Dh); k, v: (B, S, KVH, Dh); lengths: (B,) int32, all on
    the card. Returns (B, H, Dh) in q.dtype. Raises when the kernel
    cannot run."""
    B, H, Dh = q.shape
    S, KVH = k.shape[1], k.shape[2]
    if k.shape != (B, S, KVH, Dh) or v.shape != k.shape:
        raise ValueError(f"k and v must be (B, S, KVH, Dh) = "
                         f"{(B, S, KVH, Dh)}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head dim {Dh} not in {HEAD_DIMS}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise TypeError("lengths must be (B,) int32")
    code = _launch.dtype_code(q, "decode_attention q")
    for t, what in ((q, "q"), (k, "k"), (v, "v"), (lengths, "lengths")):
        _launch.check_cuda(t, f"decode_attention {what}")
        if t.device != q.device:
            raise ValueError("q, k, v and lengths must share one device")
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.decode_attention_launch(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), B, H, KVH, S, Dh,
            Dh ** -0.5, _launch.stream_handle(q.device))
    _launch.raise_on_error(rc, lib.decode_attention_error_string)
    return out
