"""What the ctypes bindings of the kernels share: dtype codes, argument
checks and the launch-error check."""

from __future__ import annotations

import ctypes

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor, what: str) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"{what}: dtype {t.dtype} is not supported by the "
                        "kernel (float32 or bfloat16)")
    return code


def check_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{what} must be 16-byte aligned")


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raise_on_error(rc: int, error_string) -> None:
    """The C entry points return cudaGetLastError() right after the
    launch (or a negative code for a rejected argument): a refused launch
    never runs, and a later synchronize would not report it."""
    if rc != 0:
        raise RuntimeError(error_string(rc).decode())


_sm_counts = {}


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of ``device`` (a CUDA tensor's device,
    with its index), read once."""
    idx = device.index
    n = _sm_counts.get(idx)
    if n is None:
        n = torch.cuda.get_device_properties(idx).multi_processor_count
        _sm_counts[idx] = n
    return n
