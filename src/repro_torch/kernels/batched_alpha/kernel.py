"""ctypes binding of ``csrc/batched_alpha.cu`` (built by
``kernels.build``): the fused debias + error reduction, on the card
only.

``plan_error`` is the launch plan, pure Python so that the CPU tests can
check it: how many threads share a trial row, how many 16-byte loads
each issues at once, and how many rows a CTA takes.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _launch, build

VPTS = (1, 2, 4, 8, 16)    # loads a thread a round: the instantiations
MAX_THREADS = 256          # kMaxThreads in the source
SMEM_BYTES = 4 * MAX_THREADS // 32   # the kernel's static shared memory
H100_SMS = 132
_typed = set()
_plans = {}     # shape, device -> plan


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class ErrorPlan(NamedTuple):
    vpt: int       # 16-byte loads a thread issues before it accumulates
    tpr: int       # threads a row (a multiple of 32)
    rpc: int       # rows a CTA
    ctas: int
    rounds: int    # rounds of vpt loads a thread, at most, over a row


def plan_error(trials: int, n: int, sms: int = H100_SMS) -> ErrorPlan:
    """The launch plan of a (trials, n) float32 batch on a card of
    ``sms`` SMs.

    Warps a row: as many as the row's ceil(n / 4) vectors leave a vector
    each, up to MAX_THREADS threads, at any number of trials (at n = 2184
    a CTA of 160 threads a row, 4 loads each, at 30 trials and at 1000);
    then the fewest loads a thread that read the row in one round, and
    the fewest warps at that count. Rows narrower than a CTA share one
    when there are rows enough to give every SM one. A row past
    16 * MAX_THREADS vectors takes several rounds.
    """
    if min(trials, n) < 1:
        raise ValueError(f"plan_error: need trials, n >= 1, got "
                         f"{(trials, n)}")
    nv = _cdiv(n, 4)
    wpr = min(MAX_THREADS // 32, _cdiv(nv, 32))
    vpt = next((v for v in VPTS if v * 32 * wpr >= nv), VPTS[-1])
    wpr = min(wpr, _cdiv(_cdiv(nv, vpt), 32))
    rpc = max(1, min(MAX_THREADS // 32 // wpr, trials // sms))
    return ErrorPlan(vpt=vpt, tpr=32 * wpr, rpc=rpc,
                     ctas=_cdiv(trials, rpc),
                     rounds=_cdiv(nv, vpt * 32 * wpr))


def _lib() -> ctypes.CDLL:
    lib = build.load("batched_alpha")
    if "batched_alpha" not in _typed:
        P, F, L, I = (ctypes.c_void_p, ctypes.c_float, ctypes.c_longlong,
                      ctypes.c_int)
        lib.fused_error_launch.argtypes = [P, F, F, P, L, L, I, I, I, P]
        lib.fused_error_launch.restype = I
        lib.batched_alpha_error_string.argtypes = [I]
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
    dev = alphas.device
    key = (trials, n, dev.index)
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = plan_error(trials, n, _launch.sm_count(dev))
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.fused_error_launch(
            alphas.data_ptr(), float(scale), 1.0 / n, out.data_ptr(),
            trials, n, plan.vpt, plan.tpr, plan.rpc,
            _launch.stream_handle(dev))
    _launch.raise_on_error(rc, lib.batched_alpha_error_string)
    return out
