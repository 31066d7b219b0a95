"""ctypes binding of ``csrc/rmsnorm.cu`` (built by ``kernels.build``).

``plan_rows`` is the launch plan, pure Python so that the CPU tests can
check it: how many threads share a row, how many 16-byte vectors each
holds in registers, and how many rows a CTA takes -- or the loop kernel,
for rows the registers cannot hold.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _launch, build

VPTS = (1, 2, 4, 8, 16)    # vectors a thread: the source's instantiations
ROW_VPT = 8                # vectors a thread, at most, while warps allow
ROW_THREADS = 256          # threads a row, at most, while ROW_VPT holds it
LOOP_THREADS = 256         # kLoopThreads in the source
MAX_THREADS = 512          # kMaxThreads: a CTA (and a row), register path
CTA_WARPS = 4              # warps a CTA when a row takes fewer
WARPS_PER_SM = 8           # aim: at least this many row warps an SM
SMEM_BYTES = 4 * MAX_THREADS // 32   # the register path's shared memory
H100_SMS = 132
_typed = set()
_plans = {}     # shape, alignment, device -> plan


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class RowPlan(NamedTuple):
    vpt: int       # 16-byte vectors a thread holds; 0: the loop kernel
    tpr: int       # threads a row (a multiple of 32)
    rpc: int       # rows a CTA
    ctas: int


def plan_rows(rows: int, d: int, itemsize: int, sms: int = H100_SMS,
              aligned: bool = True) -> RowPlan:
    """The launch plan of ``rows`` rows of ``d`` elements of ``itemsize``
    bytes on a card of ``sms`` SMs.

    A row is held in registers, ``vpt`` vectors a thread over ``tpr``
    threads, when d is a multiple of the 16-byte vector, x is aligned and
    the row fits MAX_THREADS threads of 16 vectors. Warps a row: as many
    as give the card WARPS_PER_SM row warps an SM, but no more than
    ROW_THREADS threads or than leave every thread a vector, and no fewer
    than the row needs at ROW_VPT vectors a thread (up to MAX_THREADS;
    16 vectors a thread past that): a CTA of 256 threads a row at the
    decode step's 8 rows of 4096, two warps a row at 8192 rows of 4096
    bf16. Then the fewest vectors a thread that cover the row, and the
    fewest warps at that count. Rows narrower than CTA_WARPS warps share
    a CTA of up to CTA_WARPS warps when there are rows enough to give
    every SM one. Anything else goes to the loop kernel, a CTA of
    LOOP_THREADS a row.
    """
    if min(rows, d, itemsize) < 1 or 16 % itemsize:
        raise ValueError(f"plan_rows: bad shape rows={rows} d={d} "
                         f"itemsize={itemsize}")
    n = 16 // itemsize
    nv = d // n
    if d % n or not aligned or nv > VPTS[-1] * MAX_THREADS:
        return RowPlan(vpt=0, tpr=LOOP_THREADS, rpc=1, ctas=rows)
    most = min(ROW_THREADS // 32, _cdiv(nv, 32))
    wpr = min(MAX_THREADS // 32, max(_cdiv(nv, 32 * ROW_VPT),
                                     min(most, _cdiv(WARPS_PER_SM * sms,
                                                     rows))))
    vpt = next(v for v in VPTS if v * 32 * wpr >= nv)
    wpr = _cdiv(_cdiv(nv, vpt), 32)
    rpc = max(1, min(CTA_WARPS // wpr, rows // sms))
    return RowPlan(vpt=vpt, tpr=32 * wpr, rpc=rpc, ctas=_cdiv(rows, rpc))


def _lib() -> ctypes.CDLL:
    lib = build.load("rmsnorm")
    if "rmsnorm" not in _typed:
        I = ctypes.c_int
        lib.rmsnorm_launch.argtypes = [
            I, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, I, ctypes.c_float, I, I, I, ctypes.c_void_p]
        lib.rmsnorm_launch.restype = I
        lib.rmsnorm_error_string.argtypes = [I]
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
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm x must be a CUDA tensor, got {x.device}")
    x = x.contiguous()
    # The kernel reads the scale as fp32, which is what the reference
    # does with it (scale.astype(float32)); a float32 scale is not copied.
    scale = scale.to(torch.float32).contiguous()
    _launch.check_cuda(scale, "rmsnorm scale")
    if scale.device != x.device:
        raise ValueError("x and scale must be on the same device")
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    dev = x.device
    aligned = x.data_ptr() % 16 == 0
    key = (rows, d, x.element_size(), aligned, dev.index)
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = plan_rows(rows, d, x.element_size(),
                                       _launch.sm_count(dev), aligned)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.rmsnorm_launch(code, x.data_ptr(), scale.data_ptr(),
                                out.data_ptr(), rows, d, float(eps),
                                plan.vpt, plan.tpr, plan.rpc,
                                _launch.stream_handle(dev))
    _launch.raise_on_error(rc, lib.rmsnorm_error_string)
    return out
