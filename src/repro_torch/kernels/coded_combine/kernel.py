"""ctypes binding of ``csrc/coded_combine.cu`` (built by
``kernels.build``): the three combines, each on the card only.

``plan_combine`` is the launch plan of the int8 and packed-sign
combines, pure Python so that the CPU tests can check it: the route
(bulk asynchronous copies through a shared-memory ring for long rows,
the lane-contiguous register kernels for shorter ones, or the generic
grid-stride kernels for rows that are not whole aligned 16-byte
vectors), the CTAs, the tile of output positions, the payload stages of
the ring and the shared memory a CTA takes.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from .. import _launch, build

_PAYLOAD_CODES = {torch.float32: 0, torch.int8: 2}
ROUTES = {"generic": 0, "bulk": 1, "lane": 2}   # the source's route codes
KINDS = ("quantized", "packed")
H100_SMS = 132
GENERIC_THREADS = 256          # kThreads in the source
GENERIC_MAX_CTAS = 132 * 16    # kMaxBlocks
BULK_TILES = (8192, 4096, 2048, 1024)   # output positions a tile
BULK_CTAS_PER_SM = (2, 1)      # CTAs an SM, most first
BULK_MAX_STAGES = 8            # payload stages of the ring, at most
BULK_MIN_STAGES = 2
BULK_OUT_BUFS = 2              # kOutBufs: float32 output tiles a CTA
BULK_MIN_D = 1 << 24           # positions: the bulk route from here on
SM_SMEM = 233_472              # shared memory an SM (228 KB)
CTA_RESERVED = 1024            # of it the card keeps for each CTA
MAX_SMEM = 232_448             # a CTA's dynamic maximum (227 KB)
LANE_CTAS_PER_SM = 8           # the lane route: CTAs of 256 threads
LANE_UNROLL = 4                # kLaneUnroll: int8 words a lane a pass
PACKED_LANE_MIN_D = 1 << 20    # positions: packed rows take the lane
                               # route from here on, the generic below
_typed = set()
_plans = {}     # kind, shape, alignment, device -> plan


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class CombinePlan(NamedTuple):
    route: str       # "bulk", "lane" or "generic"
    ctas: int
    tile: int        # output positions a tile (bulk); 0 otherwise
    stages: int      # payload stages of the ring (bulk); 0 otherwise
    smem_bytes: int  # dynamic shared memory a CTA (bulk); 0 otherwise


def payload_bytes(kind: str, d: int) -> int:
    """Payload bytes a row of ``d`` output positions (one int8 a
    position, or ceil(d / 8) packed sign bytes)."""
    return d if kind == "quantized" else _cdiv(d, 8)


def positions_per_byte(kind: str) -> int:
    return 1 if kind == "quantized" else 8


def _generic_ctas(kind: str, d: int, itemsize: int, aligned: bool) -> int:
    if kind == "packed":
        work = _cdiv(d, 8)
    else:
        vec = 16 // itemsize
        work = d // vec if d % vec == 0 and aligned else d
    return max(1, min(_cdiv(work, GENERIC_THREADS), GENERIC_MAX_CTAS))


def bulk_smem(n: int, tile: int, stages: int, kind: str) -> int:
    """BULK_OUT_BUFS float32 output tiles, ``stages`` payload stages of
    ``n`` row tiles, a full and an empty mbarrier a stage."""
    tile_in = tile // positions_per_byte(kind)
    return BULK_OUT_BUFS * 4 * tile + stages * (n * tile_in + 16)


def plan_bulk(kind: str, n: int, d: int,
              sms: int = H100_SMS) -> Optional[CombinePlan]:
    """The bulk route's plan, or None where a CTA's shared memory cannot
    hold the output tiles and BULK_MIN_STAGES payload stages at the
    smallest tile. CTAs an SM: the most of BULK_CTAS_PER_SM; tile: the
    largest of BULK_TILES that then fits; stages: as many as then fit,
    up to BULK_MAX_STAGES (at one int8 row of 104.9 M: 2 CTAs an SM of
    6 stages of 8 KB, 96 KB of payload in flight an SM; at 4 rows, tiles
    of 4096 in 5 stages of 16 KB); CTAs no more than the tiles.

    Measured on an H100 (``tools/compare_trees.py``): tiles of 8192
    beat 4096 by up to 2 % and 2048 lost 2-5 %; 3 CTAs an SM won 1-2 %
    at int8 rows but could hold only 4096-position tiles; more output
    tiles in flight (3, 4, 6) and a bulk store a warp (2 KB) instead of
    one a CTA did not pay.
    """
    per = positions_per_byte(kind)
    row_bytes = payload_bytes(kind, d)
    for cps in BULK_CTAS_PER_SM:
        budget = min(MAX_SMEM, SM_SMEM // cps - CTA_RESERVED)
        for tile in BULK_TILES:
            stages = min(BULK_MAX_STAGES,
                         (budget - BULK_OUT_BUFS * 4 * tile)
                         // (n * tile // per + 16))
            if stages >= BULK_MIN_STAGES:
                tiles = _cdiv(row_bytes, tile // per)
                return CombinePlan("bulk", min(tiles, cps * sms), tile,
                                   stages, bulk_smem(n, tile, stages, kind))
    return None


def plan_lane(kind: str, n: int, d: int, sms: int = H100_SMS) -> CombinePlan:
    """The lane route's plan: LANE_CTAS_PER_SM CTAs of 256 threads an SM,
    no more than the work (int8: LANE_UNROLL words a lane; packed: 32
    words a warp)."""
    words = payload_bytes(kind, d) // 4
    lanes = _cdiv(words, LANE_UNROLL) if kind == "quantized" \
        else 32 * _cdiv(words, 32)
    ctas = min(_cdiv(lanes, GENERIC_THREADS), LANE_CTAS_PER_SM * sms)
    return CombinePlan("lane", max(1, ctas), 0, 0, 0)


def plan_combine(kind: str, n: int, d: int, itemsize: int,
                 sms: int = H100_SMS, aligned: bool = True) -> CombinePlan:
    """The launch plan of a combine of ``n`` payload rows of ``d``
    output positions (payload items of ``itemsize`` bytes) on a card of
    ``sms`` SMs.

    An int8 payload (``kind`` "quantized", itemsize 1) whose rows are
    whole 16-byte vectors (d % 16 == 0), or a packed one whose rows are
    (ceil(d / 8) % 16 == 0), 16-byte aligned, takes the bulk route from
    BULK_MIN_D positions on (``plan_bulk``) and the lane route below it
    or where the bulk route's shared memory cannot hold the rows
    (``plan_lane``; packed rows only from PACKED_LANE_MIN_D positions).
    Anything else -- a float32 payload, rows that are not whole aligned
    vectors, packed rows shorter than 2^20 -- takes the generic
    grid-stride kernels.

    Measured on an H100 (``tools/compare_trees.py --only combine``): at
    2^24 positions and more the bulk route is faster at 1 and 4 rows
    (by 2-17 %, most at 4 int8 rows); at 2^23 and less the lane route
    is (by up to 2.6x at 8192, where the bulk route's persistent CTAs
    have a tile or two each and the pipeline never fills). Below 2^20
    packed positions the generic kernel (a payload byte a thread) beat
    the lane route by 4-25 % (at 2^18 and 8192), and the lane route beat
    it by 18-22 % at 2^20.
    """
    if kind not in KINDS or min(n, d, itemsize) < 1 or 16 % itemsize \
            or (kind == "packed" and itemsize != 1):
        raise ValueError(f"plan_combine: bad combine kind={kind!r} n={n} "
                         f"d={d} itemsize={itemsize}")
    vector = itemsize == 1 and payload_bytes(kind, d) % 16 == 0 \
        and aligned and (kind == "quantized" or d >= PACKED_LANE_MIN_D)
    if vector:
        bulk = plan_bulk(kind, n, d, sms) if d >= BULK_MIN_D else None
        return bulk or plan_lane(kind, n, d, sms)
    return CombinePlan("generic", _generic_ctas(kind, d, itemsize, aligned),
                       0, 0, 0)


def _plan_for(kind: str, x: torch.Tensor, d: int) -> CombinePlan:
    dev = x.device
    aligned = x.data_ptr() % 16 == 0
    key = (kind, x.shape[0], d, x.element_size(), aligned, dev.index)
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = plan_combine(kind, x.shape[0], d,
                                          x.element_size(),
                                          _launch.sm_count(dev), aligned)
    return plan


def _lib() -> ctypes.CDLL:
    lib = build.load("coded_combine")
    if "coded_combine" not in _typed:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.coded_combine_launch.argtypes = [I, P, P, P, I, L, P]
        lib.coded_combine_launch.restype = I
        lib.quantized_combine_launch.argtypes = [I, P, P, P, I, L,
                                                 I, I, I, I, I, P]
        lib.quantized_combine_launch.restype = I
        lib.packed_sign_combine_launch.argtypes = [P, P, P, I, L, L,
                                                   I, I, I, I, I, P]
        lib.packed_sign_combine_launch.restype = I
        lib.coded_combine_error_string.argtypes = [I]
        lib.coded_combine_error_string.restype = ctypes.c_char_p
        _typed.add("coded_combine")
    return lib


def _rows_and_weights(x: torch.Tensor, u: torch.Tensor, what: str,
                      any_offset: bool = False):
    """x contiguous on the card (16-byte aligned unless ``any_offset``:
    the planned combines take a misaligned payload by the generic
    route) and u as contiguous float32 beside it."""
    if x.ndim != 2:
        raise ValueError(f"{what}: payload must be (n, D), got "
                         f"{tuple(x.shape)}")
    if u.shape != (x.shape[0],):
        raise ValueError(f"{what}: weights must be ({x.shape[0]},), got "
                         f"{tuple(u.shape)}")
    x = x.contiguous()
    u = u.to(device=x.device, dtype=torch.float32).contiguous()
    if any_offset:
        if x.device.type != "cuda":
            raise ValueError(f"{what} payload must be a CUDA tensor, got "
                             f"{x.device}")
    else:
        _launch.check_cuda(x, f"{what} payload")
    _launch.check_cuda(u, f"{what} weights")
    return x, u


def _run(fn_name: str, *args, device) -> None:
    lib = _lib()
    with torch.cuda.device(device):
        rc = getattr(lib, fn_name)(*args, _launch.stream_handle(device))
    _launch.raise_on_error(rc, lib.coded_combine_error_string)


def _plan_args(plan: CombinePlan):
    return (ROUTES[plan.route], plan.ctas, plan.tile, plan.stages,
            plan.smem_bytes)


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


def quantized_combine(q: torch.Tensor, u: torch.Tensor,
                      plan: CombinePlan = None) -> torch.Tensor:
    """q (n, D) int8 or float32 and the folded weights u = w * scales
    (n,) on the card -> (D,) float32. ``plan`` defaults to
    ``plan_combine``'s for this shape and alignment."""
    code = _PAYLOAD_CODES.get(q.dtype)
    if code is None:
        raise TypeError(f"quantized_combine: payload dtype {q.dtype} is "
                        "not supported (int8 or float32)")
    q, u = _rows_and_weights(q, u, "quantized_combine", any_offset=True)
    n, d = q.shape
    plan = plan or _plan_for("quantized", q, d)
    out = torch.empty(d, dtype=torch.float32, device=q.device)
    _run("quantized_combine_launch", code, q.data_ptr(), u.data_ptr(),
         out.data_ptr(), n, d, *_plan_args(plan), device=q.device)
    return out


def packed_sign_combine(q: torch.Tensor, u: torch.Tensor, d: int,
                        plan: CombinePlan = None) -> torch.Tensor:
    """q (n, ceil(d/8)) uint8 and u = w * scales (n,) on the card ->
    (d,) float32. ``plan`` as above."""
    if q.dtype != torch.uint8:
        raise TypeError(f"packed_sign_combine: payload must be uint8, "
                        f"got {q.dtype}")
    q, u = _rows_and_weights(q, u, "packed_sign_combine", any_offset=True)
    n, db = q.shape
    plan = plan or _plan_for("packed", q, d)
    out = torch.empty(d, dtype=torch.float32, device=q.device)
    _run("packed_sign_combine_launch", q.data_ptr(), u.data_ptr(),
         out.data_ptr(), n, db, d, *_plan_args(plan), device=q.device)
    return out
