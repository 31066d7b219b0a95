"""ctypes binding of ``csrc/decode_attention.cu`` (built by
``kernels.build``).

``plan_chunks`` is the split of the cache over CTAs (flash-decoding),
pure Python so that the CPU tests can check it. It reads the shapes and
the SM count only, never ``lengths``: the lengths stay on the card, the
call never waits for the device, and a CUDA graph can capture it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _launch, build

HEAD_DIMS = (32, 64, 128, 160, 256)   # 160: pixtral-12b (5120 / 32)
WARPS = 4                  # kWarps in the source
STAGE_BYTES = 16_384       # K and V rows of one ring stage (kStageBytes)
CTAS_PER_SM = 4            # aim: this many CTAs per SM over the whole cache
MIN_CHUNK = 192            # no chunk shorter than this many positions
MAX_CHUNKS = 1024         # the kernel's chunk merge fits in its ring
MMA_TILE = 64              # positions a tile on the tensor-core path
H100_SMS = 132
_typed = set()
_plans = {}     # shape, dtype, device -> (plan, scratch and tickets
                # addresses, the tensors that own them)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class ChunkPlan(NamedTuple):
    gt: int        # query heads per CTA
    groups: int    # (batch, kv head, head group) triples: B * KVH * NG
    tile: int      # positions per ring stage
    chunk: int     # positions per CTA, a multiple of tile
    chunks: int    # ceil(S / chunk)
    state: int     # floats of one chunk's (m, l, acc) state: (2 + Dh) gt


def lane_elems(Dh: int, itemsize: int) -> int:
    """Elements a lane holds on the CUDA-core path: the fewest whole
    16-byte vectors that cover Dh with a warp, such that the lanes of one
    position divide the warp's 32 (Dh = 160 in float32: 20, 8 lanes a
    position)."""
    vec = 16 // itemsize
    for e in range(vec, Dh, vec):
        if e * 32 >= Dh and Dh % e == 0 and 32 % (Dh // e) == 0:
            return e
    return Dh


def tile_positions(Dh: int, itemsize: int) -> int:
    """Positions per ring stage. bf16 with Dh >= 64 runs on the tensor
    cores, 16 positions a warp; otherwise K and V rows fill STAGE_BYTES,
    at most 32 per warp (one lane per position when the warp takes the
    exponentials), rounded down to whole rounds of the warp's lane groups
    and at least one round."""
    if itemsize == 2 and Dh >= 64:
        return MMA_TILE
    per_round = 32 // (Dh // lane_elems(Dh, itemsize))
    tpw = min(32, STAGE_BYTES // (2 * Dh * itemsize) // WARPS)
    return max(per_round, tpw // per_round * per_round) * WARPS


def plan_chunks(B: int, H: int, KVH: int, S: int, Dh: int, itemsize: int,
                sms: int = H100_SMS) -> ChunkPlan:
    """The chunk length for a cache of S positions: about CTAS_PER_SM
    CTAs per SM over all (batch, kv head, head group) triples when every
    position is valid (fewer run when lengths are short: a CTA whose
    chunk starts past lengths[b] returns at once), no chunk shorter than
    MIN_CHUNK positions, and a whole number of ring tiles per chunk."""
    if min(B, H, KVH, S) < 1 or H % KVH or Dh not in HEAD_DIMS:
        raise ValueError(f"plan_chunks: bad shape B={B} H={H} KVH={KVH} "
                         f"S={S} Dh={Dh}")
    G = H // KVH
    gt = 4 if G >= 4 else (2 if G >= 2 else 1)
    groups = B * KVH * _cdiv(G, gt)
    tile = tile_positions(Dh, itemsize)
    want = _cdiv(CTAS_PER_SM * sms, groups)
    most = _cdiv(S, max(tile, MIN_CHUNK))
    n = max(1, min(want, most, MAX_CHUNKS))
    chunk = _cdiv(max(_cdiv(S, n), min(MIN_CHUNK, S)), tile) * tile
    return ChunkPlan(gt=gt, groups=groups, tile=tile, chunk=chunk,
                     chunks=_cdiv(S, chunk), state=(2 + Dh) * gt)


def _prepare(B, H, KVH, S, Dh, itemsize, dev):
    """The plan of a shape on ``dev``, with the chunk states' scratch
    (``torch.empty``, never zeroed: every state is written before it is
    read) and the int32 tickets, zeroed once: the last CTA of each
    (batch, kv head, group) sets its ticket back to 0. Both are kept with
    the plan, so the wrapper's cost per call is that of a launch, and
    launches of the shape in stream order reuse them; a shape launched on
    two streams at once would not be safe."""
    plan = plan_chunks(B, H, KVH, S, Dh, itemsize, _launch.sm_count(dev))
    if plan.chunks == 1:
        return plan, None, None, ()
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("decode_attention: run each shape once before "
                           "capturing it in a CUDA graph")
    scratch = torch.empty(plan.groups * plan.chunks * plan.state,
                          dtype=torch.float32, device=dev)
    tickets = torch.zeros(plan.groups, dtype=torch.int32, device=dev)
    return plan, scratch.data_ptr(), tickets.data_ptr(), (scratch, tickets)


def _lib() -> ctypes.CDLL:
    lib = build.load("decode_attention")
    if "decode_attention" not in _typed:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.decode_attention_launch.argtypes = [
            I, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, ctypes.c_float,
            P]
        lib.decode_attention_launch.restype = I
        lib.decode_attention_error_string.argtypes = [I]
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
    dev = q.device
    key = (B, H, KVH, S, Dh, code, dev.index)
    entry = _plans.get(key)
    if entry is None:
        entry = _plans[key] = _prepare(B, H, KVH, S, Dh, q.element_size(),
                                       dev)
    plan, scratch, tickets, _ = entry
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.decode_attention_launch(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            lengths.data_ptr(), out.data_ptr(),
            scratch, tickets, B, H, KVH, S, Dh, plan.gt, plan.chunk,
            plan.chunks, Dh ** -0.5, _launch.stream_handle(dev))
    _launch.raise_on_error(rc, lib.decode_attention_error_string)
    return out
