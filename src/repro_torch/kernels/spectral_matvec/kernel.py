"""ctypes binding of ``csrc/spectral_matvec.cu`` (built by
``kernels.build``): the Gram matvec X^T (X V^T) over one operand or a
stack of them, on the card only, in one launch per call.

``plan_gram`` is the launch plan, pure Python so that the CPU tests can
check it: row strips sized by bytes, the ring's tile and stages, the
thread-block clusters that sum the strips' partials, and the scratch the
wrapper hands the kernel.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _launch, build

THREADS = 256              # kThreads in the source
JB = 8                     # right-hand sides per pass (kJB)
CPT = 4                    # columns per thread per column block (kCPT)
MAX_VS_FLOATS = 16_384     # v staged in shared memory up to this
MAX_CLUSTER = 8            # portable thread-block cluster size
MAX_CLUSTER_ONE = 16       # non-portable size, for a single slice
MAX_SMEM_BYTES = 231_424   # dynamic shared memory a CTA may use
SM_SMEM_BYTES = 233_472    # shared memory of one SM (228 KB)
SM_THREADS = 2048
SM_REGISTERS = 65_536
REGISTERS = {1: 128, JB: 128}  # per thread: __launch_bounds__(256, 2)
STAGE_BYTES = 32_768       # a ring stage holds about this much of X
RING_BYTES = 163_840       # ... and a streaming ring at most this much
MAX_STAGES = 8             # kMaxStages
MAX_TILE = 512             # rows a stage at k <= 32 (a thread a row)
MIN_CTA_BYTES = 16_384     # no CTA gets less of X than this
FINAL_FLOATS = 32_768      # partials a last CTA sums: clusters x its slice
BIG_BYTES_PER_SM = 262_144 # above this much of X an SM, plan for streaming
H100_SMS = 132
_typed = set()
_plans = {}     # shape, device -> (plan, partials and tickets addresses,
                # the tensors that own them)


class GramPlan(NamedTuple):
    rows: int            # rows of X per strip (per CTA)
    tile: int            # rows per ring stage
    stages: int          # ring stages; 0 reads X from device memory
    ct: int              # column lanes; 256 / ct row groups
    cluster: int         # CTAs (strips) per thread-block cluster
    clusters: int        # clusters per (slice, pass, column block)
    blocks: int          # column blocks of CPT * ct columns
    passes: int          # launches' passes of JB right-hand sides
    ctas: int
    smem_bytes: int      # dynamic shared memory per CTA
    partial_floats: int  # scratch; 0 with one cluster per slice
    tickets: int         # int32 tickets; 0 with one cluster per slice


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def column_lanes(k: int) -> int:
    """Threads per row group: the columns of a row spread over 32 to 256
    lanes (4 columns each per block), the rest of the 256 threads take
    other rows."""
    for ct in (32, 64, 128):
        if k <= CPT * ct:
            return ct
    return 256


def slot_floats(tile: int, k: int) -> int:
    """Floats of one ring stage: the tile and its alignment shift."""
    return (tile * k + 4 + 3) // 4 * 4


def pass_width(bv: int) -> int:
    """Right-hand sides the kernel carries a pass: 1 for one, else JB."""
    return 1 if bv == 1 else JB


def wide_rows(bv: int) -> int:
    """Rows each thread holds in registers on the wide path (RT)."""
    return 8 if bv == 1 else 4


def vs_floats(jbt: int, k: int) -> int:
    """Floats of v staged in shared memory: its rows when k <= 32, or
    when a pass carries JB and they fit MAX_VS_FLOATS (otherwise v is
    read from device memory, into registers for one right-hand side)."""
    n = (jbt * k + 3) // 4 * 4
    return n if k <= 32 or (jbt > 1 and n <= MAX_VS_FLOATS) else 0


def smem_bytes(tile: int, stages: int, k: int, bv: int) -> int:
    """Dynamic shared memory of one CTA: staged v, the y tile, and the
    ring, which the row-group merge reuses."""
    jbt = pass_width(bv)
    red = jbt * CPT * THREADS
    return 4 * (vs_floats(jbt, k) + (tile * jbt + 3) // 4 * 4
                + max(stages * slot_floats(tile, k), red))


def plan_gram(B: int, R: int, k: int, bv: int,
              sms: int = H100_SMS) -> GramPlan:
    """The launch plan of one call on a card of ``sms`` SMs.

    Each CTA takes one strip of rows; strips are grouped into
    thread-block clusters that sum their partials on chip, and the
    (clusters, JB, CPT * ct) partials that reach device memory stay
    within an eighth of X at every bv. Two regimes, by the bytes of X an
    SM would get:

    - latency (up to BIG_BYTES_PER_SM): at most one CTA an SM (clusters
      of 8 with more leave CTAs waiting for room in a GPC), no CTA with
      less than MIN_CTA_BYTES, clusters of up to 8, a last CTA summing
      at most FINAL_FLOATS partials; the whole strip is requested at
      once, through a ring of one stage per tile;
    - streaming: as many CTAs as the card holds, clusters of 2, rows
      through a three-stage ring of STAGE_BYTES tiles.

    Rows too wide for a ring of two stages (k past about 20,000 floats)
    are read from device memory straight into registers (stages 0).
    """
    if min(B, R, k, bv) < 1:
        raise ValueError(f"plan_gram: need B, R, k, bv >= 1, got "
                         f"{(B, R, k, bv)}")
    ct = column_lanes(k)
    blocks = _cdiv(k, CPT * ct)
    passes = _cdiv(bv, JB)
    units = B * passes * blocks
    # a thread per row at k <= 32; wider rows sit in registers, RT rows a
    # thread of each of the 256 / ct row groups
    narrow = k <= 32
    rows_held = MAX_TILE if narrow else wide_rows(bv) * (THREADS // ct)
    by_bytes = max(1, _cdiv(4 * R * k, MIN_CTA_BYTES))
    streaming = 4 * B * R * k > BIG_BYTES_PER_SM * sms
    stage_rows = max(1, STAGE_BYTES // (4 * k))

    def ring(tile):
        slot = slot_floats(tile, k)
        half = SM_SMEM_BYTES // 2 - 1024   # room for two CTAs an SM
        fits = [s for s in (3, 2) if 4 * s * slot <= RING_BYTES]
        return next((s for s in fits if smem_bytes(tile, s, k, bv) <= half),
                    fits[0] if fits else 0)

    if streaming:
        tile = max(1, min(stage_rows, rows_held, R))
        stages = ring(tile)
        smem = smem_bytes(tile, stages, k, bv)
        resident = max(1, min(SM_THREADS // THREADS,
                              SM_SMEM_BYTES // (smem + 1024),
                              SM_REGISTERS // (THREADS
                                               * REGISTERS[pass_width(bv)])))
        strips = min(max(1, sms * resident // units), by_bytes, R)
        cluster = min(2, strips)
    else:
        strips = min(max(1, sms // units), by_bytes, R)
        # one slice's strips may form a cluster of up to 16 (a size past
        # 8 that the card allows on request) when there are few clusters
        big = MAX_CLUSTER_ONE if units == 1 and strips <= 8 * \
            MAX_CLUSTER_ONE else MAX_CLUSTER
        cluster = min(big, strips)
    per_cluster = passes * blocks * JB * CPT * ct
    clusters = max(1, min(strips // cluster, R * k // 8 // per_cluster))
    if not streaming:
        slice_floats = pass_width(bv) * CPT * ct // cluster
        clusters = max(1, min(clusters, FINAL_FLOATS // slice_floats))
    rows = _cdiv(R, clusters * cluster)
    clusters = _cdiv(_cdiv(R, rows), cluster)   # as the kernel counts them
    if not streaming:
        tile = min(rows, rows_held, stage_rows if narrow else rows)
    tile = _cdiv(rows, _cdiv(rows, tile))       # equal tiles in a strip
    if not streaming:
        # one CTA an SM: the whole strip in flight at once, in a ring of
        # one stage per tile (and one spare)
        stages = max(2, min(_cdiv(rows, tile) + 1, MAX_STAGES))
        half = SM_SMEM_BYTES // 2 - 1024   # clusters place CTAs worse above
        while stages > 2 and smem_bytes(tile, stages, k, bv) > half:
            stages -= 1
        if smem_bytes(tile, stages, k, bv) > MAX_SMEM_BYTES:
            stages = 0
    many = clusters > 1
    return GramPlan(
        rows=rows, tile=tile, stages=stages, ct=ct, cluster=cluster,
        clusters=clusters, blocks=blocks, passes=passes,
        ctas=clusters * cluster * passes * blocks * B,
        smem_bytes=smem_bytes(tile, stages, k, bv),
        partial_floats=B * passes * blocks * clusters * JB * CPT * ct
        if many else 0,
        tickets=B * passes * blocks * cluster if many else 0)


def _prepare(B, R, k, bv, dev):
    """The plan of a shape on ``dev``, with the clusters' partials
    (``torch.empty``: every partial is written before it is read) and the
    int32 tickets, zeroed once: the last CTA of each unit sets its ticket
    back to 0. Both are kept with the plan, and launches of the shape in
    stream order reuse them; a shape launched on two streams at once
    would not be safe."""
    plan = plan_gram(B, R, k, bv, _launch.sm_count(dev))
    if plan.clusters == 1:
        return plan, None, None, ()
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("gram_matvec: run each shape once before "
                           "capturing it in a CUDA graph")
    part = torch.empty(plan.partial_floats, dtype=torch.float32,
                       device=dev)
    tickets = torch.zeros(plan.tickets, dtype=torch.int32, device=dev)
    return plan, part.data_ptr(), tickets.data_ptr(), (part, tickets)


def _lib() -> ctypes.CDLL:
    lib = build.load("spectral_matvec")
    if "spectral_matvec" not in _typed:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.gram_matvec_launch.argtypes = [P, P, P, P, P, I, I, I, I, I, I,
                                           I, I, I, P]
        lib.gram_matvec_launch.restype = I
        lib.spectral_matvec_error_string.argtypes = [I]
        lib.spectral_matvec_error_string.restype = ctypes.c_char_p
        _typed.add("spectral_matvec")
    return lib


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
    if min(B, R, k, bv) < 1 or B > 65535:
        raise ValueError(f"gram_matvec: need 1 <= B <= 65535 and R, k, "
                         f"bv >= 1, got x {tuple(x.shape)} and {bv} "
                         "right-hand sides")
    if x.data_ptr() % 16:          # the ring's 16-byte copies need it
        x = x.clone()
    dev = x.device
    key = (B, R, k, bv, dev.index)
    entry = _plans.get(key)
    if entry is None:
        entry = _plans[key] = _prepare(B, R, k, bv, dev)
    plan, part, tickets, _ = entry
    out = torch.empty((B, bv, k), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.gram_matvec_launch(
            x.data_ptr(), v.data_ptr(), out.data_ptr(), part, tickets, B,
            R, k, bv, plan.rows, plan.tile, plan.stages, plan.ct,
            plan.cluster, _launch.stream_handle(dev))
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
    the lockstep-Lanczos form, one launch for the whole stack."""
    return _gram(x, v[:, None, :])[:, 0]
