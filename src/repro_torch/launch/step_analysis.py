"""Cost analysis of one eager step: matmul FLOPs, dot bytes and the
coded combine's collective bytes.

The counterpart of ``repro.launch.hlo_analysis``, which parses a
compiled XLA module. An eager torch step has no module to parse, so
``analyze`` runs the step itself -- on meta tensors, which carry shapes
and dtypes and no data, so a full-size step allocates nothing and
launches no kernel -- and counts what dispatches:

* ``flops``: matmul FLOPs (mm, addmm, bmm, baddbmm, and einsum and
  matmul through them) from ``torch.utils.flop_counter``; like the
  reference, elementwise FLOPs are not counted.
* ``dot_bytes``: operand plus result bytes of those same ops, the
  HBM-traffic proxy of the reference's dot bytes.
* ``collective_bytes`` / ``collectives``: what the coded combine ships
  per step, ``core.compress.comm_bytes_per_step`` over the step's rows
  and parameters, keyed by codec -- given by the caller (``comm=``),
  since the one-device step runs no collective to observe.

The reference's ``n_while`` and ``max_trip`` (its loop-trip correction)
have no counterpart: an eager step's loops run, and every iteration's
ops dispatch and are counted, so they are left out.

Both steps rematerialise each layer (``jax.checkpoint`` in the
reference, ``torch.utils.checkpoint`` here), and both recompute all of a
layer's forward but the MLP's down projection (XLA drops it; torch's
non-reentrant checkpoint stops at the last tensor the backward needs).
What differs is attention. The port's flash-attention backward
recomputes each tile's Q K^T, where the reference's scan saves its
scores, so a train step counts one more Q K^T product a tile. And the
port skips the tiles a mask wholly hides (forward, recompute and
backward), where the reference's scan computes every key block, so at
sequences longer than one block (512 positions) both its train and its
prefill counts fall below the reference's by those tiles' products. Up
to one block a sequence nothing is skipped, and prefill counts the same
FLOPs and dot bytes as the reference.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core import compress as compress_mod

aten = torch.ops.aten

# op -> indices of its matmul operands (the reference counts a dot's two
# operands and its result; addmm's bias is not one of them)
_DOT_OPERANDS = {
    aten.mm.default: (0, 1),
    aten.bmm.default: (0, 1),
    aten.addmm.default: (1, 2),
    aten.baddbmm.default: (1, 2),
}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (tuple, list)):
        return sum(_nbytes(y) for y in x)
    return 0


class _DotBytes(TorchDispatchMode):
    """Sums operand and result bytes of every matmul-family op, and the
    bytes of every op result that is not a meta tensor (0 for a step
    run on meta tensors: it allocated nothing)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.calls = 0
        self.materialised = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.device.type != "meta":
                self.materialised += _nbytes(t)
        idx = _DOT_OPERANDS.get(func)
        if idx is not None:
            self.calls += 1
            self.bytes += sum(_nbytes(args[i]) for i in idx) + _nbytes(out)
        return out


def comm(codec: Optional[str], rows: int, params) -> Dict[str, float]:
    """The coded combine's bytes a step, keyed by codec name: ``rows``
    (machines, or unique blocks on the dedup path) each ship their
    gradient of ``params`` -- float32, or the codec's payload."""
    c = None if codec in (None, "none") else compress_mod.get_codec(codec)
    return {codec or "none": float(
        compress_mod.comm_bytes_per_step(c, rows, params))}


def analyze(fn: Callable, *args, comm: Optional[Dict[str, float]] = None,
            **kwargs) -> Dict[str, object]:
    """Run ``fn(*args, **kwargs)`` (on meta tensors for a full-size
    step) and count it: {flops, dot_bytes, collective_bytes,
    collectives, dot_calls, materialised_bytes}."""
    flop_mode = FlopCounterMode(display=False)
    bytes_mode = _DotBytes()
    with flop_mode, bytes_mode:
        fn(*args, **kwargs)
    coll = dict(comm or {})
    return {
        "flops": float(flop_mode.get_total_flops()),
        "dot_bytes": float(bytes_mode.bytes),
        "collective_bytes": float(sum(coll.values())),
        "collectives": {k: float(v) for k, v in coll.items()},
        "dot_calls": bytes_mode.calls,
        "materialised_bytes": bytes_mode.materialised,
    }
