"""Named ranges at the layer boundaries of the training step, for a
profiler trace.

``span(name)`` opens a ``torch.profiler.record_function`` range named
``rt/<name>`` while a profiler is recording, so the range lies on the
profiler's timeline beside the device operations launched inside it;
with no profiler active it returns one shared null context and records
nothing. Code that computes a layer's gradient by hand (an autograd
Function's ``backward``) opens ``span(name, backward=True)``, named
``rt/<name>/backward``, so that a trace can tell it from the same
layer's forward re-run by rematerialisation inside a backward pass.

The step's spans (``dist.coded_train``, ``models.model``,
``models.attention``): ``forward_backward`` (one loss and its gradient),
``block`` (a rematerialised layer's body, entered again when the
backward recomputes it), ``attention`` (the blockwise attention's
forward, and its backward), ``lm_head`` (the LM head through the loss's
log-sum-exp), ``combine`` (the manual collective's per-chunk combine
and accumulation, or a compressed combine), ``allreduce`` (the
cross-rank sums of the gradient and the loss), ``optimizer`` (the update
and its application) and ``step_metrics`` (the gradient norm and
alpha-bar). None sits inside a tile loop or a per-leaf map: a step opens
O(layers) of them.
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "rt/"
BACKWARD = "/backward"

_NULL = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def span(name: str, *, backward: bool = False):
    """A ``record_function`` range ``rt/<name>`` (``rt/<name>/backward``
    under ``backward``) while a profiler records; else a null context."""
    if not _profiling():
        return _NULL
    return torch.profiler.record_function(
        PREFIX + name + (BACKWARD if backward else ""))
