"""Public coded combines: the CUDA kernels for CUDA tensors, the plain
versions for CPU tensors, and the per-leaf tree forms.

Port of ``repro.kernels.coded_combine.ops``. ``_FORCE`` is the test
hook: ``"ref"`` runs the plain versions on any device, ``"kernel"``
insists on the kernels (and raises for a CPU tensor), None dispatches on
the device. ``launches`` counts kernel launches per kernel. No autograd:
these run on gradients.
"""

from __future__ import annotations

import math

import torch

from repro_torch import tree as T
from . import kernel, ref

_FORCE = None  # test hook: None | "ref" | "kernel"
launches = {"coded_combine": 0, "quantized_combine": 0,
            "packed_sign_combine": 0}


def _use_ref(x: torch.Tensor) -> bool:
    if _FORCE == "ref" or (_FORCE is None and x.device.type == "cpu"):
        return True
    if _FORCE not in (None, "kernel"):
        raise ValueError(f"unknown _FORCE {_FORCE!r}")
    return False


def coded_combine(grads: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """grads: (n, D); w: (n,) -> (D,) in grads.dtype."""
    if _use_ref(grads):
        return ref.coded_combine(grads, w)
    out = kernel.coded_combine(grads, w)
    launches["coded_combine"] += 1
    return out


def coded_combine_tree(grad_tree, w: torch.Tensor):
    """Weighted-sum the leading axis of every leaf: (n, ...) -> (...),
    one combine per leaf."""
    return T.map(lambda leaf: coded_combine(
        leaf.reshape(leaf.shape[0], -1), w).reshape(leaf.shape[1:]),
        grad_tree)


def quantized_combine(q: torch.Tensor, scales: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """q: (n, D) int8 or float32 payload; scales, w: (n,) -> (D,) f32.
    The dequant scale folds into the weight first: u = w * scales."""
    if _use_ref(q):
        return ref.quantized_combine(q, scales, w)
    out = kernel.quantized_combine(q, w.float() * scales.float())
    launches["quantized_combine"] += 1
    return out


def quantized_combine_tree(q_tree, scale_tree, w: torch.Tensor):
    """Per-leaf ``quantized_combine`` over a payload tree with matching
    (n,) scales; returns the float32 combined tree."""
    return T.map(lambda q, s: quantized_combine(
        q.reshape(q.shape[0], -1), s, w).reshape(q.shape[1:]),
        q_tree, scale_tree)


def packed_sign_combine(q: torch.Tensor, scales: torch.Tensor,
                        w: torch.Tensor, d: int) -> torch.Tensor:
    """q: (n, ceil(d/8)) packed signs; scales, w: (n,) -> (d,) f32.
    Raises on a payload width other than ceil(d/8), before any
    launch."""
    if q.shape[-1] != (d + 7) // 8:
        raise ValueError(f"payload width {q.shape[-1]} != ceil({d}/8)")
    if _use_ref(q):
        return ref.packed_sign_combine(q, scales, w, d)
    out = kernel.packed_sign_combine(q, w.float() * scales.float(), d)
    launches["packed_sign_combine"] += 1
    return out


def packed_sign_combine_tree(q_tree, scale_tree, w: torch.Tensor, shapes):
    """Per-leaf ``packed_sign_combine``; ``shapes`` is the matching tree
    of combined-output shapes, which a packed payload cannot carry."""
    return T.map(lambda q, s, shp: packed_sign_combine(
        q.reshape(q.shape[0], -1), s, w, math.prod(shp)).reshape(shp),
        q_tree, scale_tree, shapes)
