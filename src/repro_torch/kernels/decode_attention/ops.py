"""Public decode attention: the CUDA kernel for a CUDA tensor, the plain
version for a CPU (or meta) tensor.

Forward-only (serving path), as in ``repro.kernels.decode_attention``.
``_FORCE`` is the test hook: ``"ref"`` runs the plain version on any
device, ``"kernel"`` insists on the kernel (and raises for a CPU
tensor), None dispatches on the device. ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._launch import PLAIN_DEVICES
from . import kernel, ref

_FORCE = None  # test hook: None | "ref" | "kernel"
launches = 0


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, Dh); k, v: (B, S, KVH, Dh); lengths: (B,)."""
    global launches
    H, KVH = q.shape[1], k.shape[2]
    if H % KVH:
        raise ValueError("H must be a multiple of KVH")
    if _FORCE == "ref" or (_FORCE is None and q.device.type in PLAIN_DEVICES):
        return ref.decode_attention(q, k, v, lengths)
    if _FORCE not in (None, "kernel"):
        raise ValueError(f"unknown _FORCE {_FORCE!r}")
    out = kernel.decode_attention(q, k, v, lengths)
    launches += 1
    return out
