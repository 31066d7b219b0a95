"""Public RMSNorm: the CUDA kernel for a CUDA tensor, the plain version
for a CPU (or meta) tensor, and a closed-form backward.

Mirrors ``repro.kernels.rmsnorm.ops``: differentiable through a
``torch.autograd.Function`` whose backward is the reference's closed
form (``_bwd``) in plain torch. ``_FORCE`` is the test hook: ``"ref"``
runs the plain version on any device, ``"kernel"`` insists on the
kernel (and raises for a CPU tensor), None dispatches on the device.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._launch import PLAIN_DEVICES
from . import kernel, ref

_FORCE = None  # test hook: None | "ref" | "kernel"
launches = 0


def _forward(x, scale, eps):
    global launches
    if _FORCE == "ref" or (_FORCE is None and x.device.type in PLAIN_DEVICES):
        return ref.rmsnorm(x, scale, eps=eps)
    if _FORCE not in (None, "kernel"):
        raise ValueError(f"unknown _FORCE {_FORCE!r}")
    out = kernel.rmsnorm(x, scale, eps=eps)
    launches += 1
    return out


def _bwd(eps, x, scale, g):
    xf = x.float()
    gf = g.float()
    sf = scale.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    inv = (var + eps) ** -0.5
    xhat = xf * inv
    # y = xhat * scale
    dscale = (gf * xhat).sum(dim=tuple(range(x.ndim - 1)))
    gx_hat = gf * sf
    # dxhat/dx: inv * (I - xhat xhat^T / d)
    dx = inv * (gx_hat - xhat * (gx_hat * xhat).mean(dim=-1, keepdim=True))
    return dx.to(x.dtype), dscale.to(scale.dtype)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _forward(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = _bwd(ctx.eps, x, scale, g)
        return dx, dscale, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d); scale: (d,). Same shape and dtype as x."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale, eps)
    return _forward(x, scale, eps)
