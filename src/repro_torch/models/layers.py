"""Shared building blocks: norms, linear, rotary, SwiGLU MLP.

Functional style, as in ``repro.models.layers``: parameters are plain
nested dicts of tensors with the reference's key paths, and linear
weights keep its ``(d_in, d_out)`` layout, applied as ``x @ w``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def init_linear(gen: torch.Generator, d_in: int, d_out: int, *,
                bias: bool = False, dtype: str = "float32", lead=()):
    """N(0, 1/d_in) weights (the reference's default scale); ``lead``
    prepends stacking dims (the layer axis)."""
    dev = gen.device
    w = torch.randn(*lead, d_in, d_out, generator=gen, device=dev,
                    dtype=_dtype(dtype))
    p = {"w": w.mul_(d_in ** -0.5)}
    if bias:
        p["b"] = torch.zeros(*lead, d_out, device=dev, dtype=_dtype(dtype))
    return p


def linear(p, x):
    """``x @ w`` in x's dtype. A weight already held in x's dtype (the
    serving engine casts block weights once) is used as it is; that is
    numerically the reference's per-call ``w.astype(x.dtype)``."""
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def init_rmsnorm(d: int, dtype: str = "float32", *, device, lead=()):
    return {"scale": torch.ones(*lead, d, device=device,
                                dtype=_dtype(dtype))}


def rmsnorm(p, x, eps: float = 1e-6):
    return rmsnorm_ops.rmsnorm(x, p["scale"], eps=eps)


def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   dtype: str = "float32"):
    table = torch.randn(vocab, d, generator=gen, device=gen.device,
                        dtype=_dtype(dtype))
    return {"table": table.mul_(0.02)}


def embed(p, ids):
    return p["table"][ids]


# ---------------------------------------------------------------------------
# Rotary position embeddings (half-split, angles in fp32)
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)       # (Dh/2,)
    angles = positions[..., :, None].float() * freqs           # (..,S,Dh/2)
    cos = torch.cos(angles)[..., None, :]                      # (..,S,1,Dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             dtype: str = "float32", lead=()):
    return {
        "wi_gate": init_linear(gen, d_model, d_ff, dtype=dtype, lead=lead),
        "wi_up": init_linear(gen, d_model, d_ff, dtype=dtype, lead=lead),
        "wo": init_linear(gen, d_ff, d_model, dtype=dtype, lead=lead),
    }


def mlp(p, x):
    h = F.silu(linear(p["wi_gate"], x)) * linear(p["wi_up"], x)
    return linear(p["wo"], h)
