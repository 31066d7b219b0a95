"""Mamba2-style selective state space (SSD) block.

Port of ``repro.models.ssm``: the chunked SSD algorithm (Dao & Gu 2024)
with a float32 interior. Within a chunk of Q steps the interactions are
a masked, decay-weighted quadratic form; across chunks a short
recurrence over per-chunk states (B, H, N, P), a Python loop here where
the reference has ``lax.scan``. Scalar-per-head decay
a_t = exp(dt_t * A_h), B/C projections shared across heads (one group).
Decode carries the state (B, H, N, P) and a rolling conv window, both
float32, and updates them in place.

The decay matrix is exp of the masked log-decay differences (masked
entries exp(-inf) = 0), where the reference masks exp of the unmasked
differences: the same values, and gradients that stay finite where a
masked difference exceeds float32's exp range (the reference's
``where(mask, exp(seg), 0)`` gives 0 * inf there).

Autograd keeps the (B, nc, Q, Q, H) intra-chunk tensors of every layer
(the reference rematerialises them under ``jax.checkpoint``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .layers import _dtype, init_linear, linear


def init_ssm(gen: torch.Generator, d_model: int, d_state: int, *,
             expand: int = 2, head_p: int = 64, conv_k: int = 4,
             dtype: str = "float32", lead=()):
    d_inner = expand * d_model
    n_heads = d_inner // head_p
    dev, dt = gen.device, _dtype(dtype)
    conv = torch.randn(*lead, conv_k, d_inner, generator=gen, device=dev,
                       dtype=dt)
    return {
        "xz_proj": init_linear(gen, d_model, 2 * d_inner, dtype=dtype,
                               lead=lead),
        "bcdt_proj": init_linear(gen, d_model, 2 * d_state + n_heads,
                                 dtype=dtype, lead=lead),
        "conv_w": conv.mul_(conv_k ** -0.5),
        "A_log": torch.zeros(*lead, n_heads, device=dev, dtype=dt),
        "dt_bias": torch.zeros(*lead, n_heads, device=dev, dtype=dt),
        "D": torch.ones(*lead, n_heads, device=dev, dtype=dt),
        "out_proj": init_linear(gen, d_inner, d_model, dtype=dtype,
                                lead=lead),
    }


def _project(p, u, d_state):
    x, z = linear(p["xz_proj"], u).chunk(2, dim=-1)
    bcdt = linear(p["bcdt_proj"], u)
    Bs, Cs, dt = bcdt.split([d_state, d_state, bcdt.shape[-1] - 2 * d_state],
                            dim=-1)
    return x, z, Bs, Cs, dt


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad dim 1 (the sequence) at its end."""
    if not pad:
        return t
    return torch.cat([t, t.new_zeros((t.shape[0], pad) + t.shape[2:])],
                     dim=1)


def masked_decay(cum: torch.Tensor) -> torch.Tensor:
    """cum: (B, nc, Q, H) cumulative log decay. Returns (B, nc, Q, Q, H)
    with exp(cum_i - cum_j) where i >= j and 0 elsewhere."""
    Q = cum.shape[2]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    ii = torch.arange(Q, device=cum.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    return torch.exp(torch.where(causal, seg, float("-inf")))


def ssm_forward(p, u, *, d_state: int, expand: int = 2, head_p: int = 64,
                chunk: int = 256) -> torch.Tensor:
    """u: (B, S, D) -> (B, S, D). Chunked SSD."""
    B, S, D = u.shape
    d_inner = expand * D
    H = d_inner // head_p
    x, z, Bs, Cs, dt = _project(p, u, d_state)

    # causal depthwise conv on x, in x's dtype
    K = p["conv_w"].shape[0]
    xp = torch.cat([x.new_zeros(B, K - 1, d_inner), x], dim=1)
    x = sum(xp[:, i:i + S] * p["conv_w"][i].to(x.dtype) for i in range(K))
    x = F.silu(x)

    dt = F.softplus(dt.float() + p["dt_bias"].float())        # (B,S,H)
    A = -torch.exp(p["A_log"].float())                          # (H,)
    la = dt * A                                                 # <= 0

    Q = min(chunk, S)
    pad = (-S) % Q
    x, Bs, Cs, la, dt = (_pad_seq(t, pad) for t in (x, Bs, Cs, la, dt))
    Sp = x.shape[1]
    nc = Sp // Q

    xh = x.reshape(B, nc, Q, H, head_p).float()
    Bc = Bs.reshape(B, nc, Q, d_state).float()
    Cc = Cs.reshape(B, nc, Q, d_state).float()
    lac = la.reshape(B, nc, Q, H)
    dtc = dt.reshape(B, nc, Q, H)

    cum = torch.cumsum(lac, dim=2)                              # (B,nc,Q,H)
    total = cum[:, :, -1, :]                                    # (B,nc,H)

    # intra-chunk: decay(i, j) = exp(cum_i - cum_j) for i >= j
    decay = masked_decay(cum)                                   # (B,nc,Q,Q,H)
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    scores = cb[..., None] * decay
    xdt = xh * dtc[..., None]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, xdt)

    # chunk states and the cross-chunk recurrence; step j contributes
    # exp(total - cum_j) dt_j B_j x_j to its chunk's end state
    w_end = torch.exp(total[:, :, None, :] - cum)               # (B,nc,Q,H)
    states = torch.einsum("bcjn,bcjh,bcjhp->bchnp", Bc, w_end * dtc, xh)
    h = torch.zeros(B, H, d_state, head_p, dtype=torch.float32,
                    device=u.device)
    h_in = []                                   # the state entering chunk c
    for c in range(nc):
        h_in.append(h)
        h = torch.exp(total[:, c])[..., None, None] * h + states[:, c]
    h_in = torch.stack(h_in, dim=1)                             # (B,nc,H,N,P)

    y_inter = torch.einsum("bcin,bcih,bchnp->bcihp", Cc, torch.exp(cum),
                           h_in)
    y = (y_intra + y_inter).reshape(B, Sp, H, head_p)
    y = y + xh.reshape(B, Sp, H, head_p) * p["D"].float()[None, None, :,
                                                          None]
    y = y[:, :S].reshape(B, S, d_inner).to(u.dtype)
    y = y * F.silu(z)
    return linear(p["out_proj"], y)


def ssm_decode(p, u, state, *, d_state: int, expand: int = 2,
               head_p: int = 64) -> Tuple[torch.Tensor, dict]:
    """Single-step recurrence. u: (B, 1, D).

    state = {"h": (B, H, N, P) float32, "conv": (B, K-1, d_inner)
    float32}, updated in place and returned."""
    B, _, D = u.shape
    d_inner = expand * D
    H = d_inner // head_p
    x, z, Bs, Cs, dt = _project(p, u, d_state)

    K = p["conv_w"].shape[0]
    # the window is float32, as the reference's concatenation promotes it
    win = torch.cat([state["conv"], x.to(state["conv"].dtype)], dim=1)
    xc = sum(win[:, i:i + 1] * p["conv_w"][i].to(x.dtype) for i in range(K))
    xc = F.silu(xc)

    dt = F.softplus(dt.float() + p["dt_bias"].float())[:, 0]   # (B,H)
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(dt * A[None, :])                              # (B,H)

    xh = xc[:, 0].reshape(B, H, head_p).float()
    Bv = Bs[:, 0].float()                                       # (B,N)
    Cv = Cs[:, 0].float()
    h = a[..., None, None] * state["h"] + torch.einsum(
        "bn,bh,bhp->bhnp", Bv, dt, xh)
    y = torch.einsum("bn,bhnp->bhp", Cv, h)
    y = y + xh * p["D"].float()[None, :, None]
    y = y.reshape(B, 1, d_inner).to(u.dtype)
    y = y * F.silu(z)
    state["h"].copy_(h)
    state["conv"].copy_(win[:, 1:])
    return linear(p["out_proj"], y), state


def init_ssm_state(batch: int, d_model: int, d_state: int, *,
                   expand: int = 2, head_p: int = 64, conv_k: int = 4,
                   device, lead=()):
    d_inner = expand * d_model
    H = d_inner // head_p
    return {
        "h": torch.zeros(*lead, batch, H, d_state, head_p,
                         dtype=torch.float32, device=device),
        "conv": torch.zeros(*lead, batch, conv_k - 1, d_inner,
                            dtype=torch.float32, device=device),
    }
