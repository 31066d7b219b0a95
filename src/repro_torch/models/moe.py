"""Mixture-of-Experts layer: shared experts + routed experts.

Port of ``repro.models.moe``: *expert-choice* routing (each expert picks
its top-C tokens, C = S * top_k / E * capacity_factor), dense and
statically shaped, and the reference's *token-choice* router with dense
expert compute, kept for small parity checks.

Two choices keep the port's numbers those of the reference, run after
run:

- Tie order. ``jax.lax.top_k`` returns equal values lower index first;
  ``torch.topk`` promises no order among ties. Router probabilities are
  float32 softmaxes of bf16 logits on the card, so ties happen. The
  top-C here is a stable descending sort, cut at C, which keeps the
  reference's order.
- The combine back to token positions. The reference scatter-adds
  (``y.at[b, idx].add(yo)``); ``index_add_`` on a CUDA tensor adds with
  float atomics, whose order changes from run to run. Here each
  expert's outputs reach their tokens through a one-hot (B, S, E*C)
  matrix product, a sum in a fixed order on every device.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .layers import _dtype, init_linear, init_mlp, linear, mlp


def init_moe(gen: torch.Generator, d_model: int, expert_d_ff: int,
             n_experts: int, n_shared: int, shared_d_ff: int,
             dtype: str = "float32", lead=()):
    dev, dt = gen.device, _dtype(dtype)

    def experts(d_in, d_out):
        w = torch.randn(*lead, n_experts, d_in, d_out, generator=gen,
                        device=dev, dtype=dt)
        return w.mul_(d_in ** -0.5)

    p = {
        "router": init_linear(gen, d_model, n_experts, dtype=dtype,
                              lead=lead),
        # stacked expert SwiGLU weights: (E, d_model, ff) / (E, ff, d_model)
        "w_gate": experts(d_model, expert_d_ff),
        "w_up": experts(d_model, expert_d_ff),
        "w_down": experts(expert_d_ff, d_model),
    }
    if n_shared:
        p["shared"] = init_mlp(gen, d_model, shared_d_ff, dtype=dtype,
                               lead=lead)
    return p


def top_k_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last dim,
    ties lower index first (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_expert_choice(p, x, *, top_k: int, capacity_factor: float = 1.0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-choice MoE forward. x: (B, S, D). Returns (y, aux_loss);
    the capacity per expert is C = int(S * top_k * capacity_factor) // E
    (at least 1)."""
    B, S, D = x.shape
    E = p["router"]["w"].shape[-1]
    C = max(1, int(S * top_k * capacity_factor) // E)

    logits = linear(p["router"], x).float()                  # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = top_k_stable(probs.transpose(1, 2), C)       # (B, E, C)
    xg = x[torch.arange(B, device=x.device)[:, None, None], idx]
    h = F.silu(torch.einsum("becd,edf->becf", xg,
                            p["w_gate"].to(x.dtype))) * \
        torch.einsum("becd,edf->becf", xg, p["w_up"].to(x.dtype))
    yo = torch.einsum("becf,efd->becd", h, p["w_down"].to(x.dtype))
    yo = yo * gates[..., None].to(x.dtype)
    # back to token positions: y[b, s] = sum over (e, c) with idx = s
    onehot = x.new_zeros(B, E * C, S).scatter_(
        2, idx.reshape(B, E * C, 1), 1.0)                      # (B, EC, S)
    y = onehot.transpose(1, 2) @ yo.reshape(B, E * C, D)
    if "shared" in p:
        y = y + mlp(p["shared"], x)
    return y, torch.zeros((), dtype=torch.float32, device=x.device)


def moe_token_choice_dense(p, x, *, top_k: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k token-choice router with *dense* expert compute (every
    expert runs on every token; the combine masks to the top k). O(E)
    compute, smoke scale only. Returns (y, Switch-style aux loss)."""
    E = p["router"]["w"].shape[-1]
    logits = linear(p["router"], x).float()                  # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    _, top_idx = top_k_stable(probs, top_k)
    mask = F.one_hot(top_idx, E).sum(-2).float()             # (B, S, E)
    combine = probs * mask
    combine = combine / torch.clamp(combine.sum(-1, keepdim=True),
                                    min=1e-9)
    h = F.silu(torch.einsum("bsd,edf->besf", x, p["w_gate"].to(x.dtype))) \
        * torch.einsum("bsd,edf->besf", x, p["w_up"].to(x.dtype))
    yo = torch.einsum("besf,efd->besd", h, p["w_down"].to(x.dtype))
    y = torch.einsum("bse,besd->bsd", combine.to(x.dtype), yo)
    if "shared" in p:
        y = y + mlp(p["shared"], x)
    frac_tokens = mask.mean(dim=(0, 1))                      # (E,)
    frac_probs = probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac_tokens * frac_probs)
    return y, aux
