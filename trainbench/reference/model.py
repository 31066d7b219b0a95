"""Pieces the reference families share (``dense``, ``hybrid``): plain
float32 PyTorch, no kernels, no cache, no batching, one sequence at a
time.

Parameters are a flat dict {"/"-joined path: tensor}: linear weights
(d_in, d_out) applied as x @ w, layers stacked on a leading axis. ``q8``
is applied to both operands of every linear and to the residual stream
after the embedding and after each block (the identity by default; the
control passes an fp8 rounding). Every product is float32; the caller
turns TF32 off.

The pieces: RMSNorm; GQA self-attention with half-split rotary
embeddings and a causal softmax over the whole score matrix, query head
h reading key/value head h // (H / KVH); a SwiGLU MLP; the pre-norm
block of the two; Mamba2's mixer (arXiv:2405.21060): in-projection to x,
z (expand x d_model each) and B, C (one group, d_state each) and dt (one
a head); a causal depthwise convolution of x and SiLU; dt = softplus(dt +
dt_bias), A = -exp(A_log); the selective state space recurrence h_t =
exp(dt_t A) h_{t-1} + dt_t B_t x_t^T, y_t = C_t h_t + D x_t, computed by
the paper's chunked dual form (quadratic within a chunk, a recurrence
over chunk states); y * SiLU(z); out-projection. And the final norm,
logits against the tied embedding (or an untied head) and the loss.

Model FLOPs (a family's ``step_flops``) count the operations a step's
distinct tokens need, forward and backward, whatever the program does to
compute them: matmuls 6 x (parameters in matmuls) x tokens, the
embedding lookup no matmul, the LM head over the real vocabulary, not
its padding; causal attention forward 2 x S^2 x H x Dh a sequence and
layer (Q K^T and P V over the visible half of the score matrix), times 3
for the backward. Recomputation (remat, a flash backward's second Q K^T,
masked tiles) and the copies the replicated path computes are not
counted.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30
HEAD_P = 64          # Mamba2 head width (mamba_headdim)
SSD_CHUNK = 128      # the dual form's chunk; any length gives the same y


def _ident(x):
    return x


def padded_vocab(vocab: int, multiple: int = 256) -> int:
    return ((vocab + multiple - 1) // multiple) * multiple


# ---------------------------------------------------------------------------
# Layout and initialisation
# ---------------------------------------------------------------------------


def embedding_shapes(cfg: dict) -> Dict[str, tuple]:
    """The embedding table (padded vocabulary), the final norm and, where
    the embedding is not tied, the LM head."""
    D, V = cfg["d_model"], padded_vocab(cfg["vocab_size"])
    shapes = {"embed/table": (V, D), "final_norm/scale": (D,)}
    if not cfg.get("tie_embeddings", False):
        shapes["lm_head/w"] = (D, V)
    return shapes


def attn_block_shapes(cfg: dict, pre: str, lead: tuple) -> Dict[str, tuple]:
    """One attention + SwiGLU block under ``pre``, ``lead`` stacked."""
    D, H, KVH, F_ = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], \
        cfg["d_ff"]
    Dh = D // H
    return {f"{pre}/ln_attn/scale": lead + (D,),
            f"{pre}/ln_mlp/scale": lead + (D,),
            f"{pre}/attn/wq/w": lead + (D, H * Dh),
            f"{pre}/attn/wk/w": lead + (D, KVH * Dh),
            f"{pre}/attn/wv/w": lead + (D, KVH * Dh),
            f"{pre}/attn/wo/w": lead + (H * Dh, D),
            f"{pre}/mlp/wi_gate/w": lead + (D, F_),
            f"{pre}/mlp/wi_up/w": lead + (D, F_),
            f"{pre}/mlp/wo/w": lead + (F_, D)}


def linear_init_scale(path: str, shape: tuple) -> Optional[float]:
    """None for a norm scale (1), 0.02 for the embedding, d_in**-0.5 for
    a linear weight (and K**-0.5 for a convolution's (K, C) taps)."""
    if path.rsplit("/", 1)[-1] == "scale":
        return None
    if path == "embed/table":
        return 0.02
    return shape[-2] ** -0.5


# ---------------------------------------------------------------------------
# Pieces
# ---------------------------------------------------------------------------


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, theta):
    """x: (S, H, Dh); the first and second halves of each head rotate as
    pairs by angle position * theta ** (-2i / Dh)."""
    S, _, Dh = x.shape
    inv = 1.0 / theta ** (torch.arange(0, Dh, 2, dtype=torch.float32,
                                       device=x.device) / Dh)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., :Dh // 2], x[..., Dh // 2:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


def attention(p, pre, x, cfg, q8):
    S, D = x.shape
    H, KVH = cfg["n_heads"], cfg["n_kv_heads"]
    Dh = D // H
    q = (q8(x) @ q8(p[f"{pre}/wq/w"])).reshape(S, H, Dh)
    k = (q8(x) @ q8(p[f"{pre}/wk/w"])).reshape(S, KVH, Dh)
    v = (q8(x) @ q8(p[f"{pre}/wv/w"])).reshape(S, KVH, Dh)
    theta = cfg.get("rope_theta", 10000.0)
    q, k = rope(q, theta), rope(k, theta)
    kv_of = torch.arange(H, device=x.device) // (H // KVH)
    k, v = k[:, kv_of], v[:, kv_of]                         # (S, H, Dh)
    s = torch.einsum("qhd,khd->hqk", q, k) * Dh ** -0.5
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    s = torch.where(causal, s, NEG_INF)
    o = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v)
    return q8(o.reshape(S, H * Dh)) @ q8(p[f"{pre}/wo/w"])


def swiglu(p, pre, x, q8):
    g = q8(x) @ q8(p[f"{pre}/wi_gate/w"])
    u = q8(x) @ q8(p[f"{pre}/wi_up/w"])
    return q8(F.silu(g) * u) @ q8(p[f"{pre}/wo/w"])


def attn_block(lp, x, cfg, q8):
    """One pre-norm attention + SwiGLU block; ``lp`` holds the block's
    leaves by their paths below the block."""
    eps = cfg["norm_eps"]
    x = x + attention(lp, "attn", rmsnorm(x, lp["ln_attn/scale"], eps), cfg,
                      q8)
    return x + swiglu(lp, "mlp", rmsnorm(x, lp["ln_mlp/scale"], eps), q8)


def _below(p, pre, i=None):
    n = len(pre) + 1
    return {k[n:]: (v if i is None else v[i]) for k, v in p.items()
            if k.startswith(pre + "/")}


def ssd(x, dt, A, Bm, Cm, chunk=SSD_CHUNK):
    """The selective scan by the chunked dual form. x: (S, H, P); dt:
    (S, H); A: (H,); Bm, Cm: (S, N). Returns y: (S, H, P) without the
    D skip."""
    S, H, P = x.shape
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        x, dt, Bm, Cm = (torch.cat([t, t.new_zeros((pad,) + t.shape[1:])])
                         for t in (x, dt, Bm, Cm))
    c = x.shape[0] // Q
    xc = (x * dt[..., None]).reshape(c, Q, H, P)
    a = (dt * A).reshape(c, Q, H)
    Bc, Cc = Bm.reshape(c, Q, -1), Cm.reshape(c, Q, -1)
    cum = torch.cumsum(a, dim=1)                              # (c, Q, H)
    lower = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    seg = cum[:, :, None, :] - cum[:, None, :, :]             # (c, i, j, H)
    L = torch.exp(torch.where(lower[None, :, :, None], seg, -math.inf))
    y = torch.einsum("cin,cjn,cijh,cjhp->cihp", Cc, Bc, L, xc)
    # each chunk's end state, then the recurrence over chunks
    decay_out = torch.exp(cum[:, -1:, :] - cum)               # (c, Q, H)
    st = torch.einsum("cjn,cjh,cjhp->chnp", Bc, decay_out, xc)
    h = torch.zeros_like(st[0])
    h_in = []
    for i in range(c):
        h_in.append(h)
        h = torch.exp(cum[i, -1])[:, None, None] * h + st[i]
    h_in = torch.stack(h_in)                                  # (c, H, N, P)
    y = y + torch.einsum("cin,cih,chnp->cihp", Cc, torch.exp(cum), h_in)
    return y.reshape(c * Q, H, P)[:S]


def mamba2(p, i, x, cfg, q8):
    S, D = x.shape
    N = cfg["ssm_state"]
    di = cfg.get("ssm_expand", 2) * D
    nh = di // HEAD_P
    xz = q8(x) @ q8(p["blocks/ssm/xz_proj/w"][i])
    xs, z = xz[:, :di], xz[:, di:]
    bcdt = q8(x) @ q8(p["blocks/ssm/bcdt_proj/w"][i])
    Bm, Cm, dt = bcdt[:, :N], bcdt[:, N:2 * N], bcdt[:, 2 * N:]
    w = p["blocks/ssm/conv_w"][i]                              # (K, di)
    K = w.shape[0]
    xp = torch.cat([xs.new_zeros(K - 1, di), xs])
    xs = F.silu(sum(xp[k:k + S] * w[k] for k in range(K)))
    dt = F.softplus(dt + p["blocks/ssm/dt_bias"][i])
    A = -torch.exp(p["blocks/ssm/A_log"][i])
    xh = xs.reshape(S, nh, HEAD_P)
    y = ssd(xh, dt, A, Bm, Cm) + xh * p["blocks/ssm/D"][i][:, None]
    y = y.reshape(S, di) * F.silu(z)
    return q8(y) @ q8(p["blocks/ssm/out_proj/w"][i])


def head_loss(p, x, labels, cfg, q8) -> torch.Tensor:
    """The final norm, the logits against the head and the summed
    next-token cross entropy over the real vocabulary; padding rows of
    the table never win."""
    x = rmsnorm(x, p["final_norm/scale"], cfg["norm_eps"])
    head = (p["embed/table"].T if cfg.get("tie_embeddings", False)
            else p["lm_head/w"])
    logits = q8(x) @ q8(head)
    V = cfg["vocab_size"]
    logits = logits[:, :V]
    return F.cross_entropy(logits, labels, reduction="sum")


# ---------------------------------------------------------------------------
# FLOPs of the shared pieces
# ---------------------------------------------------------------------------


def attn_block_params(cfg: dict) -> int:
    """Parameters in the matmuls of one attention + SwiGLU block."""
    D, H, KVH, F_ = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], \
        cfg["d_ff"]
    Dh = D // H
    return D * H * Dh + 2 * D * KVH * Dh + H * Dh * D + 3 * D * F_


def head_params(cfg: dict) -> int:
    """Parameters in the LM head's matmul, over the real vocabulary."""
    return cfg["d_model"] * cfg["vocab_size"]


def attention_flops(cfg: dict, seq_len: int, layers: int,
                    sequences: int) -> float:
    """Causal attention's score and value products, forward and
    backward, of ``layers`` layers over ``sequences`` sequences."""
    S, D, H = seq_len, cfg["d_model"], cfg["n_heads"]
    return 3.0 * 2.0 * S * S * H * (D // H) * layers * sequences
