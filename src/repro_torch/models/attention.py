"""Attention with GQA and RoPE: the full-sequence (training) path and
the cached single-token decode path backed by the hand-written
decode-attention kernel.

Port of ``repro.models.attention``. ``attention_forward`` computes what
the reference's ``blockwise_attention`` computes -- causal or
bidirectional, plus an optional sliding window ``k > q - window``
(``_block_mask``), scores and softmax in float32, probabilities cast to
the input dtype before the value product, float32 accumulation -- as one
masked softmax over the whole key axis: the reference has no Pallas
kernel there, and at the training and prefill lengths used here the
(Sq x Sk) scores fit. The reference's online softmax over 512-key blocks
is the same function up to float32 rounding. Self-attention applies
RoPE to q and k; cross-attention (``kv=``, the audio decoder over the
encoder output) takes K and V from the source with no RoPE and no mask.

``attention_decode`` writes the new K/V in place (the reference blends
a one-hot and returns a new cache) and returns the cache it was given.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention import ops as decode_ops
from .layers import _dtype, apply_rope, init_linear, linear

NEG_INF = -1e30


def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int, *,
                   qkv_bias: bool = False, dtype: str = "float32",
                   lead=()):
    return {
        "wq": init_linear(gen, d_model, n_heads * head_dim, bias=qkv_bias,
                          dtype=dtype, lead=lead),
        "wk": init_linear(gen, d_model, n_kv_heads * head_dim,
                          bias=qkv_bias, dtype=dtype, lead=lead),
        "wv": init_linear(gen, d_model, n_kv_heads * head_dim,
                          bias=qkv_bias, dtype=dtype, lead=lead),
        "wo": init_linear(gen, n_heads * head_dim, d_model, dtype=dtype,
                          lead=lead),
    }


def _mask(sq: int, sk: int, causal: bool, window: Optional[int],
          device) -> Optional[torch.Tensor]:
    """(Sq, Sk) boolean mask, or None for none: key k <= query q when
    causal, and k > q - window."""
    if not causal and window is None:
        return None
    qp = torch.arange(sq, device=device)[:, None]
    kp = torch.arange(sk, device=device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    return mask


def grouped_attention(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k, v: (B, Sk, KVH, Dh), H % KVH == 0.
    Returns (B, Sq, H, Dh) in q.dtype. Query head h reads KV head
    h // (H // KVH), the reference's (KVH, G) grouping."""
    B, Sq, H, Dh = q.shape
    G = H // k.shape[2]
    qf = q.float().permute(0, 2, 1, 3)                         # B,H,Sq,Dh
    kf = k.float().repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    vf = v.repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    s = (qf @ kf.transpose(-1, -2)) * Dh ** -0.5               # B,H,Sq,Sk
    mask = _mask(Sq, k.shape[1], causal, window, q.device)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = (p.to(q.dtype).float() @ vf.float()) / torch.clamp(l, min=1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def attention_forward(p, x, *, n_heads: int, n_kv_heads: int,
                      head_dim: int, rope_theta: float,
                      causal: bool = True,
                      window: Optional[int] = None,
                      kv: Optional[torch.Tensor] = None):
    """Full-sequence attention (training, prefill, the encoder). x:
    (B, S, D). ``kv``: a cross-attention source (B, Ssrc, D); K and V
    then come from it, with no RoPE and no mask. ``causal=False`` is the
    encoder's bidirectional self-attention (RoPE, no causal mask)."""
    B, S, _ = x.shape
    src = x if kv is None else kv
    Sk = src.shape[1]
    q = linear(p["wq"], x).reshape(B, S, n_heads, head_dim)
    k = linear(p["wk"], src).reshape(B, Sk, n_kv_heads, head_dim)
    v = linear(p["wv"], src).reshape(B, Sk, n_kv_heads, head_dim)
    if kv is None:
        pos = torch.arange(S, device=x.device)[None, :].expand(B, S)
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    out = grouped_attention(q, k, v, causal=causal and kv is None,
                            window=window)
    return linear(p["wo"], out.reshape(B, S, n_heads * head_dim))


def attention_decode(p, x, cache, *, n_heads: int, n_kv_heads: int,
                     head_dim: int, rope_theta: float,
                     window: Optional[int] = None):
    """Single-token decode with KV cache, updated in place.

    x: (B, 1, D). cache: {"k","v": (B, S, KVH, Dh), "pos": (B,) int32}.
    Writes the new K/V at position pos (mod the cache size for
    sliding-window caches; a write past a full-attention cache is
    dropped, as the reference's one-hot blend drops it), attends over
    the valid prefix and advances pos. Returns (out (B, 1, D), cache).
    """
    B = x.shape[0]
    k_cache, v_cache, pos = cache["k"], cache["v"], cache["pos"]
    S_cache = k_cache.shape[1]
    q = linear(p["wq"], x).reshape(B, 1, n_heads, head_dim)
    k_new = linear(p["wk"], x).reshape(B, n_kv_heads, head_dim)
    v_new = linear(p["wv"], x).reshape(B, n_kv_heads, head_dim)
    q = apply_rope(q, pos[:, None], rope_theta)
    k_new = apply_rope(k_new[:, None], pos[:, None], rope_theta)[:, 0]

    slot = pos % S_cache if window is not None else pos
    rows = torch.arange(B, device=x.device)
    at = slot.clamp(max=S_cache - 1)
    keep = (slot < S_cache)[:, None, None]
    k_cache[rows, at] = torch.where(keep, k_new.to(k_cache.dtype),
                                    k_cache[rows, at])
    v_cache[rows, at] = torch.where(keep, v_new.to(v_cache.dtype),
                                    v_cache[rows, at])

    lengths = torch.clamp(pos + 1, max=S_cache).to(torch.int32)
    out = decode_ops.decode_attention(q[:, 0], k_cache, v_cache, lengths)
    out = linear(p["wo"], out.reshape(B, 1, n_heads * head_dim))
    pos.add_(1)
    return out, cache


def init_cache(batch: int, max_len: int, n_kv_heads: int, head_dim: int,
               dtype: str = "bfloat16", *, pos: int = 0, device, lead=()):
    shape = (*lead, batch, max_len, n_kv_heads, head_dim)
    return {
        "k": torch.zeros(shape, dtype=_dtype(dtype), device=device),
        "v": torch.zeros(shape, dtype=_dtype(dtype), device=device),
        "pos": torch.full((*lead, batch), pos, dtype=torch.int32,
                          device=device),
    }
