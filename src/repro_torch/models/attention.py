"""Cached single-token decode attention with GQA and RoPE, backed by the
hand-written decode-attention kernel.

Port of ``repro.models.attention.attention_decode`` / ``init_cache``.
The reference writes the new K/V through a one-hot blend and returns a
new cache; this port writes the same values in place and returns the
cache it was given. The full-sequence training/prefill path waits for
the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention import ops as decode_ops
from .layers import _dtype, apply_rope, init_linear, linear


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
