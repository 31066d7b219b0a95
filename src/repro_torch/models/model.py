"""The dense decoder-only GQA transformer: parameters, the full-sequence
forward and training loss, the decode cache and one decode step.

Port of the dense branch of ``repro.models.model``: ``init_params``,
``forward_hidden``, ``forward``, ``train_loss``, ``init_decode_cache``,
``decode_step`` and the LM head. Parameters keep the reference's key
paths and stacked-layer layout (``blocks/attn/wq/w`` of shape
``(L, d_in, d_out)``), so a parameter tree crosses between the packages
through NumPy (``models.convert``). The reference's ``lax.scan`` over
the stacked layers is a Python loop over per-layer views, and its
``jax.checkpoint`` rematerialisation is not carried: autograd keeps
each layer's activations. The other families (moe, hybrid, ssm, vlm,
audio) wait for later slices.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from . import attention as attn
from .layers import (_dtype, embed, init_embedding, init_linear, init_mlp,
                     init_rmsnorm, mlp, rmsnorm, unembed)

SUPPORTED_ARCH_TYPES = ("dense",)


def _check_arch(cfg: ModelConfig) -> None:
    if cfg.arch_type not in SUPPORTED_ARCH_TYPES:
        raise NotImplementedError(
            f"arch_type {cfg.arch_type!r} ({cfg.name}) is not ported yet; "
            f"the port runs {SUPPORTED_ARCH_TYPES}")


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None) -> dict:
    """Random parameters on ``device`` (default: the GPU) from a
    ``torch.Generator`` seeded with ``seed``, in the reference's layout
    and dtypes. The numbers are not ``jax.random``'s: to compare with the
    reference, carry its parameters across with
    ``convert.params_from_numpy``."""
    _check_arch(cfg)
    device = _device.resolve(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    vocab = cfg.padded_vocab()
    dt = cfg.param_dtype
    lead = (cfg.n_layers,)
    params = {
        "embed": init_embedding(gen, vocab, cfg.d_model, dt),
        "final_norm": init_rmsnorm(cfg.d_model, dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(gen, cfg.d_model, vocab, dtype=dt)
    params["blocks"] = {
        "ln_attn": init_rmsnorm(cfg.d_model, dt, device=device, lead=lead),
        "attn": attn.init_attention(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            qkv_bias=cfg.qkv_bias, dtype=dt, lead=lead),
        "ln_mlp": init_rmsnorm(cfg.d_model, dt, device=device, lead=lead),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dt, lead=lead),
    }
    return params


def cast_block_weights(params: dict, cfg: ModelConfig) -> dict:
    """The parameter tree with every block linear weight and bias held in
    the compute dtype ``cfg.dtype``.

    ``linear`` casts its weight to the activation dtype on every call,
    as the reference does (``w.astype(x.dtype)``); casting once up front
    gives the same numbers and halves the weight bytes a bf16 step
    reads. Norm scales, the embedding and the LM head keep their dtype:
    the reference reads them in float32.
    """
    dt = _dtype(cfg.dtype)

    def cast(tree, in_linear=False):
        if isinstance(tree, dict):
            return {k: cast(v, in_linear or k in ("attn", "mlp"))
                    for k, v in tree.items()}
        return tree.to(dt) if in_linear else tree

    out = dict(params)
    out["blocks"] = cast(params["blocks"])
    return out


def _unstack(tree, n: int) -> List[dict]:
    """Stacked tree with leading layer axis -> n per-layer trees of views."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    return list(tree.unbind(0))


# ---------------------------------------------------------------------------
# Full-sequence forward and the training loss
# ---------------------------------------------------------------------------


def _attn_block(p, x, cfg: ModelConfig, *, window):
    x = x + attn.attention_forward(
        p["attn"], rmsnorm(p["ln_attn"], x, cfg.norm_eps),
        **_attn_kw(cfg, window))
    return x + mlp(p["mlp"], rmsnorm(p["ln_mlp"], x, cfg.norm_eps))


def forward_hidden(params, tokens, cfg: ModelConfig, *,
                   window: Optional[int] = None) -> torch.Tensor:
    """Final-norm hidden states (B, S, D) in ``cfg.dtype``."""
    _check_arch(cfg)
    window = window if window is not None else cfg.sliding_window
    x = embed(params["embed"], tokens).to(_dtype(cfg.dtype))
    for lp in _unstack(params["blocks"], cfg.n_layers):
        x = _attn_block(lp, x, cfg, window=window)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps)


def forward(params, tokens, cfg: ModelConfig, *,
            window: Optional[int] = None) -> torch.Tensor:
    """tokens: (B, S) int. Returns float32 logits (B, S, V_pad)."""
    return _lm_head(params, forward_hidden(params, tokens, cfg,
                                           window=window), cfg)


def train_loss(params, batch, cfg: ModelConfig, *,
               per_example: bool = False) -> torch.Tensor:
    """Summed next-token cross entropy over the label positions that are
    >= 0; padded vocab entries are masked to -1e30 before the softmax.
    Sum (not mean), so per-block losses add like the paper's
    f = sum_i f_i. ``per_example`` returns per-sequence sums (B,)."""
    logits = forward(params, batch["tokens"], cfg)
    labels = batch["labels"].long()
    vocab = cfg.padded_vocab()
    if vocab != cfg.vocab_size:
        vmask = torch.arange(vocab, device=logits.device) < cfg.vocab_size
        logits = torch.where(vmask, logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1,
                          labels.clamp(min=0)[..., None])[..., 0]
    ll = picked - lse
    mask = (labels >= 0).float()
    loss = -(ll * mask)
    if per_example:
        return loss.sum(dim=-1)
    return loss.sum()


# ---------------------------------------------------------------------------
# Serving: single-token decode with caches
# ---------------------------------------------------------------------------


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                      pos: int = 0, device=None) -> dict:
    """Cache tree for decode_step on ``device`` (default: the GPU):
    ``{"layers": {"k", "v": (L, B, S, KVH, Dh), "pos": (L, B)}}``.
    ``max_len`` is the KV capacity (window size for sliding-window
    configs)."""
    _check_arch(cfg)
    device = _device.resolve(device)
    kv_len = min(max_len, cfg.sliding_window or max_len)
    return {"layers": attn.init_cache(
        batch, kv_len, cfg.n_kv_heads, cfg.head_dim, cfg.dtype, pos=pos,
        device=device, lead=(cfg.n_layers,))}


def _attn_kw(cfg: ModelConfig, window):
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                window=window)


def _attn_block_decode(p, x, cache, cfg: ModelConfig, *, window):
    h, cache = attn.attention_decode(
        p["attn"], rmsnorm(p["ln_attn"], x, cfg.norm_eps), cache,
        **_attn_kw(cfg, window))
    x = x + h
    x = x + mlp(p["mlp"], rmsnorm(p["ln_mlp"], x, cfg.norm_eps))
    return x, cache


def _lm_head(params, x, cfg: ModelConfig) -> torch.Tensor:
    """float32 logits, as the reference computes them."""
    if cfg.tie_embeddings:
        return unembed(params["embed"], x)
    return x.float() @ params["lm_head"]["w"].float()


def decode_step(params, token, cache, cfg: ModelConfig, *,
                window: Optional[int] = None):
    """One decode step. token: (B,) int. Returns (logits (B, V_pad)
    float32, cache), the cache updated in place."""
    _check_arch(cfg)
    window = window if window is not None else cfg.sliding_window
    x = embed(params["embed"], token[:, None]).to(_dtype(cfg.dtype))
    layers = cache["layers"]
    L = cfg.n_layers
    for lp, k, v, pos in zip(_unstack(params["blocks"], L),
                             layers["k"].unbind(0), layers["v"].unbind(0),
                             layers["pos"].unbind(0)):
        x, _ = _attn_block_decode(lp, x, {"k": k, "v": v, "pos": pos},
                                  cfg, window=window)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _lm_head(params, x, cfg)[:, 0], cache
