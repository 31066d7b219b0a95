"""Model assembly for every architecture family: parameters, the
full-sequence forward and training loss, prefill, the decode cache and
one decode step.

Port of ``repro.models.model``. Families (``config.arch_type``):

- dense / vlm : decoder-only GQA transformer (vlm takes a stubbed
  patch-embedding prefix).
- moe         : the same backbone with an MoE FFN (shared + routed
  experts, expert-choice routing).
- hybrid      : Mamba2 (SSD) backbone with one *shared* attention block
  applied at ``attn_positions`` (Zamba2).
- ssm         : xLSTM, super-blocks of ``slstm_ratio`` mLSTM blocks and
  one sLSTM block.
- audio       : encoder-decoder; the encoder takes stubbed frame
  embeddings, the decoder is causal with cross-attention (Seamless).

Parameters keep the reference's key paths and stacked-layer layout
(``blocks/attn/wq/w`` of shape ``(L, d_in, d_out)``), so a parameter
tree crosses between the packages through NumPy (``models.convert``).
The reference's ``lax.scan`` over the stacked layers is a Python loop
over per-layer views. Its ``jax.checkpoint`` rematerialisation is
carried where it sits: when grad is enabled, each layer of dense, vlm,
moe and audio (decoder and encoder), each SSM layer of the hybrid (not
its shared-attention insertions) and each xLSTM super-block, with each
of its mLSTM layers inside it, runs under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: the forward
keeps a layer's input and its backward recomputes the layer, so
training memory per layer is its residual. Decoding and prefill run
under no grad and recompute nothing. Decode caches (KV, SSM and xLSTM
states) are updated in place.

On a model group (``dist.tensor_parallel.executing``) each rank holds
its shards of the parameters (``tensor_parallel.shard_params``) and the
modules run tensor-parallel on the rank's heads, units or hidden block
(``layers``, ``attention``, ``moe``, ``ssm``, ``xlstm``); only a split
that cuts a head (attention, the mLSTM, Mamba2 where M does not divide
their heads) is gathered at use. Where the vocabulary is
split, the LM head yields this rank's block of the logits: the training
loss takes its log-sum-exp over the group
(``tensor_parallel.vocab_parallel_nll``), and ``forward``, ``prefill``
and ``decode_step`` gather the whole logits. A rematerialised layer
re-runs its collectives in the backward, on every rank in the same
order.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.dist import tensor_parallel as tp
from repro_torch.spans import span
from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from . import xlstm as xlstm_mod
from .layers import (_dtype, embed, init_embedding, init_linear, init_mlp,
                     init_rmsnorm, mlp, rmsnorm, unembed)

ARCH_TYPES = ("dense", "vlm", "moe", "hybrid", "ssm", "audio")


def _check_arch(cfg: ModelConfig) -> None:
    if cfg.arch_type not in ARCH_TYPES:
        raise ValueError(f"unknown arch_type {cfg.arch_type!r}")


def _n_super(cfg: ModelConfig) -> int:
    """xLSTM super-blocks: slstm_ratio mLSTM blocks and one sLSTM."""
    return cfg.n_layers // (cfg.slstm_ratio + 1)


# ---------------------------------------------------------------------------
# Parameter initialisation
# ---------------------------------------------------------------------------


def _init_attn_block(gen, cfg: ModelConfig, lead, *, cross: bool = False):
    dt, dev = cfg.param_dtype, gen.device
    p = {
        "ln_attn": init_rmsnorm(cfg.d_model, dt, device=dev, lead=lead),
        "attn": attn.init_attention(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            qkv_bias=cfg.qkv_bias, dtype=dt, lead=lead),
        "ln_mlp": init_rmsnorm(cfg.d_model, dt, device=dev, lead=lead),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dt, lead=lead),
    }
    if cross:
        p["ln_cross"] = init_rmsnorm(cfg.d_model, dt, device=dev, lead=lead)
        p["cross"] = attn.init_attention(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            dtype=dt, lead=lead)
    return p


def _init_moe_block(gen, cfg: ModelConfig, lead):
    dt, dev = cfg.param_dtype, gen.device
    return {
        "ln_attn": init_rmsnorm(cfg.d_model, dt, device=dev, lead=lead),
        "attn": attn.init_attention(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            qkv_bias=cfg.qkv_bias, dtype=dt, lead=lead),
        "ln_mlp": init_rmsnorm(cfg.d_model, dt, device=dev, lead=lead),
        "moe": moe_mod.init_moe(
            gen, cfg.d_model, cfg.expert_d_ff, cfg.n_experts,
            cfg.n_shared_experts,
            cfg.expert_d_ff * max(cfg.n_shared_experts, 1), dt, lead=lead),
    }


def _init_ssm_block(gen, cfg: ModelConfig, lead):
    dt, dev = cfg.param_dtype, gen.device
    return {
        "ln": init_rmsnorm(cfg.d_model, dt, device=dev, lead=lead),
        "ssm": ssm_mod.init_ssm(gen, cfg.d_model, cfg.ssm_state,
                                expand=cfg.ssm_expand, conv_k=cfg.ssm_conv,
                                dtype=dt, lead=lead),
    }


def _init_mlstm_block(gen, cfg: ModelConfig, lead):
    dt, dev = cfg.param_dtype, gen.device
    return {
        "ln": init_rmsnorm(cfg.d_model, dt, device=dev, lead=lead),
        "mlstm": xlstm_mod.init_mlstm(gen, cfg.d_model, cfg.n_heads, dt,
                                      lead=lead),
        "ln_mlp": init_rmsnorm(cfg.d_model, dt, device=dev, lead=lead),
        "mlp": init_mlp(gen, cfg.d_model, 2 * cfg.d_model, dt, lead=lead),
    }


def _init_slstm_block(gen, cfg: ModelConfig, lead):
    dt, dev = cfg.param_dtype, gen.device
    return {
        "ln": init_rmsnorm(cfg.d_model, dt, device=dev, lead=lead),
        "slstm": xlstm_mod.init_slstm(gen, cfg.d_model, dt, lead=lead),
        "ln_mlp": init_rmsnorm(cfg.d_model, dt, device=dev, lead=lead),
        "mlp": init_mlp(gen, cfg.d_model, 2 * cfg.d_model, dt, lead=lead),
    }


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None) -> dict:
    """Random parameters on ``device`` (default: the GPU) from a
    ``torch.Generator`` seeded with ``seed``, in the reference's layout,
    scales and dtypes. The numbers are not ``jax.random``'s: to compare
    with the reference, carry its parameters across with
    ``convert.params_from_numpy``."""
    _check_arch(cfg)
    device = _device.resolve(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    vocab = cfg.padded_vocab()
    dt = cfg.param_dtype
    L = (cfg.n_layers,)
    params = {
        "embed": init_embedding(gen, vocab, cfg.d_model, dt),
        "final_norm": init_rmsnorm(cfg.d_model, dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(gen, cfg.d_model, vocab, dtype=dt)
    at = cfg.arch_type
    if at in ("dense", "vlm"):
        params["blocks"] = _init_attn_block(gen, cfg, L)
    elif at == "moe":
        params["blocks"] = _init_moe_block(gen, cfg, L)
    elif at == "hybrid":
        params["blocks"] = _init_ssm_block(gen, cfg, L)
        params["shared_attn"] = _init_attn_block(gen, cfg, ())
    elif at == "ssm":
        n_super = _n_super(cfg)
        params["mlstm_blocks"] = _init_mlstm_block(
            gen, cfg, (n_super * cfg.slstm_ratio,))
        params["slstm_blocks"] = _init_slstm_block(gen, cfg, (n_super,))
    elif at == "audio":
        params["encoder"] = _init_attn_block(gen, cfg,
                                             (cfg.n_encoder_layers,))
        params["enc_norm"] = init_rmsnorm(cfg.d_model, dt, device=device)
        params["blocks"] = _init_attn_block(gen, cfg, L, cross=True)
    return params


# Subtrees whose leaves are all read as ``w.astype(x.dtype)`` by the
# reference (linears, expert weights, the SSM's conv filter) -- apart
# from the SSM's float32 scalars, which it reads in float32.
_COMPUTE_DTYPE_GROUPS = ("attn", "cross", "mlp", "moe", "ssm", "mlstm",
                         "slstm")
_FLOAT32_LEAVES = ("A_log", "dt_bias", "D")
_BLOCK_TREES = ("blocks", "shared_attn", "encoder", "mlstm_blocks",
                "slstm_blocks")


def cast_block_weights(params: dict, cfg: ModelConfig) -> dict:
    """The parameter tree with every block linear weight and bias (and
    the expert weights and the SSM's conv filter) held in the compute
    dtype ``cfg.dtype``.

    Each of them is cast to the activation dtype on every call, as the
    reference does (``w.astype(x.dtype)``); casting once up front gives
    the same numbers and halves the weight bytes a bf16 step reads. Norm
    scales, the SSM's ``A_log``, ``dt_bias`` and ``D``, the embedding
    and the LM head keep their dtype: the reference reads them in
    float32.
    """
    dt = _dtype(cfg.dtype)

    def cast(tree, in_group=False):
        if isinstance(tree, dict):
            return {k: (v if k in _FLOAT32_LEAVES else
                        cast(v, in_group or k in _COMPUTE_DTYPE_GROUPS))
                    for k, v in tree.items()}
        return tree.to(dt) if in_group else tree

    return {k: cast(v) if k in _BLOCK_TREES else v
            for k, v in params.items()}


def _layers(tree) -> List[dict]:
    """The per-layer views of a tree stacked on a leading layer axis."""
    if isinstance(tree, dict):
        per = {k: _layers(v) for k, v in tree.items()}
        n = len(next(iter(per.values())))
        return [{k: per[k][i] for k in per} for i in range(n)]
    return list(tree.unbind(0))


# ---------------------------------------------------------------------------
# Block application (full sequence)
# ---------------------------------------------------------------------------


def _attn_kw(cfg: ModelConfig, window):
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                window=window)


def _attn_block(p, x, cfg: ModelConfig, *, window, causal=True,
                cross_kv=None):
    x = x + attn.attention_forward(
        p["attn"], rmsnorm(p["ln_attn"], x, cfg.norm_eps), causal=causal,
        **_attn_kw(cfg, window))
    if cross_kv is not None:
        x = x + attn.attention_forward(
            p["cross"], rmsnorm(p["ln_cross"], x, cfg.norm_eps),
            kv=cross_kv, **_attn_kw(cfg, None))
    return x + mlp(p["mlp"], rmsnorm(p["ln_mlp"], x, cfg.norm_eps),
                   cfg.d_ff)


def _moe_block(p, x, cfg: ModelConfig, *, window):
    x = x + attn.attention_forward(
        p["attn"], rmsnorm(p["ln_attn"], x, cfg.norm_eps),
        **_attn_kw(cfg, window))
    y, _ = moe_mod.moe_expert_choice(
        p["moe"], rmsnorm(p["ln_mlp"], x, cfg.norm_eps), top_k=cfg.top_k,
        **_moe_widths(cfg))
    return x + y


def _moe_widths(cfg: ModelConfig):
    return dict(d_ff=cfg.expert_d_ff,
                shared_d_ff=cfg.expert_d_ff * max(cfg.n_shared_experts, 1))


def _ssm_block(p, x, cfg: ModelConfig):
    return x + ssm_mod.ssm_forward(
        p["ssm"], rmsnorm(p["ln"], x, cfg.norm_eps),
        d_state=cfg.ssm_state, expand=cfg.ssm_expand)


def _mlstm_block(p, x, cfg: ModelConfig):
    x = x + xlstm_mod.mlstm_forward(
        p["mlstm"], rmsnorm(p["ln"], x, cfg.norm_eps), n_heads=cfg.n_heads)
    return x + mlp(p["mlp"], rmsnorm(p["ln_mlp"], x, cfg.norm_eps),
                   2 * cfg.d_model)


def _slstm_block(p, x, cfg: ModelConfig):
    x = x + xlstm_mod.slstm_forward(
        p["slstm"], rmsnorm(p["ln"], x, cfg.norm_eps))
    return x + mlp(p["mlp"], rmsnorm(p["ln_mlp"], x, cfg.norm_eps),
                   2 * cfg.d_model)


def _segments(cfg: ModelConfig):
    """Hybrid: the SSM layer ranges [lo, hi) between the shared-attention
    insertions, each but the last followed by one."""
    bounds = [0] + sorted(cfg.attn_positions) + [cfg.n_layers]
    return [(bounds[s], bounds[s + 1], s < len(bounds) - 2)
            for s in range(len(bounds) - 1)]


# Test hook: False runs the training forward without rematerialisation.
_REMAT = True


def _remat(body, x):
    """``body(x)``, rematerialised in the backward when grad is enabled
    (the reference's ``jax.checkpoint``). ``use_reentrant=False``: the
    per-row gradients take ``torch.autograd.grad``, which the re-entrant
    form does not support; the blocks draw no random numbers, so no RNG
    state is kept. The body runs in the ``block`` span, which the
    recompute enters again."""
    def spanned(h):
        with span("block"):
            return body(h)
    if _REMAT and torch.is_grad_enabled():
        return checkpoint(spanned, x, use_reentrant=False,
                          preserve_rng_state=False)
    return spanned(x)


def _backbone(params, x, cfg: ModelConfig, *, window, src=None):
    """The layer stack over embedded inputs x (B, S, D)."""
    at = cfg.arch_type
    if at in ("dense", "vlm"):
        for lp in _layers(params["blocks"]):
            x = _remat(lambda h, lp=lp: _attn_block(lp, h, cfg,
                                                     window=window), x)
    elif at == "moe":
        for lp in _layers(params["blocks"]):
            x = _remat(lambda h, lp=lp: _moe_block(lp, h, cfg,
                                                    window=window), x)
    elif at == "hybrid":
        blocks = _layers(params["blocks"])
        for lo, hi, then_attn in _segments(cfg):
            for lp in blocks[lo:hi]:
                x = _remat(lambda h, lp=lp: _ssm_block(lp, h, cfg), x)
            if then_attn:
                # outside the reference's remat'd scan: not recomputed
                x = _attn_block(params["shared_attn"], x, cfg,
                                window=window)
    elif at == "ssm":
        r = cfg.slstm_ratio
        mblocks = _layers(params["mlstm_blocks"])

        def super_block(h, mps, sp):
            for mp in mps:
                h = _remat(lambda hh, mp=mp: _mlstm_block(mp, hh, cfg), h)
            return _slstm_block(sp, h, cfg)
        for s, sp in enumerate(_layers(params["slstm_blocks"])):
            x = _remat(lambda h, mps=mblocks[s * r:(s + 1) * r], sp=sp:
                       super_block(h, mps, sp), x)
    elif at == "audio":
        for lp in _layers(params["blocks"]):
            x = _remat(lambda h, lp=lp: _attn_block(
                lp, h, cfg, window=window, cross_kv=src), x)
    else:
        raise ValueError(f"unknown arch_type {at!r}")
    return x


def encode(params, src_embeds, cfg: ModelConfig) -> torch.Tensor:
    """Audio (encoder-decoder) encoder: bidirectional attention over
    frame embeddings (B, Ssrc, D); returns the normed output in
    ``cfg.dtype``."""
    x = src_embeds.to(_dtype(cfg.dtype))
    for lp in _layers(params["encoder"]):
        x = _remat(lambda h, lp=lp: _attn_block(lp, h, cfg, window=None,
                                                 causal=False), x)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _lm_head(params, x, cfg: ModelConfig, *,
             whole: bool = True) -> torch.Tensor:
    """float32 logits, as the reference computes them. Where a model
    group splits the vocabulary, ``whole=False`` keeps this rank's block
    of them."""
    vocab = cfg.padded_vocab()
    if cfg.tie_embeddings:
        logits = unembed(params["embed"], x, vocab)
    else:
        if tp.splits(vocab):
            x = tp.copy_to(x)
        logits = x.float() @ params["lm_head"]["w"].float()
    if whole and tp.splits(vocab):
        logits = tp.gather(logits, -1)
    return logits


def forward_hidden(params, tokens, cfg: ModelConfig, *,
                   prefix: Optional[torch.Tensor] = None,
                   src: Optional[torch.Tensor] = None,
                   window: Optional[int] = None) -> torch.Tensor:
    """Final-norm hidden states (B, P + S, D) in ``cfg.dtype``. prefix:
    (B, P, D) stub embeddings put before the tokens (vlm); src:
    (B, Ssrc, D) stub frame embeddings for the encoder (audio)."""
    _check_arch(cfg)
    window = window if window is not None else cfg.sliding_window
    dt = _dtype(cfg.dtype)
    x = embed(params["embed"], tokens, cfg.padded_vocab()).to(dt)
    if prefix is not None:
        x = torch.cat([prefix.to(dt), x], dim=1)
    enc = encode(params, src, cfg) if src is not None else None
    x = _backbone(params, x, cfg, window=window, src=enc)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps)


def forward(params, tokens, cfg: ModelConfig, *,
            prefix: Optional[torch.Tensor] = None,
            src: Optional[torch.Tensor] = None,
            window: Optional[int] = None) -> torch.Tensor:
    """tokens: (B, S) int. Returns float32 logits (B, P + S, V_pad)."""
    return _lm_head(params, forward_hidden(params, tokens, cfg,
                                           prefix=prefix, src=src,
                                           window=window), cfg)


def train_loss(params, batch, cfg: ModelConfig, *,
               per_example: bool = False) -> torch.Tensor:
    """Summed next-token cross entropy over the label positions that are
    >= 0; padded vocab entries are masked to -1e30 before the softmax;
    a vlm prefix's positions carry no loss. Sum (not mean), so per-block
    losses add like the paper's f = sum_i f_i. ``per_example`` returns
    per-sequence sums (B,). The LM head and the loss's log-sum-exp run
    in the ``lm_head`` span."""
    prefix = batch.get("prefix")
    x = forward_hidden(params, batch["tokens"], cfg, prefix=prefix,
                       src=batch.get("src"))
    with span("lm_head"):
        logits = _lm_head(params, x, cfg, whole=False)
        if prefix is not None:
            logits = logits[:, prefix.shape[1]:]
        labels = batch["labels"].long()
        vocab = cfg.padded_vocab()
        split = tp.splits(vocab)
        if vocab != cfg.vocab_size:
            lo = tp.local_range(vocab)[0] if split else 0
            vmask = (torch.arange(logits.shape[-1], device=logits.device)
                     + lo) < cfg.vocab_size
            logits = torch.where(vmask, logits, -1e30)
        if split:
            ll = tp.vocab_parallel_nll(logits, labels.clamp(min=0), vocab)
        else:
            lse = torch.logsumexp(logits, dim=-1)
            picked = torch.gather(logits, -1,
                                  labels.clamp(min=0)[..., None])[..., 0]
            ll = picked - lse
    mask = (labels >= 0).float()
    loss = -(ll * mask)
    if per_example:
        return loss.sum(dim=-1)
    return loss.sum()


def prefill(params, tokens, cfg: ModelConfig, *,
            prefix: Optional[torch.Tensor] = None,
            src: Optional[torch.Tensor] = None,
            window: Optional[int] = None) -> torch.Tensor:
    """The full forward's last-position logits (B, V_pad), float32. The
    LM head runs on the last position only, as in the reference."""
    x = forward_hidden(params, tokens, cfg, prefix=prefix, src=src,
                       window=window)
    return _lm_head(params, x[:, -1], cfg)


# ---------------------------------------------------------------------------
# Serving: single-token decode with caches
# ---------------------------------------------------------------------------


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                      pos: int = 0, src_len: int = 0, device=None) -> dict:
    """Cache tree for decode_step on ``device`` (default: the GPU), with
    the reference's leaves and stacked layer axes:

    - dense, vlm, moe: ``{"layers": {"k", "v": (L, B, S, KVH, Dh),
      "pos": (L, B)}}``;
    - hybrid: ``{"ssm": {"h", "conv"}, "attn": {"k", "v", "pos"}}`` with
      one attention cache per shared-attention insertion;
    - ssm: ``{"mlstm": {"C", "n"}, "slstm": {"c", "n"}}``;
    - audio: ``{"layers": ..., "enc": (B, src_len, D)}``, the encoder
      output that cross-attention reads (set it with ``encode``).

    ``max_len`` is the KV capacity (window size for sliding-window
    configs); ``pos`` pre-fills the cache position. On a model group
    that splits whole heads the KV leaves hold this rank's KVH/M, the
    Mamba2 state its H/M heads and d_inner/M conv channels, the mLSTM
    state its H/M heads and the sLSTM state its D/M units."""
    _check_arch(cfg)
    device = _device.resolve(device)
    at = cfg.arch_type
    kv_len = min(max_len, cfg.sliding_window or max_len)

    kv_heads = attn.local_heads(cfg.n_heads, cfg.n_kv_heads)[1]

    def kv(n):
        return attn.init_cache(batch, kv_len, kv_heads, cfg.head_dim,
                               cfg.dtype, pos=pos, device=device,
                               lead=(n,))
    if at in ("dense", "vlm", "moe"):
        return {"layers": kv(cfg.n_layers)}
    if at == "hybrid":
        return {"ssm": ssm_mod.init_ssm_state(
                    batch, cfg.d_model, cfg.ssm_state,
                    expand=cfg.ssm_expand, conv_k=cfg.ssm_conv,
                    device=device, lead=(cfg.n_layers,)),
                "attn": kv(max(len(cfg.attn_positions), 1))}
    if at == "ssm":
        n_super = _n_super(cfg)
        return {"mlstm": xlstm_mod.init_mlstm_state(
                    batch, cfg.d_model, cfg.n_heads, device=device,
                    lead=(n_super * cfg.slstm_ratio,)),
                "slstm": xlstm_mod.init_slstm_state(
                    batch, cfg.d_model, device=device, lead=(n_super,))}
    return {"layers": kv(cfg.n_layers),
            "enc": torch.zeros(batch, src_len, cfg.d_model,
                               dtype=_dtype(cfg.dtype), device=device)}


def _attn_block_decode(p, x, cache, cfg: ModelConfig, *, window,
                       enc=None):
    h, cache = attn.attention_decode(
        p["attn"], rmsnorm(p["ln_attn"], x, cfg.norm_eps), cache,
        **_attn_kw(cfg, window))
    x = x + h
    if enc is not None:
        # cross-attention over the precomputed encoder output
        x = x + attn.attention_forward(
            p["cross"], rmsnorm(p["ln_cross"], x, cfg.norm_eps), kv=enc,
            causal=False, **_attn_kw(cfg, None))
    x = x + mlp(p["mlp"], rmsnorm(p["ln_mlp"], x, cfg.norm_eps), cfg.d_ff)
    return x, cache


def _moe_block_decode(p, x, cache, cfg: ModelConfig, *, window):
    """Decode's capacity factor E / top_k gives C = 1 at S = 1: every
    expert takes the token, so a step reads every expert's weights (the
    reference's semantics)."""
    h, cache = attn.attention_decode(
        p["attn"], rmsnorm(p["ln_attn"], x, cfg.norm_eps), cache,
        **_attn_kw(cfg, window))
    x = x + h
    y, _ = moe_mod.moe_expert_choice(
        p["moe"], rmsnorm(p["ln_mlp"], x, cfg.norm_eps),
        top_k=cfg.top_k, capacity_factor=float(cfg.n_experts) /
        max(cfg.top_k, 1), **_moe_widths(cfg))
    return x + y, cache


def decode_step(params, token, cache, cfg: ModelConfig, *,
                window: Optional[int] = None):
    """One decode step. token: (B,) int. Returns (logits (B, V_pad)
    float32, cache), the cache updated in place."""
    _check_arch(cfg)
    window = window if window is not None else cfg.sliding_window
    x = embed(params["embed"], token[:, None],
              cfg.padded_vocab()).to(_dtype(cfg.dtype))
    at = cfg.arch_type
    if at in ("dense", "vlm", "moe", "audio"):
        enc = cache["enc"] if at == "audio" else None
        for lp, lc in zip(_layers(params["blocks"]),
                          _layers(cache["layers"])):
            if at == "moe":
                x, _ = _moe_block_decode(lp, x, lc, cfg, window=window)
            else:
                x, _ = _attn_block_decode(lp, x, lc, cfg, window=window,
                                          enc=enc)
    elif at == "hybrid":
        blocks = _layers(params["blocks"])
        states = _layers(cache["ssm"])
        attn_caches = _layers(cache["attn"])
        for seg, (lo, hi, then_attn) in enumerate(_segments(cfg)):
            for lp, ls in zip(blocks[lo:hi], states[lo:hi]):
                y, _ = ssm_mod.ssm_decode(
                    lp["ssm"], rmsnorm(lp["ln"], x, cfg.norm_eps), ls,
                    d_state=cfg.ssm_state, expand=cfg.ssm_expand)
                x = x + y
            if then_attn:
                x, _ = _attn_block_decode(params["shared_attn"], x,
                                          attn_caches[seg], cfg,
                                          window=window)
    elif at == "ssm":
        r = cfg.slstm_ratio
        mblocks = _layers(params["mlstm_blocks"])
        mstates = _layers(cache["mlstm"])
        for s, (sp, ss) in enumerate(zip(_layers(params["slstm_blocks"]),
                                         _layers(cache["slstm"]))):
            for mp, ms in zip(mblocks[s * r:(s + 1) * r],
                              mstates[s * r:(s + 1) * r]):
                y, _ = xlstm_mod.mlstm_decode(
                    mp["mlstm"], rmsnorm(mp["ln"], x, cfg.norm_eps), ms,
                    n_heads=cfg.n_heads)
                x = x + y
                x = x + mlp(mp["mlp"], rmsnorm(mp["ln_mlp"], x,
                                               cfg.norm_eps),
                            2 * cfg.d_model)
            y, _ = xlstm_mod.slstm_decode(
                sp["slstm"], rmsnorm(sp["ln"], x, cfg.norm_eps), ss)
            x = x + y
            x = x + mlp(sp["mlp"], rmsnorm(sp["ln_mlp"], x, cfg.norm_eps),
                        2 * cfg.d_model)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _lm_head(params, x, cfg)[:, 0], cache
