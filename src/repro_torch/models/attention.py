"""Attention with GQA and RoPE: the full-sequence (training, prefill,
encoder) path as blockwise attention with memory linear in the sequence,
and the cached single-token decode path backed by the hand-written
decode-attention kernel.

Port of ``repro.models.attention``. ``blockwise_attention`` computes the
reference's online softmax over (query block x key block) tiles: scores
in float32 times ``Dh ** -0.5``; the causal mask ``k <= q`` and the
sliding window ``k > q - window`` built per tile from absolute positions
(the reference's ``_block_mask``), masked scores set to ``NEG_INF``
(-1e30, not -inf, so a row that a tile wholly masks adds exp(0) terms
that the row's next real maximum scales to zero, as in the reference); a
running maximum, sum and float32 accumulator; probabilities cast to the
input dtype before the value product; ``acc / max(l, 1e-30)`` at the
end. Its gradient is the flash-attention-2 backward (``_Blockwise``), so
training memory is linear in the sequence too. Tiles the mask wholly
hides are skipped, forward and backward (the reference computes them),
and the results are the same: under a causal mask they come after each
row's own key, so they would add exact zeros, and a window's come before
each row's first real key, whose maximum scales what they would add to
zero. ``tiles`` counts the tiles computed and skipped, a tile per call
of the forward and of the backward. ``attention_ref`` is the plain
version over the whole (Sq x Sk) scores, for tests and checks at lengths
where those fit. Self-attention applies RoPE to q and k; cross-attention
(``kv=``, the audio decoder over the encoder output) takes K and V from
the source with no RoPE and no mask.

``attention_decode`` writes the new K/V in place (the reference blends
a one-hot and returns a new cache) and returns the cache it was given.

On a model group of M ranks (``dist.tensor_parallel``) where M divides
both H and KVH, ``wq`` / ``wk`` / ``wv`` are column-parallel and ``wo``
row-parallel: a rank computes H/M query heads over KVH/M KV heads (the
group size G unchanged, its decode cache holding KVH/M heads) and one
all-reduce sums ``wo``'s partial products. The reference splits
features (``H*Dh``), not heads, so where M does not divide the heads a
split cuts a head (or ``wq`` splits while ``wk`` stays whole); the
split leaves are then gathered at use and every rank computes all
heads (as Mamba2 and the mLSTM do where M does not divide theirs).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.dist import tensor_parallel as tp
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.spans import span
from .layers import _dtype, apply_rope, init_linear, linear

NEG_INF = -1e30
tiles = {"computed": 0, "skipped": 0}


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
    causal, and k > q - window. The plain version's only."""
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


def attention_ref(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """The plain version of ``blockwise_attention``: one masked softmax
    over the whole (B, H, Sq, Sk) float32 scores, with K and V repeated
    over the query group. Memory quadratic in the sequence: for tests
    and checks at lengths where that fits, never the model's path."""
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


def _tile_mask(q0: int, q1: int, k0: int, k1: int, causal: bool,
               window: Optional[int], device):
    """The mask of the tile of queries [q0, q1) and keys [k0, k1): None
    when every pair is visible, False when none is, else the (tq, tk)
    boolean tile from absolute positions (the reference's
    ``_block_mask``). Decided from the positions alone, never from
    data."""
    if ((not causal or k1 - 1 <= q0)
            and (window is None or k0 > q1 - 1 - window)):
        return None
    if ((causal and k0 > q1 - 1)
            or (window is not None and k1 - 1 <= q0 - window)):
        return False
    qp = torch.arange(q0, q1, device=device)[:, None]
    kp = torch.arange(k0, k1, device=device)[None, :]
    mask = torch.ones(q1 - q0, k1 - k0, dtype=torch.bool, device=device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    return mask


def _live_blocks(q0: int, q1: int, sk: int, block_k: int, causal: bool,
                 window: Optional[int], device):
    """(k0, k1, tile mask) of each key block, in order, whose tile with
    the queries [q0, q1) the mask does not wholly hide; counts the tiles
    computed and skipped in ``tiles``."""
    for k0, k1 in _blocks(sk, block_k):
        mask = _tile_mask(q0, q1, k0, k1, causal, window, device)
        if mask is False:
            tiles["skipped"] += 1
            continue
        tiles["computed"] += 1
        yield k0, k1, mask


def _tile_scores(qt, kt, scale: float, mask, G: int):
    """float32 scores (B*KVH, G*tq, tk) of one tile, masked to NEG_INF."""
    s = torch.bmm(qt, kt.transpose(1, 2)).mul_(scale)
    if mask is not None:
        s.view(s.shape[0], G, -1, s.shape[2]).masked_fill_(~mask, NEG_INF)
    return s


def _grouped(x, KVH: int, G: int):
    """(B, S, KVH*G, Dh) -> float32 (B*KVH, G, S, Dh): the reference's
    (KVH, G) grouping of query heads (G = 1 for K and V)."""
    B, S, _, Dh = x.shape
    x = x.reshape(B, S, KVH, G, Dh).permute(0, 2, 3, 1, 4)
    return x.reshape(B * KVH, G, S, Dh).float()


def _blocks(n: int, block: int):
    block = min(block, n)
    return [(i, min(i + block, n)) for i in range(0, n, block)]


def _blockwise_forward(q, k, v, causal, window, block_q, block_k):
    """(out (B, Sq, H, Dh) in q.dtype, lse (B*KVH, G, Sq) float32)."""
    B, Sq, H, Dh = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    BK = B * KVH
    scale = Dh ** -0.5
    qf = _grouped(q, KVH, G)
    kf = _grouped(k, KVH, 1)[:, 0]                          # BK, Sk, Dh
    vf = _grouped(v, KVH, 1)[:, 0]
    out = torch.empty(B, Sq, KVH, G, Dh, dtype=q.dtype, device=q.device)
    lse = torch.empty(BK, G, Sq, dtype=torch.float32, device=q.device)
    for q0, q1 in _blocks(Sq, block_q):
        tq = q1 - q0
        qt = qf[:, :, q0:q1].reshape(BK, G * tq, Dh)
        m = torch.full((BK, G * tq, 1), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(BK, G * tq, Dh, dtype=torch.float32,
                          device=q.device)
        for k0, k1, mask in _live_blocks(q0, q1, Sk, block_k, causal,
                                         window, q.device):
            s = _tile_scores(qt, kf[:, k0:k1], scale, mask, G)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = s.sub_(m_new).exp_()
            corr = torch.exp(m - m_new)
            l = corr * l + p.sum(dim=-1, keepdim=True)
            acc = acc.mul_(corr).add_(torch.bmm(p.to(q.dtype).float(),
                                                vf[:, k0:k1]))
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)
        out[:, q0:q1] = o.view(B, KVH, G, tq, Dh).permute(0, 3, 1, 2, 4)
        lse[:, :, q0:q1] = (m + torch.log(torch.clamp(l, min=1e-30))
                            ).view(BK, G, tq)
    return out.view(B, Sq, H, Dh), lse


def _blockwise_backward(q, k, v, out, lse, d_out, causal, window,
                        block_q, block_k):
    """The flash-attention-2 backward in float32, tile by tile: P from
    the saved log-sum-exp, dV from P cast to the input dtype (as the
    forward's value product), dS = P * (dP - rowsum(dO * O))."""
    B, Sq, H, Dh = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    BK = B * KVH
    scale = Dh ** -0.5
    qf = _grouped(q, KVH, G)
    kf = _grouped(k, KVH, 1)[:, 0]
    vf = _grouped(v, KVH, 1)[:, 0]
    dof = _grouped(d_out, KVH, G)
    delta = (dof * _grouped(out, KVH, G)).sum(dim=-1)        # BK, G, Sq
    dq = torch.empty(B, Sq, KVH, G, Dh, dtype=torch.float32,
                     device=q.device)
    dk = torch.zeros(BK, Sk, Dh, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for q0, q1 in _blocks(Sq, block_q):
        tq = q1 - q0
        qt = qf[:, :, q0:q1].reshape(BK, G * tq, Dh)
        dot = dof[:, :, q0:q1].reshape(BK, G * tq, Dh)
        lse_t = lse[:, :, q0:q1].reshape(BK, G * tq, 1)
        delta_t = delta[:, :, q0:q1].reshape(BK, G * tq, 1)
        dq_t = torch.zeros_like(qt)
        for k0, k1, mask in _live_blocks(q0, q1, Sk, block_k, causal,
                                         window, q.device):
            kt, vt = kf[:, k0:k1], vf[:, k0:k1]
            s = _tile_scores(qt, kt, scale, mask, G)
            p = s.sub_(lse_t).exp_()
            dv[:, k0:k1] += torch.bmm(p.to(q.dtype).float().transpose(1, 2),
                                      dot)
            ds = torch.bmm(dot, vt.transpose(1, 2)).sub_(delta_t).mul_(p)
            dq_t += torch.bmm(ds, kt)
            dk[:, k0:k1] += torch.bmm(ds.transpose(1, 2), qt)
        dq[:, q0:q1] = (dq_t.mul_(scale).view(B, KVH, G, tq, Dh)
                        .permute(0, 3, 1, 2, 4))
    dk = dk.mul_(scale).view(B, KVH, Sk, Dh).permute(0, 2, 1, 3)
    dv = dv.view(B, KVH, Sk, Dh).permute(0, 2, 1, 3)
    return (dq.view(B, Sq, H, Dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _Blockwise(torch.autograd.Function):
    """Forward saves q, k, v, the output and the float32 log-sum-exp;
    backward recomputes each tile the forward computed. No
    data-dependent control flow (the tiles skipped follow from positions
    alone), so it runs on meta tensors (``launch.step_analysis``). Each
    runs in an ``attention`` span, the backward's marked as one."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, block_q, block_k):
        with span("attention"):
            out, lse = _blockwise_forward(q, k, v, causal, window, block_q,
                                          block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (causal, window, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        with span("attention", backward=True):
            dq, dk, dv = _blockwise_backward(q, k, v, out, lse, d_out,
                                             *ctx.cfg)
        return dq, dk, dv, None, None, None, None


def blockwise_attention(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, block_q: int = 512,
                        block_k: int = 512) -> torch.Tensor:
    """Online-softmax attention over (block_q x block_k) tiles, both
    block axes looped, the tiles a mask wholly hides skipped (the
    reference computes them; they add nothing). q: (B, Sq, H, Dh); k, v:
    (B, Sk, KVH, Dh), H % KVH == 0; query head h reads KV head
    h // (H // KVH), and K and V are not repeated over the group.
    Returns (B, Sq, H, Dh) in q.dtype.

    Memory is linear in the sequence: no (Sq, Sk) tensor or mask. A
    tile is (B*KVH, G*block_q, block_k) float32 -- 32 MiB at B = 1,
    H = 32, blocks of 512, whatever the length; at 32,768 tokens of
    granite-3-8b (H = 32, KVH = 8, Dh = 128) the largest tensors of a
    call are the float32 copies of q, k, v (0.54, 0.13, 0.13 GB) and the
    output, and the backward adds float32 dQ, dK, dV of the same sizes.
    """
    return _Blockwise.apply(q, k, v, causal, window, block_q, block_k)


def local_heads(n_heads: int, n_kv_heads: int):
    """(query heads, KV heads) a rank computes: H/M and KVH/M where a
    model group of M splits whole heads, else all of them."""
    M = tp.size()
    if M > 1 and n_heads % M == 0 and n_kv_heads % M == 0:
        return n_heads // M, n_kv_heads // M
    return n_heads, n_kv_heads


def _column(p, x, n_out: int):
    """Column-parallel ``x @ w`` on this rank's output block (its block
    of a whole bias)."""
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + tp.block_of(p["b"], n_out).to(x.dtype)
    return y


def _whole_rows(p, x, _n_out: int):
    """``x @ w`` where the rank holds (or has gathered) the whole leaf."""
    return linear(p, x)


def _parts(p, n_heads: int, n_kv_heads: int, head_dim: int):
    """(projections, heads run here, KV heads run here, per-rank
    heads?): the leaves as held where the heads are this rank's, else
    gathered at use."""
    Hl, KVl = local_heads(n_heads, n_kv_heads)
    if Hl != n_heads:
        return p, Hl, KVl, True
    hq, hkv = n_heads * head_dim, n_kv_heads * head_dim
    return ({"wq": tp.whole_linear(p["wq"], n_out=hq),
             "wk": tp.whole_linear(p["wk"], n_out=hkv),
             "wv": tp.whole_linear(p["wv"], n_out=hkv),
             "wo": tp.whole_linear(p["wo"], n_in=hq)},
            n_heads, n_kv_heads, False)


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
    p, H, KVH, mine = _parts(p, n_heads, n_kv_heads, head_dim)
    if mine:
        x = tp.copy_to(x)
        src = x if kv is None else tp.copy_to(kv)
        proj = _column
    else:
        src = x if kv is None else kv
        proj = _whole_rows
    Sk = src.shape[1]
    q = proj(p["wq"], x, n_heads * head_dim).reshape(B, S, H, head_dim)
    k = proj(p["wk"], src, n_kv_heads * head_dim).reshape(B, Sk, KVH,
                                                          head_dim)
    v = proj(p["wv"], src, n_kv_heads * head_dim).reshape(B, Sk, KVH,
                                                          head_dim)
    if kv is None:
        pos = torch.arange(S, device=x.device)[None, :].expand(B, S)
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    out = blockwise_attention(q, k, v, causal=causal and kv is None,
                              window=window)
    out = linear(p["wo"], out.reshape(B, S, H * head_dim))
    return tp.reduce_from(out) if mine else out


def attention_decode(p, x, cache, *, n_heads: int, n_kv_heads: int,
                     head_dim: int, rope_theta: float,
                     window: Optional[int] = None):
    """Single-token decode with KV cache, updated in place.

    x: (B, 1, D). cache: {"k","v": (B, S, KVH, Dh), "pos": (B,) int32}
    (KVH/M heads on a model group that splits whole heads).
    Writes the new K/V at position pos (mod the cache size for
    sliding-window caches; a write past a full-attention cache is
    dropped, as the reference's one-hot blend drops it), attends over
    the valid prefix and advances pos. Returns (out (B, 1, D), cache).
    """
    B = x.shape[0]
    k_cache, v_cache, pos = cache["k"], cache["v"], cache["pos"]
    S_cache = k_cache.shape[1]
    p, H, KVH, mine = _parts(p, n_heads, n_kv_heads, head_dim)
    proj = _column if mine else _whole_rows
    q = proj(p["wq"], x, n_heads * head_dim).reshape(B, 1, H, head_dim)
    k_new = proj(p["wk"], x, n_kv_heads * head_dim).reshape(B, KVH,
                                                            head_dim)
    v_new = proj(p["wv"], x, n_kv_heads * head_dim).reshape(B, KVH,
                                                            head_dim)
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
    out = linear(p["wo"], out.reshape(B, 1, H * head_dim))
    if mine:
        out = tp.reduce_from(out)
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
