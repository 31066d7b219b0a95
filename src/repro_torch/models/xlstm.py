"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

Port of ``repro.models.xlstm``, with its deviations from the xLSTM paper
carried as they are: the mLSTM in its chunked-parallel form (a
decay-gated linear attention with a per-head P x P state, the same
chunking as the SSD block) with log-sigmoid forget and sigmoid input
gates; the sLSTM with per-unit scalar cells c, n, diagonal gating and no
hidden-to-hidden matrix, so that its recurrence is linear.

The reference runs the sLSTM recurrence as ``jax.lax.associative_scan``;
torch has none, so ``linear_scan`` is a log-depth doubling scan
(Hillis-Steele) over the sequence: the same sums, added in another
order. The mLSTM's masked decay is exp of the masked log-decay
differences, as in ``ssm.masked_decay``. Decode states are float32 and
updated in place.

On a model group of M ranks the blocks run a rank's share locally where
M divides it. The mLSTM, where M divides its heads, runs H/M heads:
``wq`` / ``wk`` / ``wv`` column-parallel, the rank's input and forget
gate columns of the whole ``w_gates`` through ``copy_to``, the per-head
normaliser local, ``wo`` row-parallel with one all-reduce; its state
holds the rank's heads. The sLSTM, where M divides d_model (``wo``
splits), runs D/M units: their z, i, f and o columns of the whole
``w_in`` through ``copy_to`` (so each step all-reduces w_in's whole
D x 4D gradient), the scan on D/M units, ``wo`` row-parallel; its state
holds the rank's units. Otherwise the split leaves are gathered at use
(a split that cuts an mLSTM head) and every rank runs all heads.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist import tensor_parallel as tp
from .layers import init_linear, linear
from .ssm import _pad_seq, masked_decay


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(gen: torch.Generator, d_model: int, n_heads: int,
               dtype: str = "float32", lead=()):
    def lin(d_out):
        return init_linear(gen, d_model, d_out, dtype=dtype, lead=lead)
    return {"wq": lin(d_model), "wk": lin(d_model), "wv": lin(d_model),
            "w_gates": lin(2 * n_heads), "wo": lin(d_model)}


def _whole_mlstm(p, d: int):
    if tp.size() == 1:
        return p
    return dict(p, **{k: tp.whole_linear(p[k], n_out=d)
                      for k in ("wq", "wk", "wv")},
                wo=tp.whole_linear(p["wo"], n_in=d))


def _mlstm_parts(p, u, n_heads: int):
    """(p, u, gates, local): the mLSTM's leaves and input as this rank
    uses them, its heads' (i | f) gate pre-activations (float32), and
    whether it runs H/M heads (``wo`` then needs ``tp.reduce_from``)."""
    if not tp.splits(n_heads):
        p = _whole_mlstm(p, u.shape[-1])
        return p, u, linear(p["w_gates"], u).float(), False
    lo, hi = tp.local_range(n_heads)
    u = tp.copy_to(u)
    w = tp.copy_to(p["w_gates"]["w"]).unflatten(-1, (2, n_heads))
    gates = u @ w[..., lo:hi].flatten(-2).to(u.dtype)
    return p, u, gates.float(), True


def _slstm_parts(p, u):
    """(zifo, local): this rank's units' z | i | f | o pre-activations
    (float32), and whether it runs D/M units (``wo`` then needs
    ``tp.reduce_from``)."""
    D = u.shape[-1]
    if not tp.splits(D):
        return linear(p["w_in"], u).float(), False
    lo, hi = tp.local_range(D)
    w = tp.copy_to(p["w_in"]["w"]).unflatten(-1, (4, D))
    zifo = tp.copy_to(u) @ w[..., lo:hi].flatten(-2).to(u.dtype)
    return zifo.float(), True


def _out(p, y, local: bool):
    y = linear(p["wo"], y)
    return tp.reduce_from(y) if local else y


def mlstm_forward(p, u, *, n_heads: int, chunk: int = 256) -> torch.Tensor:
    """u: (B, S, D) -> (B, S, D). Chunked decay-gated linear attention."""
    B, S, D = u.shape
    P = D // n_heads
    p, u, gates, local = _mlstm_parts(p, u, n_heads)
    H = gates.shape[-1] // 2
    q = linear(p["wq"], u).reshape(B, S, H, P)
    k = linear(p["wk"], u).reshape(B, S, H, P) * (P ** -0.5)
    v = linear(p["wv"], u).reshape(B, S, H, P)
    i_gate = torch.sigmoid(gates[..., :H])                      # (B,S,H)
    log_f = F.logsigmoid(gates[..., H:])                        # <= 0

    Q = min(chunk, S)
    pad = (-S) % Q
    q, k, v, i_gate, log_f = (_pad_seq(t, pad)
                              for t in (q, k, v, i_gate, log_f))
    Sp = q.shape[1]
    nc = Sp // Q

    qc = q.reshape(B, nc, Q, H, P).float()
    kc = k.reshape(B, nc, Q, H, P).float()
    vc = v.reshape(B, nc, Q, H, P).float()
    ic = i_gate.reshape(B, nc, Q, H)
    lfc = log_f.reshape(B, nc, Q, H)

    cum = torch.cumsum(lfc, dim=2)
    total = cum[:, :, -1, :]

    # intra-chunk
    decay = masked_decay(cum)                                   # (B,nc,Q,Q,H)
    qk = torch.einsum("bcihp,bcjhp->bcijh", qc, kc)
    scores = qk * decay * ic[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, vc)

    # chunk states: C (B,nc,H,P,P), n (B,nc,H,P)
    w_end = torch.exp(total[:, :, None, :] - cum) * ic          # (B,nc,Q,H)
    stateC = torch.einsum("bcjh,bcjhp,bcjhr->bchpr", w_end, kc, vc)
    stateN = torch.einsum("bcjh,bcjhp->bchp", w_end, kc)
    Cp = torch.zeros(B, H, P, P, dtype=torch.float32, device=u.device)
    Np = torch.zeros(B, H, P, dtype=torch.float32, device=u.device)
    C_in, N_in = [], []                         # states entering chunk c
    for c in range(nc):
        C_in.append(Cp)
        N_in.append(Np)
        dec = torch.exp(total[:, c])
        Cp = dec[..., None, None] * Cp + stateC[:, c]
        Np = dec[..., None] * Np + stateN[:, c]
    C_in = torch.stack(C_in, dim=1)
    N_in = torch.stack(N_in, dim=1)

    dec_i = torch.exp(cum)                                      # (B,nc,Q,H)
    y_inter = torch.einsum("bcihp,bcih,bchpr->bcihr", qc, dec_i, C_in)
    n_inter = torch.einsum("bcihp,bcih,bchp->bcih", qc, dec_i, N_in)

    # intra normaliser: q_i . (sum_j decay i_j k_j) == scores summed over j
    qn_intra = scores.sum(dim=3)                                # (B,nc,Q,H)
    denom = torch.clamp(torch.abs(qn_intra + n_inter), min=1.0)[..., None]
    y = (y_intra + y_inter) / denom
    y = y.reshape(B, Sp, H * P)[:, :S].to(u.dtype)
    return _out(p, y, local)


def mlstm_decode(p, u, state, *, n_heads: int) -> Tuple[torch.Tensor, dict]:
    """u: (B, 1, D); state = {"C": (B, H, P, P), "n": (B, H, P)} float32
    (the rank's heads where it runs H/M), updated in place and
    returned."""
    B, _, D = u.shape
    P = D // n_heads
    p, u, gates, local = _mlstm_parts(p, u, n_heads)
    gates = gates[:, 0]
    H = gates.shape[-1] // 2
    q = linear(p["wq"], u).reshape(B, H, P).float()
    k = (linear(p["wk"], u).reshape(B, H, P) * (P ** -0.5)).float()
    v = linear(p["wv"], u).reshape(B, H, P).float()
    i_g = torch.sigmoid(gates[..., :H])
    f_g = torch.sigmoid(gates[..., H:])
    C = f_g[..., None, None] * state["C"] + i_g[..., None, None] * \
        torch.einsum("bhp,bhr->bhpr", k, v)
    n = f_g[..., None] * state["n"] + i_g[..., None] * k
    num = torch.einsum("bhp,bhpr->bhr", q, C)
    den = torch.clamp(torch.abs(torch.einsum("bhp,bhp->bh", q, n)), min=1.0)
    y = (num / den[..., None]).reshape(B, 1, H * P).to(u.dtype)
    state["C"].copy_(C)
    state["n"].copy_(n)
    return _out(p, y, local), state


def init_mlstm_state(batch: int, d_model: int, n_heads: int, *, device,
                     lead=()):
    """The state of the heads this rank runs."""
    P = d_model // n_heads
    H = tp.local_size(n_heads)
    return {"C": torch.zeros(*lead, batch, H, P, P,
                             dtype=torch.float32, device=device),
            "n": torch.zeros(*lead, batch, H, P, dtype=torch.float32,
                             device=device)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(gen: torch.Generator, d_model: int, dtype: str = "float32",
               lead=()):
    return {
        # z, i, f, o per hidden unit
        "w_in": init_linear(gen, d_model, 4 * d_model, dtype=dtype,
                            lead=lead),
        "wo": init_linear(gen, d_model, d_model, dtype=dtype, lead=lead),
    }


def linear_scan(f: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """h_t = f_t h_{t-1} + x_t from h_0 = 0, along dim 1, for every t:
    a doubling scan of ceil(log2 S) rounds. After the round of offset d,
    (a_t, h_t) holds the product of f and the sum over the last 2d
    steps; out of place, so autograd follows it."""
    S = f.shape[1]
    a, h = f, x
    d = 1
    while d < S:
        h = torch.cat([h[:, :d], h[:, d:] + a[:, d:] * h[:, :-d]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return h


def slstm_forward(p, u) -> torch.Tensor:
    """u: (B, S, D) -> (B, S, D). The diagonal cell as a linear scan."""
    zifo, local = _slstm_parts(p, u)
    z, i, f, o = zifo.chunk(4, dim=-1)
    z = torch.tanh(z)
    i = torch.sigmoid(i)
    f = torch.sigmoid(f)
    o = torch.sigmoid(o)
    # c_t = f c + i z and n_t = f n + i share the decay f: one scan
    cn = linear_scan(torch.cat([f, f], dim=-1), torch.cat([i * z, i], -1))
    c, n = cn.chunk(2, dim=-1)
    h = o * c / torch.clamp(n, min=1e-6)
    return _out(p, h.to(u.dtype), local)


def slstm_decode(p, u, state) -> Tuple[torch.Tensor, dict]:
    """state = {"c": (B, D), "n": (B, D)} float32 (the rank's D/M units
    where it runs them), updated in place and returned."""
    zifo, local = _slstm_parts(p, u)
    zifo = zifo[:, 0]
    z, i, f, o = zifo.chunk(4, dim=-1)
    z = torch.tanh(z)
    i = torch.sigmoid(i)
    f = torch.sigmoid(f)
    o = torch.sigmoid(o)
    c = f * state["c"] + i * z
    n = f * state["n"] + i
    h = (o * c / torch.clamp(n, min=1e-6))[:, None].to(u.dtype)
    state["c"].copy_(c)
    state["n"].copy_(n)
    return _out(p, h, local), state


def init_slstm_state(batch: int, d_model: int, *, device, lead=()):
    """The state of the units this rank runs."""
    d = tp.local_size(d_model)
    return {"c": torch.zeros(*lead, batch, d, dtype=torch.float32,
                             device=device),
            "n": torch.zeros(*lead, batch, d, dtype=torch.float32,
                             device=device)}
