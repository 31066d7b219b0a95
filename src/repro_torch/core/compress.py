"""Gradient compression codecs composed with the coded combine.

Port of the codecs of ``repro.core.compress``. Each machine's (or, on
the dedup path, each unique block's) flattened gradient row is
quantized to a payload and a per-row float32 scale; the decode-weighted
combine then runs on the payload directly
(``kernels.coded_combine``), so the float32 per-row gradients are never
rebuilt.

* ``none``  -- float32 passthrough, scale 1.
* ``int8``  -- symmetric round-half-to-even onto [-127, 127] with
  scale = amax * float32(1/127) (a multiply, not a divide, as in the
  reference; rows with amax = 0 keep scale 1 so q = 0 exactly). The
  divide by the runtime scale is a true divide.
* ``sign``  -- signSGD: payload sign(g) in an int8 container (0 at 0,
  and at -0.0), scale = mean|g|.
* ``sign_packed`` -- the same sign / mean|g| with 8 signs per uint8
  byte, little-endian (bit k of byte j is component 8j + k, bit 1 means
  +1), the trailing byte zero-padded. ``g >= 0`` gives the bit, so 0
  and -0.0 map to +1.

The int8 and packed payloads are bitwise the reference's on the same
float32 input; the sign scales (a mean) agree to summation order.
``Codec.compress_host`` / ``decompress_host`` are the NumPy route, the
reference's codecs called with ``xp=np`` copied expression for
expression, so their payloads and scales are bitwise the reference's.
``init_state`` is the error-feedback residual that rides beside the
optimizer state, and ``comm_bytes_per_step`` the bytes the machines
ship. ``compression_campaign`` is the error-vs-p-vs-bits grid of the
paper's harness (host NumPy through the NumPy route, bitwise the
reference's on the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree as T

from . import step_weights as sw
from .assignment import Assignment
from .sweep import bernoulli_uniforms

_INV127 = np.float32(1.0 / 127.0)


@dataclasses.dataclass(frozen=True)
class Across:
    """Rows held in blocks over ranks (a leaf split over the model
    axis): a row's scale is that of the whole row, so its block's
    reduction is finished over the ranks (``max`` and ``sum``, each an
    all-reduce) and a mean divides by the whole row's ``width``. The
    payload is then the codec's on the block."""

    max: Callable
    sum: Callable
    width: int


def _abs_max(g, across):
    amax = g.abs().amax(dim=-1)
    return amax if across is None else across.max(amax)


def _abs_mean(g, across):
    if across is None:
        return g.abs().mean(dim=-1)
    return across.sum(g.abs().sum(dim=-1)) / across.width


def _none_compress(g, across=None):
    g = g.float()
    return g, torch.ones(g.shape[:-1], dtype=torch.float32,
                         device=g.device)


def _q_decompress(q, scale):
    return q.float() * scale[..., None]


def _int8_compress(g, across=None):
    g = g.float()
    amax = _abs_max(g, across)
    inv = torch.tensor(_INV127, device=g.device)
    scale = torch.where(amax > 0, amax * inv, torch.ones_like(amax))
    q = torch.clamp(torch.round(g / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _sign_compress(g, across=None):
    g = g.float()
    return torch.sign(g).to(torch.int8), _abs_mean(g, across)


def packed_width(d: int) -> int:
    """Bytes needed to carry ``d`` sign bits (8 per byte, ceil)."""
    return (int(d) + 7) // 8


def pack_signs(bits: torch.Tensor) -> torch.Tensor:
    """(..., D) {0,1} -> (..., ceil(D/8)) uint8, little-endian bits;
    the trailing byte is zero-padded."""
    d = bits.shape[-1]
    bits = bits.to(torch.uint8)
    pad = (-d) % 8
    if pad:
        bits = torch.cat([bits, bits.new_zeros(bits.shape[:-1] + (pad,))],
                         dim=-1)
    grouped = bits.reshape(bits.shape[:-1] + (packed_width(d), 8))
    out = grouped[..., 0].clone()
    for k in range(1, 8):
        out |= grouped[..., k] << k
    return out


def unpack_signs(q: torch.Tensor, d: Optional[int] = None) -> torch.Tensor:
    """(..., B) uint8 -> (..., d) {0,1} uint8 (inverse of pack_signs)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=q.device)
    bits = (q[..., :, None] >> shifts) & 1
    bits = bits.reshape(q.shape[:-1] + (q.shape[-1] * 8,))
    return bits if d is None else bits[..., :d]


def _sign_packed_compress(g, across=None):
    g = g.float()
    return pack_signs(g >= 0), _abs_mean(g, across)


def _sign_packed_decompress(q, scale, d=None):
    signs = 2.0 * unpack_signs(q, d).float() - 1.0
    return signs * scale[..., None]


# The NumPy route: the reference's xp-generic codecs at xp=np.


def _np_none_compress(g):
    g = g.astype(np.float32)
    return g, np.ones(g.shape[:-1], np.float32)


def _np_int8_compress(g):
    g = g.astype(np.float32)
    amax = np.max(np.abs(g), axis=-1)
    scale = np.where(amax > 0, amax * _INV127,
                     np.ones_like(amax)).astype(np.float32)
    q = np.clip(np.round(g / scale[..., None]), -127, 127).astype(np.int8)
    return q, scale


def _np_sign_compress(g):
    g = g.astype(np.float32)
    scale = np.mean(np.abs(g), axis=-1).astype(np.float32)
    return np.sign(g).astype(np.int8), scale


def _np_q_decompress(q, scale):
    return q.astype(np.float32) * scale[..., None]


def pack_signs_np(bits: np.ndarray) -> np.ndarray:
    """NumPy ``pack_signs``: (..., D) {0,1} -> (..., ceil(D/8)) uint8."""
    d = bits.shape[-1]
    pad = (-d) % 8
    bits = bits.astype(np.uint8)
    if pad:
        bits = np.concatenate(
            [bits, np.zeros(bits.shape[:-1] + (pad,), np.uint8)], axis=-1)
    grouped = bits.reshape(bits.shape[:-1] + (packed_width(d), 8))
    weights = np.uint8(1) << np.arange(8, dtype=np.uint8)
    return (grouped * weights).sum(axis=-1).astype(np.uint8)


def unpack_signs_np(q: np.ndarray, d: Optional[int] = None) -> np.ndarray:
    """NumPy ``unpack_signs`` (inverse of ``pack_signs_np``)."""
    shifts = np.arange(8, dtype=np.uint8)
    bits = (q[..., :, None] >> shifts) & np.uint8(1)
    bits = bits.reshape(q.shape[:-1] + (q.shape[-1] * 8,))
    return bits if d is None else bits[..., :d]


def _np_sign_packed_compress(g):
    g = g.astype(np.float32)
    scale = np.mean(np.abs(g), axis=-1).astype(np.float32)
    return pack_signs_np(g >= 0), scale


def _np_sign_packed_decompress(q, scale, d=None):
    signs = 2.0 * unpack_signs_np(q, d).astype(np.float32) - 1.0
    return signs * scale[..., None]


@dataclasses.dataclass(frozen=True)
class Codec:
    """One compression scheme: rows of components -> (payload, scale).

    ``bits`` is the information per component (32 / 8 / 1) and
    ``wire_bits`` the container shipped (sign rides an int8 container,
    sign_packed pays its 1 bit), which ``comm_bytes_per_step`` counts.
    A ``packed`` codec's ``decompress`` takes the true component count
    ``d``, since the trailing byte is zero-padded. ``compress``'s
    ``across`` (``Across``) takes the scales over rows held in blocks.
    """

    name: str
    bits: int
    wire_bits: int
    _compress: Callable = dataclasses.field(repr=False, default=None)
    _decompress: Callable = dataclasses.field(repr=False, default=None)
    packed: bool = False
    _np_compress: Callable = dataclasses.field(repr=False, default=None)
    _np_decompress: Callable = dataclasses.field(repr=False, default=None)

    def compress(self, g, across: Optional[Across] = None):
        return self._compress(g, across)

    def decompress(self, q, scale, d=None):
        if self.packed:
            return self._decompress(q, scale, d)
        return self._decompress(q, scale)

    def compress_host(self, g: np.ndarray):
        """``compress`` on a NumPy array, through the NumPy route."""
        return self._np_compress(g)

    def decompress_host(self, q: np.ndarray, scale: np.ndarray, d=None):
        """``decompress`` of NumPy payloads, through the NumPy route."""
        if self.packed:
            return self._np_decompress(q, scale, d)
        return self._np_decompress(q, scale)


CODECS: Dict[str, Codec] = {
    "none": Codec("none", bits=32, wire_bits=32,
                  _compress=_none_compress, _decompress=_q_decompress,
                  _np_compress=_np_none_compress,
                  _np_decompress=_np_q_decompress),
    "int8": Codec("int8", bits=8, wire_bits=8,
                  _compress=_int8_compress, _decompress=_q_decompress,
                  _np_compress=_np_int8_compress,
                  _np_decompress=_np_q_decompress),
    "sign": Codec("sign", bits=1, wire_bits=8,
                  _compress=_sign_compress, _decompress=_q_decompress,
                  _np_compress=_np_sign_compress,
                  _np_decompress=_np_q_decompress),
    "sign_packed": Codec("sign_packed", bits=1, wire_bits=1,
                         _compress=_sign_packed_compress,
                         _decompress=_sign_packed_decompress, packed=True,
                         _np_compress=_np_sign_packed_compress,
                         _np_decompress=_np_sign_packed_decompress),
}


def get_codec(name) -> Codec:
    if isinstance(name, Codec):
        return name
    try:
        return CODECS[name]
    except KeyError:
        raise ValueError(f"unknown codec {name!r} "
                         f"(one of {sorted(CODECS)})") from None


def init_state(params, rows: int):
    """The error-feedback state: one float32 residual per (row,
    parameter), zero-initialised, leaves (rows,) + param.shape. ``rows``
    is m on the replicated paths and n on the dedup path."""
    if rows < 1:
        raise ValueError("rows must be >= 1")
    return {"residual": T.map(
        lambda p: torch.zeros((rows,) + tuple(p.shape),
                              dtype=torch.float32, device=p.device),
        params)}


def comm_bytes_per_step(codec: Optional[Codec], rows: int, params) -> int:
    """Bytes the rows ship per step: float32 gradients for ``None``,
    else ``wire_bits`` per component rounded up to whole bytes per leaf,
    plus one float32 scale per (row, leaf)."""
    leaves = T.leaves(params)
    if codec is None:
        total = sum(int(np.prod(leaf.shape)) for leaf in leaves)
        return rows * total * 4
    payload = sum(-(-int(np.prod(leaf.shape)) * codec.wire_bits // 8)
                  for leaf in leaves)
    return rows * (payload + len(leaves) * 4)


# ---------------------------------------------------------------------------
# Error-vs-p-vs-bits campaign
# ---------------------------------------------------------------------------


def compression_campaign(assignment: Assignment,
                         p_grid: Sequence[float], *,
                         codecs: Sequence[str] = ("none", "sign", "int8"),
                         trials: int = 200, dim: int = 512,
                         seed: int = 0, method: str = "optimal",
                         debias: bool = True,
                         majority_vote: bool = True,
                         device=None) -> List[Dict]:
    """The error-vs-p-vs-bits grid: decoding error composed with
    quantization noise, on one shared straggler draw.

    One ``bernoulli_uniforms`` draw for the whole grid, one fixed
    synthetic gradient tableau G (n, dim) with target ``sum_i G_i``,
    machine messages ``g = A^T G``, and per codec the precomputed
    round trip ``dequant(quant(g))`` through the NumPy route, so the
    (codec, p) cells differ only in the decode weights and the codec.

    Rows: {codec, bits, p, decoding, mean_error, std_error}, the
    relative error ``|W_t qhat - target|^2 / |target|^2`` per trial.
    ``majority_vote=True`` appends per p majority-vote signSGD (unit
    weights over the alive machines, L1 target scale). ``device`` is
    where the debias scale's batched decode may run (``None`` means the
    card, reached only at >= 200,000 mask entries).
    """
    p_list = [float(p) for p in p_grid]
    u = bernoulli_uniforms(assignment.m, trials, seed)
    rng = np.random.default_rng(seed + 1)
    G = rng.normal(size=(assignment.n, dim)) / np.sqrt(dim)
    target = G.sum(axis=0)
    tnorm = float((target ** 2).sum())
    g = (assignment.A.T @ G).astype(np.float32)        # (m, dim)

    deq = {}
    for cname in codecs:
        codec = get_codec(cname)
        q, s = codec.compress_host(g)
        deq[cname] = np.asarray(
            codec.decompress_host(q, s, d=g.shape[-1]), np.float64)
    mv_scale = float(np.abs(target).sum()) / dim
    sgn = np.sign(g).astype(np.float64)

    rows: List[Dict] = []
    for p in p_list:
        alive = u >= p
        scale = 1.0
        if debias and method == "optimal":
            scale = sw.debias_scale_mc(assignment, p=p, trials=trials,
                                       seed=seed + 0x5EED, device=device)
        W, _ = sw.batched_step_weights(assignment, alive, method=method,
                                       p=p, scale=scale)
        for cname in codecs:
            est = W @ deq[cname]                       # (trials, dim)
            errs = ((est - target) ** 2).sum(axis=1) / tnorm
            rows.append({"codec": cname, "bits": get_codec(cname).bits,
                         "p": p, "decoding": method,
                         "mean_error": float(errs.mean()),
                         "std_error": float(errs.std())})
        if majority_vote:
            est = mv_scale * np.sign(alive.astype(np.float64) @ sgn)
            errs = ((est - target) ** 2).sum(axis=1) / tnorm
            rows.append({"codec": "sign", "bits": 1, "p": p,
                         "decoding": "majority_vote",
                         "mean_error": float(errs.mean()),
                         "std_error": float(errs.std())})
    return rows
