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
``init_state`` is the error-feedback residual that rides beside the
optimizer state, and ``comm_bytes_per_step`` the bytes the machines
ship. The reference's ``compression_campaign`` belongs to the paper's
harness and is not ported here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import tree as T

_INV127 = np.float32(1.0 / 127.0)


def _none_compress(g):
    g = g.float()
    return g, torch.ones(g.shape[:-1], dtype=torch.float32,
                         device=g.device)


def _q_decompress(q, scale):
    return q.float() * scale[..., None]


def _int8_compress(g):
    g = g.float()
    amax = g.abs().amax(dim=-1)
    inv = torch.tensor(_INV127, device=g.device)
    scale = torch.where(amax > 0, amax * inv, torch.ones_like(amax))
    q = torch.clamp(torch.round(g / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _sign_compress(g):
    g = g.float()
    scale = g.abs().mean(dim=-1)
    return torch.sign(g).to(torch.int8), scale


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


def _sign_packed_compress(g):
    g = g.float()
    scale = g.abs().mean(dim=-1)
    return pack_signs(g >= 0), scale


def _sign_packed_decompress(q, scale, d=None):
    signs = 2.0 * unpack_signs(q, d).float() - 1.0
    return signs * scale[..., None]


@dataclasses.dataclass(frozen=True)
class Codec:
    """One compression scheme: rows of components -> (payload, scale).

    ``bits`` is the information per component (32 / 8 / 1) and
    ``wire_bits`` the container shipped (sign rides an int8 container,
    sign_packed pays its 1 bit), which ``comm_bytes_per_step`` counts.
    A ``packed`` codec's ``decompress`` takes the true component count
    ``d``, since the trailing byte is zero-padded.
    """

    name: str
    bits: int
    wire_bits: int
    _compress: Callable = dataclasses.field(repr=False, default=None)
    _decompress: Callable = dataclasses.field(repr=False, default=None)
    packed: bool = False

    def compress(self, g):
        return self._compress(g)

    def decompress(self, q, scale, d=None):
        if self.packed:
            return self._decompress(q, scale, d)
        return self._decompress(q, scale)


CODECS: Dict[str, Codec] = {
    "none": Codec("none", bits=32, wire_bits=32,
                  _compress=_none_compress, _decompress=_q_decompress),
    "int8": Codec("int8", bits=8, wire_bits=8,
                  _compress=_int8_compress, _decompress=_q_decompress),
    "sign": Codec("sign", bits=1, wire_bits=8,
                  _compress=_sign_compress, _decompress=_q_decompress),
    "sign_packed": Codec("sign_packed", bits=1, wire_bits=1,
                         _compress=_sign_packed_compress,
                         _decompress=_sign_packed_decompress, packed=True),
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
