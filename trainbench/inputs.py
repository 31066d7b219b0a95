"""What the benchmark makes from ``--seed`` and hands to both sides: the
global batch of each step and the starting parameters.

Tokens: a unigram draw with probability proportional to 1 / rank ** s
(s = the traffic's ``zipf_exponent``) over the real vocabulary, and a
copy motif, the first half of a sequence repeated in its second half, on
the first ``copy_share`` of the rows, so that the loss is learnable. The
draw of step t comes from ``numpy.random.default_rng((seed, t))``: every
seed gives the same sizes, and any whole seed works. The distribution is
that of the program's ``data.pipeline.SyntheticLM``, drawn here.

Parameters: one leaf at a time in the layout of the reference's
``param_shapes``, made on the device in float32 by a ``torch.Generator``
seeded from (seed, path), so that any leaf can be made again alone, each
as the reference's ``init_scale`` and ``init_uniform`` say (a constant
leaf is 1).
"""

from __future__ import annotations

import zlib
from typing import Dict

import numpy as np
import torch

from .reference import model as ref_model


class Tokens:
    def __init__(self, vocab: int, seq_len: int, seed: int, *,
                 zipf_exponent: float = 1.0, copy_share: float = 0.25):
        probs = np.arange(1, vocab + 1, dtype=np.float64) ** -zipf_exponent
        self.cdf = np.cumsum(probs / probs.sum())
        self.vocab, self.seq_len = vocab, seq_len
        self.seed = int(seed) % (1 << 64)
        self.copy_share = copy_share

    def batch(self, rows: int, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, int(step)))
        u = rng.random((rows, self.seq_len + 1))
        toks = np.minimum(np.searchsorted(self.cdf, u), self.vocab - 1)
        k = int(rows * self.copy_share)
        half = (self.seq_len + 1) // 2
        toks[:k, half:2 * half] = toks[:k, :half]
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


def tokens_for(config: dict, traffic: dict, seed: int) -> Tokens:
    t = traffic.get("tokens", {})
    return Tokens(config["model"]["vocab_size"], traffic["seq_len"], seed,
                  zipf_exponent=t.get("zipf_exponent", 1.0),
                  copy_share=t.get("copy_share", 0.25))


def leaf_seed(seed: int, path: str) -> int:
    return (int(seed) * 1_000_003 + zlib.crc32(path.encode())) % (1 << 63)


def make_leaf(path: str, shape, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, path))
    std = ref_model.init_scale(path, shape)
    if std is not None:
        return torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                           device=device).mul_(std)
    drawn = ref_model.init_uniform(path, torch.rand(
        tuple(shape), generator=gen, dtype=torch.float32, device=device))
    if drawn is not None:
        return drawn
    return torch.ones(tuple(shape), dtype=torch.float32, device=device)


def make_params(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{path: float32 leaf} on ``device``."""
    return {path: make_leaf(path, shape, seed, device)
            for path, shape in ref_model.param_shapes(model).items()}


def nest(flat: Dict[str, object]) -> dict:
    out: dict = {}
    for key, val in flat.items():
        node = out
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = val
    return out


def flat(tree, prefix: str = "") -> Dict[str, object]:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}
