"""Fixed-slot device cache pool: per-request state paging.

The pool is one ``models.model.init_decode_cache`` tree with
``n_slots`` as its batch dimension. A request "page" is one batch row
across every leaf; admission zeroes that row in place, so slots are
reused without allocation or a host round trip. The slot axis is dim 1
of the per-layer stacked leaves (dim 0 of an unstacked encoder output
"enc"), the rule of the reference's ``dist.sharding.cache_batch_dim``.
"""

from __future__ import annotations

import torch

from repro_torch.models import model as M


def cache_batch_dim(keys) -> int:
    """Which dim of a decode-cache leaf is the request-slot axis."""
    return 0 if (keys and keys[0] == "enc") else 1


def _leaves(tree, keys=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, keys + (k,))
    else:
        yield keys, tree


class CachePool:
    """n_slots request pages over one ``init_decode_cache`` tree."""

    def __init__(self, cfg, n_slots: int, max_len: int, *, device):
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.cache = M.init_decode_cache(cfg, n_slots, max_len,
                                         device=device)

    def reset_slots(self, mask) -> None:
        """Zero the slots where ``mask`` (n_slots,) bool is True."""
        for keys, leaf in _leaves(self.cache):
            bd = cache_batch_dim(keys)
            shape = [1] * leaf.ndim
            shape[bd] = leaf.shape[bd]
            m = torch.as_tensor(mask, dtype=torch.bool,
                                device=leaf.device).reshape(shape)
            leaf.masked_fill_(m, 0)
