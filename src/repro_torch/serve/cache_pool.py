"""Fixed-slot device cache pool: per-request state paging.

The pool is one ``models.model.init_decode_cache`` tree with
``n_slots`` as its batch dimension. A request "page" is one batch row
across every leaf; admission zeroes that row in place, so slots are
reused without allocation or a host round trip. The slot axis is dim 1
of the per-layer stacked leaves (dim 0 of an unstacked encoder output
"enc"), the rule of ``dist.sharding.cache_batch_dim``.

Over a worker group (``workers``, a ``process_group.Workers``) the pool
is placed as the reference's ``cache_specs`` places it: the slot axis is
split over the data ranks (rank r holds slots ``[r*n/W, (r+1)*n/W)``)
and stays whole where the slots do not divide W, and on its model
group the KV heads are the rank's ``wk`` / ``wv`` shard and the
recurrent states hold the heads or units the rank runs.
"""

from __future__ import annotations

import torch

from repro_torch.dist import process_group as pg
from repro_torch.dist import tensor_parallel as tp
from repro_torch.dist.sharding import cache_batch_dim
from repro_torch.models import model as M


def _leaves(tree, keys=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, keys + (k,))
    else:
        yield keys, tree


class CachePool:
    """n_slots request pages over one ``init_decode_cache`` tree."""

    def __init__(self, cfg, n_slots: int, max_len: int, *, device,
                 workers=None):
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.rows = slot_rows(n_slots, workers)
        with tp.executing(None if workers is None else workers.model):
            self.cache = M.init_decode_cache(
                cfg, self.rows.stop - self.rows.start, max_len,
                device=device)

    def reset_slots(self, mask) -> None:
        """Zero the slots where ``mask`` (n_slots,) bool is True (this
        rank's block of them)."""
        mask = mask[self.rows]
        for keys, leaf in _leaves(self.cache):
            bd = cache_batch_dim(keys)
            shape = [1] * leaf.ndim
            shape[bd] = leaf.shape[bd]
            m = torch.as_tensor(mask, dtype=torch.bool,
                                device=leaf.device).reshape(shape)
            leaf.masked_fill_(m, 0)


def slot_rows(n_slots: int, workers=None) -> slice:
    """This rank's slots: its block of the slot axis on the data ranks
    (``cache_specs``), or all of them where they do not divide W."""
    if workers is None or not workers.distributed or n_slots % workers.size:
        return slice(0, n_slots)
    return pg.row_block(n_slots, workers.size, workers.rank)
