"""FSDP over the worker group: ``fsdp_specs`` executed.

``dist.sharding.fsdp_specs`` places each parameter leaf (and AdamW's
``m`` and ``v`` with it) on the run's (data, model) layout: on top of
``safe_param_specs``, the largest dim not taken by the model axis whose
size divides W is split over the worker ranks, and a leaf with no such
dim keeps its model placement. The model entry is executed by
``dist.tensor_parallel`` (a rank holds its model block of a split
leaf); ``FSDP`` carries the data entries, on those model blocks, and
does what GSPMD does for the reference under ``--fsdp``:

* ``shard`` keeps rank r's block of the split dim of every leaf;
* ``gather`` all-gathers the whole leaves for the forward (freed after
  the backward);
* ``reduce`` reduce-scatters (SUM) the gradients to this rank's shards
  -- a whole leaf is all-reduced -- so AdamW, which is elementwise,
  updates the shards as they are;
* ``global_norm`` is the norm of the whole gradient: the squared norms
  of the split leaves' shards are summed across the ranks.

Per rank the resident parameter bytes are ``bytes_per_device(shapes,
fsdp_specs(shapes, layout), layout)``. At W = 1 every leaf keeps its
model placement and every method is the identity, so an FSDP step is
the step without FSDP bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch import tree as T
from repro_torch.dist import tensor_parallel
from repro_torch.dist.sharding import fsdp_specs


def _split_dim(spec, axis: str = "data") -> int:
    """The dim a placement gives ``axis`` ("data": the worker axes, with
    "pod"; "model": tensor parallelism), or -1 (whole along it)."""
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        if axis in axes:
            return d
    return -1


class FSDP:
    """The placements of one parameter tree on the worker group
    (``process_group.Workers``); ``params`` are the whole tensors or
    their shapes (meta tensors). The methods take and return trees of
    model blocks (the whole leaves at model = 1)."""

    def __init__(self, params, workers):
        self.workers = workers
        self.specs = fsdp_specs(params, workers.layout)
        self._dims = [_split_dim(s) for s in T.leaves(self.specs)]
        msize = workers.model_size
        self._shapes = []
        for p, spec in zip(T.leaves(params), T.leaves(self.specs)):
            shape = list(p.shape)
            md = _split_dim(spec, "model")
            if md >= 0:
                shape[md] //= msize
            self._shapes.append(tuple(shape))

    def split_leaves(self):
        return [i for i, d in enumerate(self._dims) if d >= 0]

    def _each(self, fn, tree):
        out = [fn(x, d, shape) for x, d, shape in
               zip(T.leaves(tree), self._dims, self._shapes)]
        return T.like(tree, out)

    def shard(self, tree):
        """This rank's shards of a whole tree laid out like the
        parameters (the parameters, or AdamW's ``m`` / ``v``); a copy,
        so the whole tensors can be freed."""
        size, rank = self.workers.size, self.workers.rank

        def one(x, d, _):
            if d < 0:
                return x
            return x.chunk(size, dim=d)[rank].clone(
                memory_format=torch.contiguous_format)
        return self._each(one, tree)

    def gather(self, tree):
        """The whole tensors of a sharded tree, on every rank."""
        size = self.workers.size

        def one(x, d, shape):
            if d < 0:
                return x
            buf = torch.empty((size * x.shape[0],) + tuple(x.shape[1:]),
                              dtype=x.dtype, device=x.device)
            self.workers.all_gather_(buf, x.contiguous())
            buf = buf.reshape((size,) + tuple(x.shape))
            return torch.movedim(buf, 0, d).reshape(shape)
        return self._each(one, tree)

    def reduce(self, grads, *, summed: bool = False):
        """Whole partial gradients -> this rank's shards of their sum
        over the ranks (reduce-scatter; a whole leaf is all-reduced).
        ``summed`` says every rank already holds the sum: then each
        keeps its block and nothing crosses ranks."""
        size, rank = self.workers.size, self.workers.rank

        def one(g, d, _):
            if d < 0:
                if not summed:
                    self.workers.all_reduce_(g)
                return g
            if summed or size == 1:
                return g.chunk(size, dim=d)[rank].clone(
                    memory_format=torch.contiguous_format)
            x = torch.movedim(g, d, 0).contiguous()
            out = torch.empty((x.shape[0] // size,) + tuple(x.shape[1:]),
                              dtype=x.dtype, device=x.device)
            self.workers.reduce_scatter_(out, x)
            return torch.movedim(out, 0, d).contiguous()
        return self._each(one, grads)

    def global_norm(self, grads) -> torch.Tensor:
        """The whole gradient's L2 norm from this rank's shards, summed
        over leaves in ``optimizers.global_norm``'s order."""
        return tensor_parallel.global_norm(grads, fsdp=self)

    def opt_shard(self, opt_state):
        """AdamW's state with ``m`` and ``v`` sharded like the
        parameters (the step counter stays whole)."""
        return {k: (self.shard(v) if k in ("m", "v") else v)
                for k, v in opt_state.items()}

    def opt_gather(self, opt_state):
        return {k: (self.gather(v) if k in ("m", "v") else v)
                for k, v in opt_state.items()}


def resident_bytes(tree) -> int:
    """The bytes this rank holds of a tree (of shards or whole leaves)."""
    return int(sum(x.numel() * x.element_size() for x in T.leaves(tree)))
