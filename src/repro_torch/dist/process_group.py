"""Process groups for the coded workers: the executed form of the
reference's mesh.

The reference lays its devices out as a ``jax`` mesh and lets
``shard_map`` / GSPMD move data across the worker axes. Here a run of W
processes is one ``torch.distributed`` group, and each process is one
worker rank:

* ``init_workers`` takes the default group a caller has already formed
  (a test's ranks over a ``FileStore``), or forms it from the
  ``torchrun`` environment (``WORLD_SIZE``, ``RANK``,
  ``MASTER_ADDR``/``MASTER_PORT``). With neither there is no group:
  W = 1, and nothing crosses processes. The backend follows
  the device: ``nccl`` for ``cuda``, ``gloo`` for ``cpu``. Nothing falls
  back: a group that fails to form raises, and a rank that dies makes
  the next collective raise on the others.
* The layout is ``Layout(data=W, model=1)``. The model axis (tensor
  parallelism) is not executed: every rank holds whole parameter leaves
  (or their FSDP shards over the worker axis, ``dist.fsdp``).
  ``production=True`` builds the worker groups of the production layout
  (``launch.mesh.make_production_layout``: data=16 x model=16 = 256
  ranks) when the world has exactly that many ranks, and refuses any
  other world size with a ``ValueError``, as ``jax.make_mesh`` refuses
  too few devices. A rank's worker group is then the 16 ranks that
  share its model coordinate; with the model axis unexecuted, the 16
  worker groups run the same computation.
* Each rank owns machines ``[r*m/W, (r+1)*m/W)`` of the coded batch's
  leading machine axis (the reference's block sharding of that axis):
  ``rank_rows`` is the executed form of
  ``dist.sharding.leading_axis_specs``. The dedup path's block axis
  falls back to every rank holding all blocks when n is not a multiple
  of W (``block_rows_split``), as the reference's ``block_shardings``
  falls back to replication.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import tree as T
from repro_torch.launch.mesh import (Layout, make_production_layout,
                                     make_test_layout)


# Bytes this process handed each collective, by kind: the training CLI and
# chip_smoke.py read them as the per-rank traffic of a step.
traffic = {"all_reduce": 0, "broadcast": 0, "all_gather": 0,
           "reduce_scatter": 0}


def _count(kind: str, x: torch.Tensor) -> None:
    traffic[kind] += x.numel() * x.element_size()


@dataclasses.dataclass(frozen=True)
class Workers:
    """The coded workers of a run, seen from one rank: ``size`` ranks
    (W), this process is ``rank``; ``group`` is None when W = 1."""

    size: int = 1
    rank: int = 0
    group: Optional[object] = None
    layout: Layout = make_test_layout((1, 1))

    @property
    def distributed(self) -> bool:
        return self.size > 1

    def all_reduce_(self, x: torch.Tensor) -> torch.Tensor:
        """SUM over the worker ranks, in place (identity at W = 1)."""
        if self.distributed:
            _count("all_reduce", x)
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x

    def broadcast_(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``x`` on every rank, in place."""
        if self.distributed:
            _count("broadcast", x)
            dist.broadcast(x, src=self._global(src), group=self.group)
        return x

    def all_gather_(self, out: torch.Tensor, x: torch.Tensor
                    ) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``out``'s leading axis
        (``out`` holds W times ``x``'s leading dim)."""
        _count("all_gather", x)
        dist.all_gather_into_tensor(out, x, group=self.group)
        return out

    def reduce_scatter_(self, out: torch.Tensor, x: torch.Tensor
                        ) -> torch.Tensor:
        """This rank's block of the SUM over ranks of ``x`` (split along
        its leading axis), into ``out``."""
        _count("reduce_scatter", x)
        dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM,
                                   group=self.group)
        return out

    def _global(self, worker_rank: int) -> int:
        if self.group is None or self.group is dist.group.WORLD:
            return worker_rank
        return dist.get_global_rank(self.group, worker_rank)


SINGLE = Workers()


def backend_for(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_workers(device, *, production: bool = False) -> Workers:
    """The worker group of this process (see the module docstring).

    An already formed default group is used as it is (a caller that
    spawned the ranks itself, e.g. over a ``FileStore``); else the
    ``torchrun`` environment forms one with ``backend_for(device)``;
    with no ``WORLD_SIZE`` there the run is one process (``SINGLE``).
    ``production`` raises ``ValueError`` for every world size but the
    layout's."""
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            if production:
                _refuse_production(1)
            return SINGLE
        kw = dict(backend=backend_for(device))
        dev = torch.device(device)
        if dev.type == "cuda":
            kw["device_id"] = (dev if dev.index is not None else
                               torch.device("cuda",
                                            torch.cuda.current_device()))
        dist.init_process_group(**kw)
    world, me = dist.get_world_size(), dist.get_rank()
    if not production:
        return Workers(size=world, rank=me, group=dist.group.WORLD,
                       layout=make_test_layout((world, 1)))
    layout = make_production_layout()
    if world != layout.size:
        _refuse_production(world)
    return _production_workers(layout, me)


def _refuse_production(world: int) -> None:
    layout = make_production_layout()
    raise ValueError(
        f"the production layout {dict(layout.shape)} needs "
        f"{layout.size} ranks; this run has {world}")


def _production_workers(layout: Layout, me: int) -> Workers:
    """Ranks in row-major order over the layout's axes (model fastest).
    Every rank creates every worker group, in the same order, as
    ``dist.new_group`` requires."""
    msize = layout.shape["model"]
    n_workers = layout.size // msize
    data_groups = [dist.new_group([w * msize + mo
                                   for w in range(n_workers)])
                   for mo in range(msize)]
    worker, mo = divmod(me, msize)
    return Workers(size=n_workers, rank=worker, group=data_groups[mo],
                   layout=layout)


def row_block(n: int, size: int, rank: int) -> slice:
    """Rank ``rank``'s block ``[r*n/W, (r+1)*n/W)`` of n rows."""
    if n % size:
        raise ValueError(f"{n} rows do not split over {size} ranks")
    per = n // size
    return slice(rank * per, (rank + 1) * per)


def rank_rows(tree, size: int, rank: int):
    """Every leaf's leading-axis block of rank ``rank`` of ``size`` (a
    view): the executed form of ``leading_axis_specs``."""
    return T.map(lambda x: x[row_block(x.shape[0], size, rank)], tree)


def gather_rows(tree, workers):
    """The whole leading axis of a tree whose leaves hold this rank's
    row block (the inverse of ``rank_rows``): an all-gather per leaf."""
    if not workers.distributed:
        return tree

    def one(x):
        out = torch.empty((workers.size * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        return workers.all_gather_(out, x.contiguous())
    return T.map(one, tree)


def block_rows_split(n: int, size: int) -> bool:
    """Whether the dedup path's n unique blocks split over W ranks;
    otherwise every rank keeps all of them (the reference's
    ``block_shardings`` divisibility fallback)."""
    return size > 1 and n % size == 0
