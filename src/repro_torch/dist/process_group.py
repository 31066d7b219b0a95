"""Process groups for the coded workers: the executed form of the
reference's mesh.

The reference lays its devices out as a ``jax`` mesh and lets
``shard_map`` / GSPMD move data across the mesh axes. Here a run of
``data x model`` processes is one ``torch.distributed`` world, laid out
row-major over the layout's axes (model fastest: rank ``d*M + mo``):

* ``init_workers`` takes the default group a caller has already formed
  (a test's ranks over a ``FileStore``), or forms it from the
  ``torchrun`` environment (``WORLD_SIZE``, ``RANK``,
  ``MASTER_ADDR``/``MASTER_PORT``). With neither there is no group:
  one process, and nothing crosses processes. The backend follows
  the device: ``nccl`` for ``cuda``, ``gloo`` for ``cpu``. Nothing falls
  back: a group that fails to form raises, and a rank that dies makes
  the next collective raise on the others.
* A rank gets its **data group** (the returned ``Workers``: the W ranks
  that share its model coordinate), over which the coded allreduces,
  the broadcast of w and FSDP run, and its **model group**
  (``Workers.model``: the M ranks that share its data coordinate), over
  which ``dist.tensor_parallel`` executes the model axis of
  ``safe_param_specs``. Each group counts its bytes in ``traffic``
  under its own keys (``all_reduce`` ... for the data group,
  ``model_all_reduce`` ... for the model group).
* ``model`` picks the layout ``(world / model, model)``;
  ``choose_model_size`` is the reference's pick (2 when the world is
  even and > 1). ``production=True`` takes the production layout
  (``launch.mesh.make_production_layout``: data=16 x model=16 = 256
  ranks) when the world has exactly that many ranks, and refuses any
  other world size with a ``ValueError``, as ``jax.make_mesh`` refuses
  too few devices.
* Each rank owns machines ``[r*m/W, (r+1)*m/W)`` of the coded batch's
  leading machine axis, r its data coordinate (the reference's block
  sharding of that axis): ``rank_rows`` is the executed form of
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
           "reduce_scatter": 0, "all_to_all": 0, "model_all_reduce": 0,
           "model_all_gather": 0, "model_reduce_scatter": 0,
           "model_all_to_all": 0}


def _count(kind: str, x: torch.Tensor) -> None:
    traffic[kind] += x.numel() * x.element_size()


@dataclasses.dataclass(frozen=True)
class Workers:
    """One axis of a run's ranks, seen from one rank: ``size`` ranks,
    this process is ``rank``; ``group`` is None when the size is 1.
    ``axis`` names the layout axis ("data" for the coded workers,
    "model" for tensor parallelism); a data group carries its rank's
    model group as ``model``."""

    size: int = 1
    rank: int = 0
    group: Optional[object] = None
    layout: Layout = make_test_layout((1, 1))
    axis: str = "data"
    model: Optional["Workers"] = None

    @property
    def distributed(self) -> bool:
        return self.size > 1

    @property
    def model_size(self) -> int:
        return 1 if self.model is None else self.model.size

    def _key(self, kind: str) -> str:
        return kind if self.axis == "data" else f"{self.axis}_{kind}"

    def all_reduce_(self, x: torch.Tensor, op: str = "sum"
                    ) -> torch.Tensor:
        """SUM (or ``op="max"``) over the ranks, in place (identity at
        size 1)."""
        if self.distributed:
            _count(self._key("all_reduce"), x)
            dist.all_reduce(x, op=(dist.ReduceOp.MAX if op == "max"
                                   else dist.ReduceOp.SUM),
                            group=self.group)
        return x

    def broadcast_(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``x`` on every rank, in place."""
        if self.distributed:
            _count(self._key("broadcast"), x)
            dist.broadcast(x, src=self._global(src), group=self.group)
        return x

    def _staged(self, x: torch.Tensor) -> bool:
        """gloo moves CUDA tensors through host memory anyway; its
        tensor-to-tensor gather and scatter are taken on host copies."""
        return x.is_cuda and dist.get_backend(self.group) == "gloo"

    def all_gather_(self, out: torch.Tensor, x: torch.Tensor
                    ) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``out``'s leading axis
        (``out`` holds size times ``x``'s leading dim)."""
        _count(self._key("all_gather"), x)
        if self._staged(x):
            host = out.new_empty(out.shape, device="cpu")
            dist.all_gather_into_tensor(host, x.cpu(), group=self.group)
            return out.copy_(host)
        dist.all_gather_into_tensor(out, x, group=self.group)
        return out

    def reduce_scatter_(self, out: torch.Tensor, x: torch.Tensor
                        ) -> torch.Tensor:
        """This rank's block of the SUM over ranks of ``x`` (split along
        its leading axis), into ``out``."""
        _count(self._key("reduce_scatter"), x)
        if self._staged(x):
            host = out.new_empty(out.shape, device="cpu")
            dist.reduce_scatter_tensor(host, x.cpu(), op=dist.ReduceOp.SUM,
                                       group=self.group)
            return out.copy_(host)
        dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM,
                                   group=self.group)
        return out

    def all_to_all_(self, out: torch.Tensor, x: torch.Tensor,
                    out_splits, in_splits) -> torch.Tensor:
        """``x``'s leading-axis pieces sent to the ranks in order
        (``in_splits[q]`` rows to rank q), and the pieces every rank sent
        here concatenated into ``out`` in rank order (``out_splits[p]``
        rows from rank p)."""
        _count(self._key("all_to_all"), x)
        if self._staged(x):
            host = out.new_empty(out.shape, device="cpu")
            dist.all_to_all_single(host, x.cpu(), out_splits, in_splits,
                                   group=self.group)
            return out.copy_(host)
        dist.all_to_all_single(out, x, out_splits, in_splits,
                               group=self.group)
        return out

    def _global(self, worker_rank: int) -> int:
        if self.group is None or self.group is dist.group.WORLD:
            return worker_rank
        return dist.get_global_rank(self.group, worker_rank)


SINGLE = Workers()


def device_of_rank(dev: torch.device) -> torch.device:
    """Under torchrun each rank takes the card ``LOCAL_RANK``."""
    if dev.type == "cuda" and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    return dev


def backend_for(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def choose_model_size(world: int) -> int:
    """The reference's model axis on ``world`` devices: 2 when the world
    is even and > 1, else 1 (``launch/train.py`` and ``launch/serve.py``
    of the reference build the mesh ``(world / model, model)``)."""
    return 2 if world > 1 and world % 2 == 0 else 1


def init_workers(device, *, production: bool = False,
                 model: Optional[int] = 1) -> Workers:
    """The data group of this process, with its model group as
    ``.model`` (see the module docstring).

    An already formed default group is used as it is (a caller that
    spawned the ranks itself, e.g. over a ``FileStore``); else the
    ``torchrun`` environment forms one with ``backend_for(device)``;
    with no ``WORLD_SIZE`` there the run is one process (``SINGLE``).
    ``model`` is the model axis's size (None: ``choose_model_size``);
    the layout is ``(world / model, model)``. ``production`` raises
    ``ValueError`` for every world size but the layout's."""
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
    if production:
        layout = make_production_layout()
        if world != layout.size:
            _refuse_production(world)
        return layout_workers(layout, me)
    msize = choose_model_size(world) if model is None else int(model)
    if msize < 1 or world % msize:
        raise ValueError(f"a model axis of {msize} does not divide the "
                         f"{world} ranks")
    if msize == 1:
        return Workers(size=world, rank=me, group=dist.group.WORLD,
                       layout=make_test_layout((world, 1)))
    return layout_workers(make_test_layout((world // msize, msize)), me)


def _refuse_production(world: int) -> None:
    layout = make_production_layout()
    raise ValueError(
        f"the production layout {dict(layout.shape)} needs "
        f"{layout.size} ranks; this run has {world}")


def layout_workers(layout: Layout, me: int) -> Workers:
    """Rank ``me``'s data and model groups on ``layout``: ranks in
    row-major order over the layout's axes (model fastest), so rank
    ``w*M + mo`` is worker ``w`` at model coordinate ``mo``. Every rank
    creates every group, in the same order, as ``dist.new_group``
    requires."""
    msize = layout.shape.get("model", 1)
    n_workers = layout.size // msize
    data_groups = [dist.new_group([w * msize + mo
                                   for w in range(n_workers)])
                   for mo in range(msize)]
    model_groups = [dist.new_group([w * msize + mo
                                    for mo in range(msize)])
                    for w in range(n_workers)]
    worker, mo = divmod(me, msize)
    model = Workers(size=msize, rank=mo, group=model_groups[worker],
                    layout=layout, axis="model")
    return Workers(size=n_workers, rank=worker, group=data_groups[mo],
                   layout=layout, model=model)


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
