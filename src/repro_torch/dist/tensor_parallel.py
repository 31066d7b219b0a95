"""Tensor parallelism over the model axis: ``safe_param_specs`` executed.

The reference places each parameter leaf by ``safe_param_specs`` on its
(data, model) mesh and leaves the collectives to GSPMD. The port states
its own. A rank at model coordinate ``r`` of ``M`` holds exactly its
block of every leaf whose placement names ``model`` (``shard_params``)
and the whole of every other leaf (the reference's divisibility
fallbacks), and computes the one-process function:

* ``copy_to`` / ``reduce_from`` are Megatron's "copy to" and "reduce
  from" the model group: identity forward with an all-reduce backward,
  and its mirror. A column-parallel linear (``wq``, ``wk``, ``wv``,
  ``wi_gate``, ``wi_up``, the expert stacks' ``w_gate`` / ``w_up``)
  takes ``copy_to(x)`` and yields this rank's output features; the
  row-parallel linear after it (``wo``, ``w_down``) sums its partial
  products with one ``reduce_from``. A whole leaf used on a rank's
  block (a column-parallel bias) goes through ``copy_to`` too, so its
  gradient is whole on every rank.
* ``reblock`` moves fixed sub-blocks of an activation's features
  between the ranks by one all-to-all (its gradient goes back by the
  inverse move): Mamba2's ``xz_proj`` yields a rank's two column blocks
  of ``[x | z]``, and the heads a rank runs need its block of x and of
  z. ``gather_act`` all-gathers an activation's features whose use on
  every rank is partial (Mamba2's B, C and dt when ``bcdt_proj``
  splits): its gradient is the reduce-scatter of the ranks' gradients.
* ``gather`` (``whole_linear``) is gather at use, for a split leaf
  whose split a module does not execute locally (attention and the
  mLSTM where the split cuts a head, Mamba2 where M does not divide its
  heads): the leaf is all-gathered over the model group where it is
  used, and its gradient is this rank's block of the whole gradient
  (the computation after the gather is replicated, so every rank holds
  the whole gradient). Placement and memory still follow the spec.
  Otherwise Mamba2, the mLSTM, the sLSTM and the MoE run a rank's heads,
  units or hidden block locally (``models/ssm.py``, ``models/xlstm.py``,
  ``models/moe.py``).
* ``vocab_parallel_nll`` is the loss over logits split by vocabulary:
  the log-sum-exp is a max and a sum over the model group, the label's
  logit a masked sum.

Modules read the model group from ``executing``, the port's form of the
reference's ``with mesh:``; with no group (or M = 1) every helper is the
identity and the model runs as it did. Which leaves a module splits is
decided, as in ``safe_param_specs``, by whether the whole dim divides M
(``splits``), from the whole sizes the module knows (heads, widths,
vocabulary), never from a local shape.

``ModelShards`` carries the placements of one parameter tree: the
shards, the whole tensors back (``gather_tree``, for checkpoints), the
global norm that counts a split leaf's shards once each, and the
compressed codecs' row scales reduced over the model group
(``row_across``), so a shard's payload is its block of the whole
row's.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core.compress import Across
from repro_torch.dist.sharding import safe_param_specs

_ACTIVE: List = [None]


@contextlib.contextmanager
def executing(model):
    """Run the model's modules on the model group ``model`` (a
    ``process_group.Workers`` with ``axis="model"``; None or size 1:
    one rank holds every leaf)."""
    prev = _ACTIVE[0]
    _ACTIVE[0] = model if model is not None and model.size > 1 else None
    try:
        yield
    finally:
        _ACTIVE[0] = prev


def group():
    return _ACTIVE[0]


def size() -> int:
    g = _ACTIVE[0]
    return 1 if g is None else g.size


def rank() -> int:
    g = _ACTIVE[0]
    return 0 if g is None else g.rank


def splits(whole: int) -> bool:
    """Whether a dim of ``whole`` entries is split over the model group
    (``safe_param_specs``'s divisibility rule)."""
    return size() > 1 and int(whole) % size() == 0


def local_size(whole: int) -> int:
    """This rank's share of a dim of ``whole`` entries: whole/M where the
    rule splits it, else all of it."""
    return int(whole) // size() if splits(whole) else int(whole)


def local_range(whole: int):
    """(lo, hi): this rank's block of a split dim of ``whole``."""
    per = int(whole) // size()
    return rank() * per, (rank() + 1) * per


# ---------------------------------------------------------------------------
# Collectives with their gradients
# ---------------------------------------------------------------------------


def _gather_dim(x: torch.Tensor, dim: int, g) -> torch.Tensor:
    dim = dim % x.ndim
    xm = torch.movedim(x, dim, 0).contiguous()
    out = torch.empty((g.size * xm.shape[0],) + tuple(xm.shape[1:]),
                      dtype=x.dtype, device=x.device)
    g.all_gather_(out, xm)
    return torch.movedim(out, 0, dim)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.g.all_reduce_(grad.contiguous().clone()), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        return g.all_reduce_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, g):
        ctx.dim, ctx.g = dim, g
        return _gather_dim(x, dim, g)

    @staticmethod
    def backward(ctx, grad):
        piece = grad.chunk(ctx.g.size, dim=ctx.dim)[ctx.g.rank]
        return piece.contiguous(), None, None


class _GatherAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _gather_dim(x, -1, g)

    @staticmethod
    def backward(ctx, grad):
        g = ctx.g
        gm = torch.movedim(grad, -1, 0).contiguous()
        out = gm.new_empty((gm.shape[0] // g.size,) + tuple(gm.shape[1:]))
        g.reduce_scatter_(out, gm)
        return torch.movedim(out, 0, -1), None


def _reblock(x: torch.Tensor, have, want, g) -> torch.Tensor:
    me = g.rank
    owner = {b: r for r, bs in enumerate(have) for b in bs}
    at = {b: i for i, b in enumerate(have[me])}
    send = [[b for b in want[q] if owner[b] == me] for q in range(g.size)]
    recv = [[b for b in want[me] if owner[b] == p] for p in range(g.size)]
    sub = x.shape[-1] // len(have[me])
    xs = torch.movedim(x.reshape(x.shape[:-1] + (len(have[me]), sub)),
                       -2, 0)
    inp = xs[[at[b] for q in send for b in q]].contiguous()
    out = inp.new_empty((len(want[me]),) + tuple(inp.shape[1:]))
    g.all_to_all_(out, inp, [len(r) for r in recv], [len(q) for q in send])
    got = [b for r in recv for b in r]
    out = out[[got.index(b) for b in want[me]]]
    return torch.movedim(out, 0, -2).reshape(
        x.shape[:-1] + (len(want[me]) * sub,))


class _Reblock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, have, want, g):
        ctx.have, ctx.want, ctx.g = have, want, g
        return _reblock(x, have, want, g)

    @staticmethod
    def backward(ctx, grad):
        return _reblock(grad, ctx.want, ctx.have, ctx.g), None, None, None


def copy_to(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over the model group."""
    g = _ACTIVE[0]
    if g is None or not torch.is_grad_enabled() or not x.requires_grad:
        return x
    return _Copy.apply(x, g)


def reduce_from(x: torch.Tensor) -> torch.Tensor:
    """SUM over the model group; the gradient passes as it is."""
    g = _ACTIVE[0]
    if g is None:
        return x
    if not torch.is_grad_enabled() or not x.requires_grad:
        return g.all_reduce_(x.contiguous().clone())
    return _Reduce.apply(x, g)


def gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole tensor of this rank's block along ``dim``; the
    gradient is this rank's block of the (replicated) whole gradient."""
    g = _ACTIVE[0]
    if g is None:
        return x
    if not torch.is_grad_enabled() or not x.requires_grad:
        return _gather_dim(x, dim, g)
    return _Gather.apply(x, dim, g)


def gather_act(x: torch.Tensor) -> torch.Tensor:
    """The whole features (last dim) of an activation of which this
    rank holds a block, each rank's use of the whole partial: the
    gradient is the reduce-scatter (SUM) of every rank's."""
    g = _ACTIVE[0]
    if g is None:
        return x
    if not torch.is_grad_enabled() or not x.requires_grad:
        return _gather_dim(x, -1, g)
    return _GatherAct.apply(x, g)


def reblock(x: torch.Tensor, have, want) -> torch.Tensor:
    """Move equal sub-blocks of ``x``'s last dim between the ranks by one
    all-to-all: rank r holds the sub-blocks ``have[r]`` (ids, in order,
    concatenated in ``x``) and gets ``want[r]``, in that order. Every
    id is held by one rank; the gradient takes the inverse move."""
    g = _ACTIVE[0]
    if g is None:
        return x
    have = tuple(tuple(h) for h in have)
    want = tuple(tuple(w) for w in want)
    if not torch.is_grad_enabled() or not x.requires_grad:
        return _reblock(x, have, want, g)
    return _Reblock.apply(x, have, want, g)


def whole_linear(p: dict, n_out: Optional[int] = None,
                 n_in: Optional[int] = None) -> dict:
    """Gather at use: a linear's ``{"w", "b"}`` with ``w`` whole, gathered
    along its output dim (``n_out`` entries, column-split leaves) or
    input dim (``n_in``, row-split leaves) where the rule splits it.
    Biases are whole."""
    w = p["w"]
    for dim, n in ((-1, n_out), (-2, n_in)):
        if n is not None and splits(n) and w.shape[dim] != n:
            w = gather(w, dim)
    return dict(p, w=w)


def block_of(b: torch.Tensor, n: int, dim: int = -1) -> torch.Tensor:
    """This rank's block of a whole leaf (a column-parallel bias), with
    its gradient whole on every rank."""
    lo, hi = local_range(n)
    return copy_to(b).narrow(dim, lo, hi - lo)


class _VocabNLL(torch.autograd.Function):
    """``logits[label] - logsumexp(logits)`` over vocab-split float32
    logits: the max and the two sums cross the model group."""

    @staticmethod
    def forward(ctx, logits, labels, lo, g):
        vl = logits.shape[-1]
        gmax = logits.amax(dim=-1)
        g.all_reduce_(gmax, op="max")
        e = torch.exp(logits - gmax[..., None])
        s = g.all_reduce_(e.sum(dim=-1))
        loc = labels - lo
        inr = (loc >= 0) & (loc < vl)
        locc = loc.clamp(0, vl - 1)
        picked = torch.where(inr, torch.gather(logits, -1,
                                               locc[..., None])[..., 0],
                             torch.zeros((), dtype=logits.dtype,
                                         device=logits.device))
        g.all_reduce_(picked)
        ctx.save_for_backward(e.div_(s[..., None]), locc, inr)
        return picked - (gmax + torch.log(s))

    @staticmethod
    def backward(ctx, grad):
        soft, locc, inr = ctx.saved_tensors
        d = -soft
        d.scatter_add_(-1, locc[..., None], inr[..., None].to(d.dtype))
        return d.mul_(grad[..., None]), None, None, None


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor,
                       vocab: int) -> torch.Tensor:
    """Per position ``logits[label] - logsumexp(logits)`` where
    ``logits`` (..., V/M) are this rank's block of a ``vocab``-wide
    vocabulary (labels already clamped to >= 0)."""
    lo, _ = local_range(vocab)
    return _VocabNLL.apply(logits, labels, lo, _ACTIVE[0])


# ---------------------------------------------------------------------------
# Parameter trees: shards and whole tensors
# ---------------------------------------------------------------------------


def model_dim(spec) -> int:
    """The dim a placement gives the model axis, or -1 (whole)."""
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        if "model" in axes:
            return d
    return -1


def _block(x, d: int, size: int, r: int, copy: bool = True):
    per = x.shape[d] // size
    if isinstance(x, np.ndarray):
        idx = [slice(None)] * x.ndim
        idx[d] = slice(r * per, (r + 1) * per)
        return np.ascontiguousarray(x[tuple(idx)])
    x = x.narrow(d, r * per, per)
    return x.clone(memory_format=torch.contiguous_format) if copy else x


def shard_params(tree, layout, model_rank: int, specs=None, *,
                 lead: int = 0, copy: bool = True):
    """Rank ``model_rank``'s shards of a whole tree (NumPy arrays or
    tensors) under ``specs`` (default ``safe_param_specs(tree, layout)``):
    a split leaf's block, a whole leaf as it is. ``lead`` leading axes
    (a residual's rows) come before the parameter's dims; a tensor's
    block is a contiguous copy, or a view of the whole tensor
    (``copy`` False)."""
    specs = safe_param_specs(tree, layout) if specs is None else specs
    msize = int(layout.shape.get("model", 1))

    def one(x, spec):
        d = model_dim(spec)
        return x if d < 0 else _block(x, d + lead, msize, model_rank, copy)
    return T.map(one, tree, specs)


def unshard_params(shards, specs):
    """The whole tree from every model rank's shards (a list in model
    order, as ``shard_params`` made them under ``specs``): the exact
    inverse of ``shard_params``."""
    def one(spec, *xs):
        d = model_dim(spec)
        if d < 0:
            return xs[0]
        if isinstance(xs[0], np.ndarray):
            return np.concatenate(xs, axis=d)
        return torch.cat(xs, dim=d)
    return T.map(one, specs, *shards)


class ModelShards:
    """The model-axis placements of one parameter tree on a rank's
    groups (``process_group.Workers`` with its ``.model``). ``shapes``
    are the whole leaves (tensors or meta tensors)."""

    def __init__(self, shapes, workers):
        self.workers = workers
        self.model = workers.model
        self.size = workers.model_size
        self.specs = safe_param_specs(shapes, workers.layout)
        self.dims = [model_dim(s) for s in T.leaves(self.specs)]
        self.widths = [int(np.prod(x.shape)) for x in T.leaves(shapes)]

    def shard(self, tree, lead: int = 0, copy: bool = True):
        """This rank's shards of a whole tree laid out like the
        parameters (``shard_params``)."""
        if self.size == 1:
            return tree
        return shard_params(tree, self.workers.layout, self.model.rank,
                            self.specs, lead=lead, copy=copy)

    def gather_tree(self, tree, lead: int = 0):
        """The whole tensors of a tree of this rank's shards (an
        all-gather over the model group per split leaf); ``lead`` leading
        axes (a residual's rows) come before the parameter's dims."""
        if self.size == 1:
            return tree
        out = [x if d < 0 else _gather_dim(x, d + lead, self.model)
               for x, d in zip(T.leaves(tree), self.dims)]
        return T.like(tree, out)

    def split_leaves(self) -> List[int]:
        return [i for i, d in enumerate(self.dims) if d >= 0]


def global_norm(grads, shards: Optional[ModelShards] = None, fsdp=None
                ) -> torch.Tensor:
    """The whole gradient's L2 norm from this rank's shards: a leaf split
    over the model axis (or, under FSDP, over the data axis) has its
    squared norm summed over that axis's ranks, a whole leaf counts once;
    leaves summed in ``optimizers.global_norm``'s order."""
    parts = [torch.sum(torch.square(g.float())) for g in T.leaves(grads)]
    for grp, idx in ((None if fsdp is None else fsdp.workers,
                      [] if fsdp is None else fsdp.split_leaves()),
                     (None if shards is None else shards.model,
                      [] if shards is None else shards.split_leaves())):
        if grp is None or not grp.distributed or not idx:
            continue
        vec = grp.all_reduce_(torch.stack([parts[i] for i in idx]))
        for i, s in zip(idx, vec.unbind()):
            parts[i] = s
    return torch.sqrt(sum(parts))


def row_across(model, width: int):
    """The ``core.compress.Across`` of a split leaf's rows ``width``
    wide, over the model group ``model``."""
    return Across(max=lambda x: model.all_reduce_(x, op="max"),
                  sum=model.all_reduce_, width=width)
