"""Placement arithmetic: parameter, optimizer-state and cache placements
on a layout, and the bytes each device holds under them.

Port of the metadata half of ``repro.dist.sharding``. A layout
(``launch.mesh.Layout``, or anything with ``axis_names`` and a
``shape`` mapping) carries up to three axes -- ``pod`` and ``data``
(the coded gradient workers) and ``model`` (tensor parallelism). The
functions work on shape trees: nested dicts whose leaves have ``shape``
and ``dtype`` (meta tensors, or any tensor). A placement is, per leaf,
a tuple with one entry per split dim -- an axis name, a tuple of axis
names, or None -- the reference's ``PartitionSpec`` as a plain tuple
(``()`` replicates).

Every rule passes through a divisibility check: a dim that does not
divide the axis size falls back to replication, so the same rules hold
on the 2x16x16 production layout, the (data, model) single pod and a
one-device test layout. Nothing here places a tensor:
``dist.process_group.rank_rows`` executes ``leading_axis_specs``,
``dist.tensor_parallel`` the model axis of ``safe_param_specs``,
``dist.fsdp`` the data axis of ``fsdp_specs``, and ``serve.cache_pool``
``cache_specs``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch import tree as T

Placement = Tuple


def data_axes(layout) -> Tuple[str, ...]:
    """The axes the coded workers (and the batch's machine axis) are
    split over: ("pod", "data") on multi-pod layouts, ("data",)
    otherwise."""
    return ("pod", "data") if "pod" in layout.axis_names else ("data",)


def _worker_count(layout) -> int:
    n = 1
    for a in data_axes(layout):
        n *= int(layout.shape[a])
    return n


def _model_size(layout) -> int:
    return int(layout.shape.get("model", 1))


def _sharded_dim(path: Tuple[str, ...], shape: Tuple[int, ...]) -> int:
    """Which dim of this param leaf the model axis splits, or -1.

    Patterns match the last two path keys (param dicts nest as
    ``.../<layer-name>/<w|b|scale|table>``); stacked blocks carry a
    leading layer axis, which the negative dim indices skip naturally.
    """
    parent = path[-2] if len(path) >= 2 else ""
    leaf = path[-1]
    if leaf == "table":                      # embedding (V, D): split vocab
        return 0 if len(shape) == 2 else -1
    if parent == "lm_head" and leaf == "w":  # (D, V): split vocab
        return len(shape) - 1
    if len(shape) < 2:
        return -1                            # biases / norms / scalars
    # MoE expert stacks are raw (E, d_in, d_out) tensors
    if leaf in ("w_gate", "w_up"):
        return len(shape) - 1
    if leaf == "w_down":
        return len(shape) - 2
    if leaf != "w":
        return -1
    # Column-parallel projections: split the output features.
    if parent in ("wq", "wk", "wv", "wi_gate", "wi_up", "xz_proj",
                  "bcdt_proj"):
        return len(shape) - 1
    # Row-parallel projections: split the input features.
    if parent in ("wo", "out_proj"):
        return len(shape) - 2
    return -1


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


def safe_param_specs(params, layout):
    """Placement tree for a parameter tree: path-pattern tensor
    parallelism over ``model`` with a divisibility fallback to
    replication."""
    msize = _model_size(layout)

    def spec_for(path, leaf) -> Placement:
        shape = tuple(leaf.shape)
        dim = _sharded_dim(path, shape)
        if dim < 0 or msize <= 1 or shape[dim] % msize:
            return ()                        # fallback: replicate
        axes = [None] * len(shape)
        axes[dim] = "model"
        return tuple(axes)

    return _map_with_path(spec_for, params)


def fsdp_specs(params, layout):
    """FSDP-style placements: on top of ``safe_param_specs``, each leaf
    gives one more dim to the worker axes -- the largest dim not taken
    by the model axis whose size divides the worker count. Leaves with
    no such dim keep their ``safe_param_specs`` placement. AdamW's
    moments follow the same placements."""
    base = safe_param_specs(params, layout)
    da = data_axes(layout)
    da1 = da if len(da) > 1 else da[0]
    n_workers = _worker_count(layout)
    if n_workers <= 1:
        return base

    def upgrade(leaf, spec: Placement) -> Placement:
        shape = tuple(leaf.shape)
        axes = list(spec) + [None] * (len(shape) - len(spec))
        best = -1
        for dim, size in enumerate(shape):
            if axes[dim] is not None or size % n_workers:
                continue
            if best < 0 or size > shape[best]:
                best = dim
        if best < 0:
            return spec
        axes[best] = da1
        return tuple(axes)

    return T.map(upgrade, params, base)


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype, device="meta").element_size()
    return torch.empty((), dtype=getattr(torch, str(dtype)),
                       device="meta").element_size()


def bytes_per_device(shapes, specs, layout) -> int:
    """Per-device bytes of a tree under its placements: each leaf's
    bytes divided (rounding up: a padded shard counts whole) by the
    product of the axis sizes its placement names, summed."""
    total = 0
    for leaf, spec in zip(T.leaves(shapes), T.leaves(specs)):
        shards = 1
        for entry in spec:
            if entry is None:
                continue
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                shards *= int(layout.shape[a])
        nbytes = math.prod(leaf.shape) * _itemsize(leaf.dtype)
        total += -(-nbytes // shards)
    return int(total)


def cache_batch_dim(keys: Tuple[str, ...]) -> int:
    """Which dim of a decode-cache leaf is the batch (request-slot)
    axis: per-layer stacked leaves carry a leading layer axis, so batch
    is dim 1; the unstacked encoder output ("enc") has batch leading.
    The serving cache pool resets slots along the same dim."""
    return 0 if (keys and keys[0] == "enc") else 1


def cache_specs(cache, layout, *, batch_replicated: bool = False):
    """Decode-cache placements: the batch dim over the data axes,
    replicated when the batch is smaller than the worker count
    (``batch_replicated``) or does not divide it."""
    da = data_axes(layout)
    n_data = _worker_count(layout)
    da1 = da if len(da) > 1 else da[0]

    def spec_for(path, leaf) -> Placement:
        shape = tuple(leaf.shape)
        batch_dim = cache_batch_dim(path)
        if (batch_replicated or len(shape) <= batch_dim
                or n_data <= 1 or shape[batch_dim] % n_data):
            return ()
        axes = [None] * len(shape)
        axes[batch_dim] = da1
        return tuple(axes)

    return _map_with_path(spec_for, cache)


def leading_axis_specs(batch, layout):
    """A batch's placements: every leaf's leading (machine or request)
    axis over the worker axes, the rest replicated."""
    da = data_axes(layout)
    da1 = da if len(da) > 1 else da[0]
    return T.map(lambda v: (da1,) + (None,) * (len(v.shape) - 1), batch)
