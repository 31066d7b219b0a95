"""Carry the reference's parameters into the port.

``params_from_numpy`` takes the JAX package's parameter tree as nested
dicts of NumPy arrays (``jax.tree.map(np.asarray, params)``), or the
path of an ``.npz`` written by ``repro.checkpoint.save`` (flat arrays
plus a ``.json`` sidecar holding their "/"-joined key paths), and
returns the port's tree: same key paths, same stacked-layer layout,
same dtypes, on ``device``.
"""

from __future__ import annotations

import json
import os
from typing import Union

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig
from .model import _check_arch


def param_shapes(cfg: ModelConfig) -> dict:
    """"/"-joined key path -> shape of the dense reference tree."""
    L, D, V = cfg.n_layers, cfg.d_model, cfg.padded_vocab()
    H, KVH, Dh, F = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    shapes = {"embed/table": (V, D), "final_norm/scale": (D,),
              "blocks/ln_attn/scale": (L, D), "blocks/ln_mlp/scale": (L, D),
              "blocks/attn/wq/w": (L, D, H * Dh),
              "blocks/attn/wk/w": (L, D, KVH * Dh),
              "blocks/attn/wv/w": (L, D, KVH * Dh),
              "blocks/attn/wo/w": (L, H * Dh, D),
              "blocks/mlp/wi_gate/w": (L, D, F),
              "blocks/mlp/wi_up/w": (L, D, F),
              "blocks/mlp/wo/w": (L, F, D)}
    if cfg.qkv_bias:
        shapes.update({"blocks/attn/wq/b": (L, H * Dh),
                       "blocks/attn/wk/b": (L, KVH * Dh),
                       "blocks/attn/wv/b": (L, KVH * Dh)})
    if not cfg.tie_embeddings:
        shapes["lm_head/w"] = (D, V)
    return shapes


def read_npz(path: Union[str, os.PathLike]) -> dict:
    """An ``.npz`` of ``repro.checkpoint.save`` -> {key path: array}."""
    path = os.fspath(path)
    with open(os.path.splitext(path)[0] + ".json") as f:
        keys = json.load(f)["keys"]
    with np.load(path) as z:
        return {key: z[f"a{i}"] for i, key in enumerate(keys)}


def params_from_numpy(tree, cfg: ModelConfig, device=None) -> dict:
    """Reference parameters (nested NumPy dicts or an ``.npz`` path) ->
    the port's parameter tree on ``device`` (default: the GPU). Raises
    on a missing, unexpected or mis-shaped leaf."""
    _check_arch(cfg)
    device = _device.resolve(device)
    flat = (read_npz(tree) if isinstance(tree, (str, os.PathLike))
            else dict(zip(*T.flatten(tree))))
    want = param_shapes(cfg)
    if set(flat) != set(want):
        raise ValueError(
            f"parameter keys differ from {cfg.name}'s dense tree: missing "
            f"{sorted(set(want) - set(flat))}, unexpected "
            f"{sorted(set(flat) - set(want))}")
    out = {}
    for key, arr in flat.items():
        arr = np.asarray(arr)
        if arr.shape != want[key]:
            raise ValueError(f"{key}: shape {arr.shape}, want {want[key]}")
        out[key] = torch.tensor(arr, device=device)
    return T.unflatten(out)
