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


def _attn_shapes(pre: str, lead: tuple, cfg: ModelConfig,
                 bias: bool) -> dict:
    D, H, KVH, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = {f"{pre}/wq/w": lead + (D, H * Dh),
           f"{pre}/wk/w": lead + (D, KVH * Dh),
           f"{pre}/wv/w": lead + (D, KVH * Dh),
           f"{pre}/wo/w": lead + (H * Dh, D)}
    if bias:
        out.update({f"{pre}/wq/b": lead + (H * Dh,),
                    f"{pre}/wk/b": lead + (KVH * Dh,),
                    f"{pre}/wv/b": lead + (KVH * Dh,)})
    return out


def _mlp_shapes(pre: str, lead: tuple, d: int, f: int) -> dict:
    return {f"{pre}/wi_gate/w": lead + (d, f), f"{pre}/wi_up/w": lead + (d, f),
            f"{pre}/wo/w": lead + (f, d)}


def _norms(pre: str, lead: tuple, d: int, *names) -> dict:
    return {f"{pre}/{n}/scale": lead + (d,) for n in names}


def _attn_block_shapes(pre: str, lead: tuple, cfg: ModelConfig, *,
                       cross: bool = False) -> dict:
    D = cfg.d_model
    out = {**_norms(pre, lead, D, "ln_attn", "ln_mlp"),
           **_attn_shapes(f"{pre}/attn", lead, cfg, cfg.qkv_bias),
           **_mlp_shapes(f"{pre}/mlp", lead, D, cfg.d_ff)}
    if cross:
        out.update(_norms(pre, lead, D, "ln_cross"))
        out.update(_attn_shapes(f"{pre}/cross", lead, cfg, False))
    return out


def _moe_block_shapes(lead: tuple, cfg: ModelConfig) -> dict:
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    out = {**_norms("blocks", lead, D, "ln_attn", "ln_mlp"),
           **_attn_shapes("blocks/attn", lead, cfg, cfg.qkv_bias),
           "blocks/moe/router/w": lead + (D, E),
           "blocks/moe/w_gate": lead + (E, D, Fe),
           "blocks/moe/w_up": lead + (E, D, Fe),
           "blocks/moe/w_down": lead + (E, Fe, D)}
    if cfg.n_shared_experts:
        out.update(_mlp_shapes("blocks/moe/shared", lead, D,
                               Fe * cfg.n_shared_experts))
    return out


def _ssm_block_shapes(lead: tuple, cfg: ModelConfig, head_p: int = 64
                      ) -> dict:
    D, N = cfg.d_model, cfg.ssm_state
    d_inner = cfg.ssm_expand * D
    H = d_inner // head_p
    return {**_norms("blocks", lead, D, "ln"),
            "blocks/ssm/xz_proj/w": lead + (D, 2 * d_inner),
            "blocks/ssm/bcdt_proj/w": lead + (D, 2 * N + H),
            "blocks/ssm/conv_w": lead + (cfg.ssm_conv, d_inner),
            "blocks/ssm/A_log": lead + (H,),
            "blocks/ssm/dt_bias": lead + (H,),
            "blocks/ssm/D": lead + (H,),
            "blocks/ssm/out_proj/w": lead + (d_inner, D)}


def _xlstm_shapes(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    n_super = cfg.n_layers // (cfg.slstm_ratio + 1)
    m, s = (n_super * cfg.slstm_ratio,), (n_super,)
    out = {**_norms("mlstm_blocks", m, D, "ln", "ln_mlp"),
           **_mlp_shapes("mlstm_blocks/mlp", m, D, 2 * D),
           **_norms("slstm_blocks", s, D, "ln", "ln_mlp"),
           **_mlp_shapes("slstm_blocks/mlp", s, D, 2 * D),
           "slstm_blocks/slstm/w_in/w": s + (D, 4 * D),
           "slstm_blocks/slstm/wo/w": s + (D, D)}
    for name, d_out in (("wq", D), ("wk", D), ("wv", D),
                        ("w_gates", 2 * cfg.n_heads), ("wo", D)):
        out[f"mlstm_blocks/mlstm/{name}/w"] = m + (D, d_out)
    return out


def param_shapes(cfg: ModelConfig) -> dict:
    """"/"-joined key path -> shape of the reference's parameter tree
    for ``cfg``'s family."""
    _check_arch(cfg)
    D, V, L = cfg.d_model, cfg.padded_vocab(), (cfg.n_layers,)
    shapes = {"embed/table": (V, D), "final_norm/scale": (D,)}
    if not cfg.tie_embeddings:
        shapes["lm_head/w"] = (D, V)
    at = cfg.arch_type
    if at in ("dense", "vlm"):
        shapes.update(_attn_block_shapes("blocks", L, cfg))
    elif at == "moe":
        shapes.update(_moe_block_shapes(L, cfg))
    elif at == "hybrid":
        shapes.update(_ssm_block_shapes(L, cfg))
        shapes.update(_attn_block_shapes("shared_attn", (), cfg))
    elif at == "ssm":
        shapes.update(_xlstm_shapes(cfg))
    else:   # audio
        shapes.update(_attn_block_shapes("encoder",
                                         (cfg.n_encoder_layers,), cfg))
        shapes["enc_norm/scale"] = (D,)
        shapes.update(_attn_block_shapes("blocks", L, cfg, cross=True))
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
    device = _device.resolve(device)
    flat = (read_npz(tree) if isinstance(tree, (str, os.PathLike))
            else dict(zip(*T.flatten(tree))))
    want = param_shapes(cfg)
    if set(flat) != set(want):
        raise ValueError(
            f"parameter keys differ from {cfg.name}'s tree: missing "
            f"{sorted(set(want) - set(flat))}, unexpected "
            f"{sorted(set(flat) - set(want))}")
    out = {}
    for key, arr in flat.items():
        arr = np.asarray(arr)
        if arr.shape != want[key]:
            raise ValueError(f"{key}: shape {arr.shape}, want {want[key]}")
        out[key] = torch.tensor(arr, device=device)
    return T.unflatten(out)
