"""The ``hybrid`` reference family: Zamba2 (arXiv:2411.15242) in the
port's layout, a stack of Mamba2 mixers (``model.mamba2``), each a
pre-norm residual layer, with one shared attention + SwiGLU block applied
after the layers listed in ``attn_positions``; a final RMSNorm and the
tied (or untied) head. Each layer and each insertion of the shared block
runs under ``torch.utils.checkpoint``.

FLOPs beside ``model``'s: the shared block's matmuls count once for each
insertion; Mamba2's scan by the chunked dual form (chunk Q =
``PROGRAM_CHUNK``) counts forward Q^2 (N + H P) a chunk over
the visible half (C B^T and the weighted sum of x) plus 4 S N H P a
sequence (chunk states and their read-out), times 3 for the backward.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .model import (HEAD_P, _below, _ident, attention_flops, attn_block,
                    attn_block_params, attn_block_shapes, embedding_shapes,
                    head_loss, head_params, linear_init_scale, mamba2,
                    rmsnorm)

# Mamba2's initialisation of a head's decay and step (arXiv:2405.21060,
# the reference implementation's defaults): A ~ U(1, 16); dt log-uniform
# in [dt_min, dt_max], floored, and dt_bias its inverse softplus.
A_RANGE = (1.0, 16.0)
DT_RANGE = (1e-3, 0.1)
DT_FLOOR = 1e-4
# the chunk the program's scan runs at (``repro_torch/models/ssm.py``'s
# default), which the FLOPs count; the reference's own scan runs at
# ``model.SSD_CHUNK``, and its result does not depend on the chunk
PROGRAM_CHUNK = 256


def param_shapes(cfg: dict) -> Dict[str, tuple]:
    D, L = cfg["d_model"], cfg["n_layers"]
    N, E, K = cfg["ssm_state"], cfg.get("ssm_expand", 2), cfg.get(
        "ssm_conv", 4)
    di = E * D
    nh = di // HEAD_P
    shapes = embedding_shapes(cfg)
    shapes.update({
        "blocks/ln/scale": (L, D),
        "blocks/ssm/xz_proj/w": (L, D, 2 * di),
        "blocks/ssm/bcdt_proj/w": (L, D, 2 * N + nh),
        "blocks/ssm/conv_w": (L, K, di),
        "blocks/ssm/A_log": (L, nh),
        "blocks/ssm/dt_bias": (L, nh),
        "blocks/ssm/D": (L, nh),
        "blocks/ssm/out_proj/w": (L, di, D)})
    shapes.update(attn_block_shapes(cfg, "shared_attn", ()))
    return shapes


def init_scale(path: str, shape: tuple) -> Optional[float]:
    """D is 1; A_log and dt_bias are drawn by ``init_uniform``."""
    if path.rsplit("/", 1)[-1] in ("D", "A_log", "dt_bias"):
        return None
    return linear_init_scale(path, shape)


def init_uniform(path: str, u: torch.Tensor) -> Optional[torch.Tensor]:
    last = path.rsplit("/", 1)[-1]
    if last == "A_log":
        return torch.log(A_RANGE[0] + (A_RANGE[1] - A_RANGE[0]) * u)
    if last == "dt_bias":
        lo, hi = math.log(DT_RANGE[0]), math.log(DT_RANGE[1])
        dt = torch.exp(lo + (hi - lo) * u).clamp(min=DT_FLOOR)
        return dt + torch.log(-torch.expm1(-dt))
    return None


def _segments(cfg):
    bounds = [0] + sorted(cfg.get("attn_positions", [])) + [cfg["n_layers"]]
    return [(bounds[s], bounds[s + 1], s < len(bounds) - 2)
            for s in range(len(bounds) - 1)]


def sequence_loss(p, tokens, labels, cfg: dict,
                  q8: Callable = _ident) -> torch.Tensor:
    eps = cfg["norm_eps"]
    x = q8(p["embed/table"][tokens])
    shared = _below(p, "shared_attn")
    for lo, hi, then_attn in _segments(cfg):
        for i in range(lo, hi):
            x = q8(checkpoint(lambda h, i=i: h + mamba2(
                p, i, rmsnorm(h, p["blocks/ln/scale"][i], eps), cfg, q8),
                x, use_reentrant=False))
        if then_attn:
            x = q8(checkpoint(attn_block, shared, x, cfg, q8,
                              use_reentrant=False))
    return head_loss(p, x, labels, cfg, q8)


def matmul_params(cfg: dict) -> int:
    D, N = cfg["d_model"], cfg["ssm_state"]
    di = cfg.get("ssm_expand", 2) * D
    nh = di // HEAD_P
    ssm = D * 2 * di + D * (2 * N + nh) + di * D
    return (cfg["n_layers"] * ssm
            + len(cfg.get("attn_positions", [])) * attn_block_params(cfg)
            + head_params(cfg))


def step_flops(cfg: dict, seq_len: int, sequences: int) -> float:
    S = seq_len
    total = 6.0 * matmul_params(cfg) * (S * sequences)
    total += attention_flops(cfg, S, len(cfg.get("attn_positions", [])),
                             sequences)
    N, di = cfg["ssm_state"], cfg.get("ssm_expand", 2) * cfg["d_model"]
    nh = di // HEAD_P
    Q = min(PROGRAM_CHUNK, S)
    nc = -(-S // Q)
    fwd = nc * Q * Q * (N + nh * HEAD_P) + 4.0 * S * N * nh * HEAD_P
    return total + 3.0 * fwd * cfg["n_layers"] * sequences
