"""The ``dense`` reference family: a pre-norm decoder (the Llama /
Granite block). RMSNorm; GQA self-attention with rotary embeddings and a
causal softmax; a SwiGLU MLP; a final RMSNorm; logits against the tied
embedding (or an untied head). Each layer runs under
``torch.utils.checkpoint``, so that a 4,096-token sequence fits beside
the optimizer state. The pieces are ``model``'s."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .model import (_below, _ident, attention_flops, attn_block,
                    attn_block_params, attn_block_shapes, embedding_shapes,
                    head_loss, head_params, linear_init_scale)


def param_shapes(cfg: dict) -> Dict[str, tuple]:
    shapes = embedding_shapes(cfg)
    shapes.update(attn_block_shapes(cfg, "blocks", (cfg["n_layers"],)))
    return shapes


def init_scale(path: str, shape: tuple) -> Optional[float]:
    return linear_init_scale(path, shape)


def init_uniform(path: str, u: torch.Tensor) -> Optional[torch.Tensor]:
    return None


def sequence_loss(p, tokens, labels, cfg: dict,
                  q8: Callable = _ident) -> torch.Tensor:
    x = q8(p["embed/table"][tokens])
    for i in range(cfg["n_layers"]):
        x = q8(checkpoint(attn_block, _below(p, "blocks", i), x, cfg, q8,
                          use_reentrant=False))
    return head_loss(p, x, labels, cfg, q8)


def matmul_params(cfg: dict) -> int:
    return cfg["n_layers"] * attn_block_params(cfg) + head_params(cfg)


def step_flops(cfg: dict, seq_len: int, sequences: int) -> float:
    total = 6.0 * matmul_params(cfg) * (seq_len * sequences)
    return total + attention_flops(cfg, seq_len, cfg["n_layers"], sequences)
