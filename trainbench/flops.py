"""Model FLOPs of one coded training step, from the configuration's
shapes: the operations the step's distinct tokens need, forward and
backward, whatever the program does to compute them.

- Matmuls: 6 x (parameters in matmuls) x tokens. The embedding lookup is
  not a matmul; the LM head counts the real vocabulary, not its padding;
  the shared attention block of a hybrid counts once for each insertion.
- Causal attention: forward 2 x S^2 x H x Dh a sequence and layer (Q K^T
  and P V over the visible half of the score matrix), times 3 for the
  backward.
- Mamba2's scan (the chunked dual form, chunk Q = ``chunk_size``):
  forward Q^2 (N + H P) a chunk over the visible half (C B^T and the
  weighted sum of x) plus 4 S N H P a sequence (chunk states and their
  read-out), times 3 for the backward.

Recomputation (remat, a flash backward's second Q K^T, masked tiles) and
the copies the replicated path computes are not counted.
"""

from __future__ import annotations

HEAD_P = 64


def matmul_params(model: dict) -> int:
    D, H, KVH, F = (model["d_model"], model["n_heads"], model["n_kv_heads"],
                    model["d_ff"])
    Dh = D // H
    attn = D * H * Dh + 2 * D * KVH * Dh + H * Dh * D + 3 * D * F
    head = D * model["vocab_size"]
    if model["arch_type"] == "dense":
        return model["n_layers"] * attn + head
    if model["arch_type"] == "hybrid":
        N, di = model["ssm_state"], model.get("ssm_expand", 2) * D
        nh = di // HEAD_P
        ssm = D * 2 * di + D * (2 * N + nh) + di * D
        return (model["n_layers"] * ssm
                + len(model.get("attn_positions", [])) * attn + head)
    raise NotImplementedError(model["arch_type"])


def attention_layers(model: dict) -> int:
    if model["arch_type"] == "dense":
        return model["n_layers"]
    return len(model.get("attn_positions", []))


def step_flops(model: dict, seq_len: int, sequences: int,
               chunk: int = 256) -> float:
    """FLOPs of a step that trains ``sequences`` distinct sequences of
    ``seq_len`` tokens."""
    S, T = seq_len, seq_len * sequences
    D, H = model["d_model"], model["n_heads"]
    total = 6.0 * matmul_params(model) * T
    total += 3.0 * 2.0 * S * S * H * (D // H) * attention_layers(model) \
        * sequences
    if model["arch_type"] == "hybrid":
        N, di = model["ssm_state"], model.get("ssm_expand", 2) * D
        nh = di // HEAD_P
        Q = min(chunk, S)
        nc = -(-S // Q)
        fwd = nc * Q * Q * (N + nh * HEAD_P) + 4.0 * S * N * nh * HEAD_P
        total += 3.0 * fwd * model["n_layers"] * sequences
    return total
