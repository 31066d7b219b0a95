"""Plain PyTorch decode attention (one query token vs a KV cache,
grouped-query): the oracle of the CUDA kernel."""

import torch


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, Dh); k, v: (B, S, KVH, Dh); lengths: (B,) valid prefix.

    Returns (B, H, Dh). H must be a multiple of KVH (GQA groups).
    fp32 softmax; output in q.dtype.
    """
    B, H, Dh = q.shape
    S, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    qf = q.reshape(B, KVH, G, Dh).float()
    scores = torch.einsum("bhgd,bshd->bhgs", qf, k.float()) * Dh ** -0.5
    pos = torch.arange(S, device=q.device)[None, None, None, :]
    mask = pos < lengths.to(q.device)[:, None, None, None]
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bshd->bhgd", probs, v.float())
    return out.reshape(B, H, Dh).to(q.dtype)
