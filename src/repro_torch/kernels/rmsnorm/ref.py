"""Plain PyTorch RMSNorm: the oracle of the CUDA kernel."""

import torch


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """y = x / sqrt(mean(x^2) + eps) * scale, reduction in fp32."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * (var + eps) ** -0.5
    return (y * scale.float()).to(x.dtype)
