"""Device selection shared by every entry point of the port.

Entry points run on the GPU unless the caller asks for the CPU. A
request for CUDA on a machine without it raises: nothing quietly falls
back to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve(device: Optional[Union[str, torch.device]] = None
            ) -> torch.device:
    """``None`` means ``"cuda"``; returns a ``torch.device``.

    Float32 matrix products on the card are pinned to full float32
    (``allow_tf32 = False`` for both matmul and cuDNN), so a float32
    path computes what the reference's float32 path computes.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA was requested but torch.cuda.is_available() is "
                "False; pass device='cpu' (--device cpu) to run on the "
                "CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
