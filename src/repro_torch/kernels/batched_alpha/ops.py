"""Public fused debias + error reduction: the debias scale (single
source) and the per-trial normalized decoding errors of a decoded batch.

Port of ``repro.kernels.batched_alpha.ops``. On the CPU it is the
float64 NumPy oracle, exactly as the reference runs off the TPU, which
keeps ``monte_carlo_error`` bit-identical to ``repro.core``; on the card
the batch goes up as float32 and the CUDA kernel reduces it, with the
debias scale entering as float32 as it does on the TPU. ``_FORCE`` is
the test hook: ``"ref"`` runs the plain float32 torch version on the
requested device, ``"kernel"`` insists on the kernel (and raises on the
CPU). ``device="meta"`` (a shape-only run) takes the plain torch
version and returns its meta result. ``launches`` counts kernel
launches, ``plain_calls`` runs of the plain torch version.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.device import resolve
from . import kernel, ref

_FORCE = None  # test hook: None | "ref" | "kernel"
launches = 0
plain_calls = 0


def debias_scale(alphas: np.ndarray) -> float:
    """The paper's alpha-bar normalisation: |1|_2 / |E[alpha]|_2 =
    sqrt(n)/max(|mean|_2, tiny). Single source of truth, also used by
    ``decoding.debias_alpha`` and ``step_weights.debias_scale``."""
    mean = alphas.mean(axis=0)
    return float(np.sqrt(alphas.shape[1]) /
                 max(np.linalg.norm(mean), 1e-30))


def fused_error(alphas, *, debias: bool = True,
                device=None) -> Tuple[np.ndarray, float]:
    """alphas: (trials, n) -> (errs (trials,) float64, scale).

    scale is ``debias_scale`` (float64, on the host) when debias else
    1.0; errs_t = (1/n)|scale * alpha_t - 1|^2. ``device=None`` means
    the card.
    """
    global launches, plain_calls
    a = np.asarray(alphas, dtype=np.float64)
    if a.ndim != 2:
        raise ValueError(f"alphas must be (trials, n), got {a.shape}")
    dev = resolve(device)
    if a.shape[0] == 0:
        return np.zeros((0,), dtype=np.float64), 1.0
    scale = debias_scale(a) if debias else 1.0
    if _FORCE not in (None, "ref", "kernel"):
        raise ValueError(f"unknown _FORCE {_FORCE!r}")
    if _FORCE is None and dev.type == "cpu":
        return ref.fused_error_np(a, scale), scale
    if _FORCE is None and dev.type == "meta":
        plain_calls += 1
        return ref.fused_error(torch.empty(a.shape, device=dev), scale), \
            scale
    # rounded to float32 on the host: half the upload, no cast kernel
    t = torch.from_numpy(a.astype(np.float32)).to(dev)
    if _FORCE == "ref":
        errs = ref.fused_error(t, scale)
        plain_calls += 1
    else:
        errs = kernel.fused_error(t, scale)
        launches += 1
    return errs.cpu().numpy().astype(np.float64), scale
