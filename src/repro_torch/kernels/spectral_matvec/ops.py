"""Public tall-skinny Gram matvec for the matrix-free spectral pipeline.

Port of ``repro.kernels.spectral_matvec.ops``. ``prepare_operand``
stages the tall operand once for a run of matvecs (a Lanczos
iteration): a float32 tensor on the card, or float64 NumPy on the CPU.
The matvecs then dispatch on what they are given: a CUDA tensor runs
the CUDA kernel (float32 accumulation; callers branch their tolerances
on ``uses_kernel``), a NumPy operand the reference's float64 oracle --
so on the CPU every result is bit-identical to ``repro.core`` -- and a
CPU tensor the plain float32 torch version. ``_FORCE`` is the test
hook: ``"ref"`` runs the plain torch version on the operand's device,
``"kernel"`` insists on the kernel and raises for anything not on the
card. Results come back as float64 NumPy. ``launches`` counts kernel
launches and ``plain_calls`` plain torch runs, per entry point.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve
from . import kernel, ref

_FORCE = None  # test hook: None | "ref" | "kernel"
launches = {"gram_matvec": 0, "gram_matvec_block": 0,
            "gram_matvec_batch": 0}
plain_calls = dict.fromkeys(launches, 0)


def uses_kernel(device=None) -> bool:
    """True when the matvecs for ``device`` run in float32 on the card
    (``device=None`` means the card): the counterpart of the reference's
    ``uses_pallas()``."""
    return resolve(device).type == "cuda"


def prepare_operand(x, device=None):
    """Stage the tall operand (R, k) or stacked (B, R, k) once: a
    contiguous float32 tensor on the card, float64 NumPy on the CPU (a
    no-copy view for float64 input)."""
    dev = resolve(device)
    if dev.type == "cuda":  # rounded on the host: half the upload
        return torch.from_numpy(
            np.ascontiguousarray(x, dtype=np.float32)).to(dev)
    return np.asarray(x, np.float64)


def _run(entry, fn, x, args, oracle):
    """One matvec through the path ``x`` selects; ``fn`` names the
    kernel and plain functions, ``entry`` the count, ``args`` are the
    NumPy right-hand sides."""
    if _FORCE not in (None, "ref", "kernel"):
        raise ValueError(f"unknown _FORCE {_FORCE!r}")
    if _FORCE is None and isinstance(x, np.ndarray):
        return oracle(x, *args)
    xt = torch.as_tensor(x)
    rhs = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
           .to(xt.device) for a in args]
    if _FORCE == "ref" or (_FORCE is None and xt.device.type == "cpu"):
        out = getattr(ref, fn)(xt, *rhs)
        plain_calls[entry] += 1
    else:
        out = getattr(kernel, fn)(xt, *rhs)
        launches[entry] += 1
    return out.cpu().numpy().astype(np.float64)


def gram_matvec(x, v) -> np.ndarray:
    """x: (R, k), v: (k,) -> x^T (x v) as float64 NumPy.

    ``x`` may be a NumPy array or an operand staged by
    ``prepare_operand`` (used in place, no host round-trip).
    """
    v = np.asarray(v)
    if getattr(x, "ndim", 0) != 2 or v.shape != (x.shape[1],):
        raise ValueError(f"need x (R, k) and v (k,), got "
                         f"{getattr(x, 'shape', None)} and {v.shape}")
    return _run("gram_matvec", "gram_matvec", x, (v,), ref.gram_matvec_np)


def gram_matvec_block(x, V) -> np.ndarray:
    """x: (R, k), V: (k, b) -> x^T (x V) as float64 NumPy -- the
    block-Lanczos form (b right-hand sides per pass over x)."""
    V = np.asarray(V)
    if getattr(x, "ndim", 0) != 2 or V.ndim != 2 or \
            V.shape[0] != x.shape[1]:
        raise ValueError(f"need x (R, k) and V (k, b), got "
                         f"{getattr(x, 'shape', None)} and {V.shape}")
    # the kernel takes the right-hand sides as rows: (b, k) in and out
    return _run("gram_matvec_block", "gram_matvec", x,
                (np.ascontiguousarray(V.T),),
                lambda x, Vt: ref.gram_matvec_block_np(x, Vt.T).T).T


def gram_matvec_batch(x, v) -> np.ndarray:
    """x: (B, R, k), v: (B, k) -> (B, k) per-slice x_b^T (x_b v_b) as
    float64 NumPy -- the lockstep-Lanczos batch form (one pass over the
    whole stack per iteration).

    ``x`` may be staged by ``prepare_operand`` (device-resident on the
    card, so only the small (B, k) vectors travel per call).
    """
    v = np.asarray(v)
    if getattr(x, "ndim", 0) != 3 or \
            v.shape != (x.shape[0], x.shape[2]):
        raise ValueError(f"need x (B, R, k) and v (B, k), got "
                         f"{getattr(x, 'shape', None)} and {v.shape}")
    return _run("gram_matvec_batch", "gram_matvec_batch", x, (v,),
                ref.gram_matvec_batch_np)
