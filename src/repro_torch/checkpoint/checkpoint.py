"""Checkpoints: a tree of tensors <-> ``.npz`` with a ``.json`` sidecar.

Port of ``repro.checkpoint.checkpoint``, in the same format: the arrays
are ``a0, a1, ...`` in the reference's flatten order (dict keys sorted
at every level) and the sidecar holds their "/"-joined key paths and the
step. A checkpoint written by either package therefore loads in the
other. Atomic writes (tmp + rename, the sidecar before the ``.npz``),
step-numbered names and latest-step discovery are the reference's.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save(path: str, tree: Any, step: Optional[int] = None) -> str:
    """Save ``tree`` into the directory ``path``; returns the file
    written. The sidecar lands before the ``.npz``, so a kill at any
    point leaves no discoverable checkpoint or a complete one."""
    os.makedirs(path, exist_ok=True)
    name = f"ckpt_{step:08d}" if step is not None else "ckpt"
    keys, leaves = T.flatten(tree)
    vals = [_to_numpy(v) for v in leaves]
    fd, tmpj = tempfile.mkstemp(dir=path, suffix=".tmp.json")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump({"keys": keys, "step": step}, f)
        os.replace(tmpj, os.path.join(path, name + ".json"))
    finally:
        if os.path.exists(tmpj):
            os.remove(tmpj)
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, **{f"a{i}": v for i, v in enumerate(vals)})
        os.replace(tmp, os.path.join(path, name + ".npz"))
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return os.path.join(path, name + ".npz")


def saved_steps(path: str) -> list:
    """Sorted step numbers of the checkpoints in ``path``."""
    if not os.path.isdir(path):
        return []
    return sorted(int(f[5:13]) for f in os.listdir(path)
                  if f.startswith("ckpt_") and f.endswith(".npz"))


def latest_step(path: str) -> Optional[int]:
    steps = saved_steps(path)
    return steps[-1] if steps else None


def restore_fallback(path: str, templates,
                     max_step: Optional[int] = None
                     ) -> Tuple[int, str, Any]:
    """Restore the newest checkpoint at or before ``max_step`` that
    loads, walking back past torn or foreign ones. Returns (step, label,
    state); raises ValueError listing every failure when none loads."""
    steps = [s for s in saved_steps(path)
             if max_step is None or s <= max_step]
    failures = []
    for s in reversed(steps):
        try:
            label, state = restore_any(path, templates, step=s)
            return s, label, state
        except Exception as e:  # noqa: BLE001 -- a torn file raises
            # anything from BadZipFile to ValueError: try the step before.
            failures.append(f"step {s}: {type(e).__name__}: {e}")
    raise ValueError("no intact checkpoint found: "
                     + ("; ".join(failures) or "no steps saved"))


def restore_any(path: str, templates, step: Optional[int] = None
                ) -> Tuple[str, Any]:
    """Restore into the first matching template of an ordered list of
    (label, like) pairs; returns (label, restored). Raises ValueError
    listing every failure when none matches."""
    failures = []
    for label, like in templates:
        try:
            return label, restore(path, like, step=step)
        except (ValueError, KeyError) as e:
            failures.append(f"{label}: {e}")
    raise ValueError("no checkpoint template matched: "
                     + "; ".join(failures))


def restore(path: str, like: Any, step: Optional[int] = None) -> Any:
    """Restore into the structure of ``like``: leaf count and shapes are
    validated, and each array becomes a tensor in its saved dtype on the
    device of the matching leaf of ``like`` (the CPU for a non-tensor
    leaf)."""
    if step is None:
        step = latest_step(path)
    name = f"ckpt_{step:08d}" if step is not None else "ckpt"
    with open(os.path.join(path, name + ".json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, name + ".npz")) as data:
        vals = [data[f"a{i}"] for i in range(len(meta["keys"]))]
    flat_like = T.leaves(like)
    if len(flat_like) != len(vals):
        raise ValueError(f"checkpoint has {len(vals)} leaves, "
                         f"expected {len(flat_like)}")
    out = []
    for a, b in zip(flat_like, vals):
        if tuple(a.shape) != tuple(b.shape):
            raise ValueError(f"shape mismatch {tuple(a.shape)} vs "
                             f"{b.shape}")
        dev = a.device if isinstance(a, torch.Tensor) else "cpu"
        out.append(torch.from_numpy(np.array(b)).to(dev))
    return T.like(like, out)
