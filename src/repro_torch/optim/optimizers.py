"""Optimizers as pure functions over nested dicts of tensors.

Port of ``repro.optim.optimizers``: ``init(params) -> state``,
``update(grads, state, params) -> (updates, state)``, and
``apply_updates`` adds them. The state keeps the reference's layout
(``step`` as an int32 scalar, ``m`` / ``v`` or ``mu`` as float32 trees),
so an optimizer state crosses between the packages through a
checkpoint. Every function returns new tensors and leaves its inputs as
they were, as the reference's do; the arithmetic is written in the
reference's order so that a float32 trajectory agrees with it to
rounding.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch import tree as T


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, state)


def apply_updates(params, updates):
    return T.map(lambda p, u: (p + u).to(p.dtype), params, updates)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in T.leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return T.map(lambda g: g * scale, grads), norm


def _zeros_f32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _step0(params):
    dev = T.leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def sgd(lr, momentum: float = 0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        state = {"step": _step0(params)}
        if momentum:
            state["mu"] = T.map(_zeros_f32, params)
        return state

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        if momentum:
            mu = T.map(lambda m, g: momentum * m + g.float(),
                       state["mu"], grads)
            updates = T.map(lambda m: -lr_t * m, mu)
            return updates, {"step": step, "mu": mu}
        updates = T.map(lambda g: -lr_t * g.float(), grads)
        return updates, {"step": step}

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        return {"step": _step0(params),
                "m": T.map(_zeros_f32, params),
                "v": T.map(_zeros_f32, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        m = T.map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                  state["m"], grads)
        v = T.map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(
            g.float()), state["v"], grads)
        stepf = step.float()
        bc1 = 1 - torch.pow(b1, stepf)
        bc2 = 1 - torch.pow(b2, stepf)

        def upd(m_, v_, p):
            u = -lr_t * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                u = u - lr_t * weight_decay * p.float()
            return u
        updates = T.map(upd, m, v, params)
        return updates, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1):
    def fn(step):
        step = torch.as_tensor(step).float()
        warm = peak_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = peak_lr * (floor + (1 - floor) * 0.5 *
                         (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return fn


def get_optimizer(name: str, lr, **kw) -> Optimizer:
    if name == "sgd":
        return sgd(lr, **kw)
    if name == "adamw":
        return adamw(lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
