"""The plain reference of the coded training steps that a cell checks.

Step t of the paper's coded gradient descent (Glasgow & Wootters,
Algorithm 2) over blocks i = 1..n of the step's global batch: the
machines that arrived give the optimal weights alpha = A w* (scaled by
the debias factor, ``coding``), and the step minimises

    L = (1 / N) sum_i alpha_i sum_{s in block i} CE(s),

N the label count of the replicated batch (each block counted once for
each of the d machines that hold it). Its gradient is the combine
sum_j w_j g_j over the machines, whichever way a program computes it.
AdamW (Loshchilov & Hutter) then moves the float32 parameters.

``run`` computes t = 1..steps sequence by sequence and returns what the
check compares: each step's loss, the norm of each leaf's first gradient,
each leaf's change over the steps and each step's alpha. ``fault``
plants one fault for the control (``"half_batch"``: the second half of
the blocks left out and the loss normalised over the rest;
``"rank_only"``: only the blocks of the first of ``ranks`` ranks' machines,
the exchange between ranks left out; ``"alpha"``: one block's weight
doubled where the decoder produces it).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import coding
from . import model as ref_model


FAULTS = ("half_batch", "rank_only", "alpha")


def _adamw(p, g, m, v, t, opt):
    b1, b2, lr, eps = opt["b1"], opt["b2"], opt["lr"], opt["eps"]
    m.mul_(b1).add_(g, alpha=1 - b1)
    v.mul_(b2).addcmul_(g, g, value=1 - b2)
    mh = m / (1 - b1 ** t)
    vh = v / (1 - b2 ** t)
    # the decoupled decay inside the step, as the paper's algorithm writes
    # it: p <- p - lr (m^ / (sqrt(v^) + eps) + wd p)
    p.sub_(lr * (mh / (vh.sqrt() + eps) + opt.get("weight_decay", 0.0) * p))


def alphas(traffic: dict, seed: int, masks) -> List[np.ndarray]:
    """The reference's alpha = A w* for each step's alive mask."""
    A = coding.assignment(traffic["scheme"], traffic["machines"],
                          traffic["replication"])
    scale = coding.debias_scale(A, traffic["straggler_p"], seed)
    return [coding.optimal_alpha(A, m) * scale for m in masks]


def run(cfg: dict, traffic: dict, seed: int, params0: Dict[str, torch.Tensor],
        batches: List[Dict[str, np.ndarray]], masks, *,
        q8: Callable = ref_model._ident, fault: Optional[str] = None,
        ranks: int = 1) -> dict:
    """``params0``: the starting float32 leaves (consumed: trained in
    place); ``batches``: each step's global batch {"tokens", "labels"}
    (gb, S); ``masks``: each step's (m,) alive mask."""
    opt = traffic["optimizer"]
    m_, d = traffic["machines"], traffic["replication"]
    A = coding.assignment(traffic["scheme"], m_, d)
    n = A.shape[0]
    rho = coding.block_order(n, seed)
    al = alphas(traffic, seed, masks)
    if fault == "alpha":
        al = [a.copy() for a in al]
        for a in al:
            a[0] *= 2.0
    dev = next(iter(params0.values())).device
    p = {k: v.detach().float().requires_grad_(True) for k, v in params0.items()}
    mom = {k: torch.zeros_like(v) for k, v in p.items()}
    vel = {k: torch.zeros_like(v) for k, v in p.items()}
    keep = list(range(n))
    if fault == "half_batch":
        keep = keep[:n // 2]
    elif fault == "rank_only":
        mine = set(np.flatnonzero(A[:, :m_ // ranks].sum(axis=1)))
        keep = [i for i in keep if i in mine]
    losses, first_grad = [], {}
    for t, (batch, a) in enumerate(zip(batches, al), start=1):
        gb = batch["tokens"].shape[0]
        bs = gb // n
        S = batch["tokens"].shape[1]
        norm = m_ * A.sum(axis=0).max() * bs * S
        if fault == "half_batch":
            norm = norm * len(keep) / n
        loss = 0.0
        for i in keep:
            for r in range(bs):
                row = rho[i] * bs + r
                tok = torch.from_numpy(batch["tokens"][row].astype(np.int64))
                lab = torch.from_numpy(batch["labels"][row].astype(np.int64))
                li = ref_model.sequence_loss(p, tok.to(dev), lab.to(dev), cfg,
                                             q8)
                (li * (a[i] / norm)).backward()
                loss += float(li.detach()) * a[i] / norm
        losses.append(loss)
        with torch.no_grad():
            for k, x in p.items():
                g = x.grad if x.grad is not None else torch.zeros_like(x)
                if t == 1:
                    first_grad[k] = float(torch.linalg.vector_norm(g))
                _adamw(x, g, mom[k], vel[k], t, opt)
                x.grad = None
    del mom, vel
    return {"losses": losses, "first_grad": first_grad,
            "params": {k: v.detach() for k, v in p.items()},
            "alphas": al}
