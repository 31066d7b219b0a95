"""Sequential-batching reference loop: the scheduler's oracle.

Deliberately naive: admit the next ``n_slots`` requests as a static
batch, replay every prompt through the decode path, greedy-decode the
whole group to completion (finished rows keep stepping harmlessly),
then move to the next group, copying tokens to the host every
iteration. It shares exactly one thing with the engine: the
``engine.pool_step`` computation, so any divergence between this loop
and the engine's streams is a scheduling or paging bug, never a
numerics difference. Port of ``repro.serve.reference``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import model as M

from .cache_pool import CachePool
from .engine import params_device, pool_step
from .scheduler import Request


def sequential_serve(params, cfg, requests: List[Request], *,
                     n_slots: int, max_len: int,
                     window: Optional[int] = None, workers=None
                     ) -> Dict[int, np.ndarray]:
    """``workers`` runs it on the engine's placement over a worker group
    (the same pool step and slot split); ``params`` are then this rank's,
    as ``engine.place_params`` gives them."""
    window = window if window is not None else cfg.sliding_window
    step_fn = pool_step(cfg, window, workers)
    params = M.cast_block_weights(params, cfg)
    dev = params_device(params)
    ones = torch.ones(n_slots, dtype=torch.float32, device=dev)
    out: Dict[int, list] = {r.uid: [] for r in requests}
    for g0 in range(0, len(requests), n_slots):
        group = requests[g0:g0 + n_slots]
        cache = CachePool(cfg, n_slots, max_len, device=dev,
                          workers=workers).cache
        prev = torch.zeros(n_slots, dtype=torch.int32, device=dev)
        consumed = [0] * len(group)
        emitted = [0] * len(group)
        while any(e < r.max_new_tokens
                  for e, r in zip(emitted, group)):
            forced = np.zeros(n_slots, np.int32)
            use = np.zeros(n_slots, bool)
            emits = []
            for i, req in enumerate(group):
                P = req.prompt.shape[0]
                if consumed[i] < P:
                    forced[i] = req.prompt[consumed[i]]
                    use[i] = True
                    consumed[i] += 1
                    if consumed[i] == P:
                        emits.append(i)
                        emitted[i] = 1
                elif emitted[i] < req.max_new_tokens:
                    emits.append(i)
                    emitted[i] += 1
            prev, cache = step_fn(params, cache, prev,
                                  torch.from_numpy(forced).to(dev),
                                  torch.from_numpy(use).to(dev), ones)
            toks = prev.cpu().numpy()
            for i in emits:
                out[group[i].uid].append(int(toks[i]))
    return {uid: np.asarray(v, np.int32) for uid, v in out.items()}
