"""The coded runtime's entry points that serving reaches.

Port of ``repro.dist.coded_train.make_serve_step`` and
``make_assignment``. The coded training step, the collectives and the
host ``CodingRuntime`` wait for the training slice; sharding waits for
the distributed slice (the port runs one device).
"""

from __future__ import annotations

from typing import Optional

from repro_torch.configs import CodingConfig, ModelConfig
from repro_torch.core.assignment import (Assignment, expander_assignment,
                                         frc_assignment,
                                         uncoded_assignment)
from repro_torch.models import model as M


def make_serve_step(cfg: ModelConfig, window: Optional[int] = None):
    """(params, token, cache) -> (logits, cache)."""
    def step(params, token, cache):
        return M.decode_step(params, token, cache, cfg, window=window)
    return step


def make_assignment(coding: CodingConfig, m: int) -> Assignment:
    """Instantiate the block assignment for m coded workers."""
    if coding.scheme == "expander":
        return expander_assignment(m, coding.replication,
                                   vertex_transitive=True,
                                   seed=coding.seed)
    if coding.scheme == "frc":
        return frc_assignment(m, coding.replication)
    if coding.scheme == "uncoded":
        return uncoded_assignment(m)
    raise ValueError(f"unknown scheme {coding.scheme!r} "
                     "(expander | frc | uncoded; the scheme zoo is not "
                     "ported yet)")
