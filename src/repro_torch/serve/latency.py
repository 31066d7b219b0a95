"""Synthetic per-replica latency: the serving face of the straggler
process.

A replica that straggles this round (alive == False in the mask drawn
from ``core.stragglers``) does not fail -- it answers ``straggle_ms``
late, long after the scheduler's per-round ``deadline_ms``. Replicas
that do not straggle answer in ``base_ms`` plus an exponential jitter
tail, clipped to the deadline so "alive" and "arrived by the deadline"
are the same event. All times are synthetic milliseconds: the model
prices *scheduling decisions* (wait vs combine vs retry), it does not
time device compute -- measured tokens/s comes from the engine's real
wall clock.

``simulate_shard_ttft`` is the closed-loop quantile machine of the
reference's serving benchmark: given a pre-decoded weight stream and
the matching latency draws,
it plays the engine's per-shard service rule over thousands of rounds
and returns paired coded / uncoded time-to-first-token samples --
coded serving takes the *fastest arrived* replica of each shard and
pays one deadline per retry round when both replicas straggle
(probability ~ p^d), while the uncoded baseline has nothing to combine
and waits its single replica out (p99 == the slowest device).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.core import step_weights as sw
from repro_torch.core.assignment import Assignment


@dataclasses.dataclass
class ReplicaLatencyModel:
    """Latency shaper over an (m,) alive mask.

    ``latencies(alive, rng)`` -> (m,) ms; arrived replicas land in
    [base_ms, deadline_ms), stragglers at base + straggle_ms.
    """

    m: int
    base_ms: float = 2.0
    jitter_ms: float = 0.5
    straggle_ms: float = 60.0
    deadline_ms: float = 6.0

    def __post_init__(self):
        if not (self.base_ms < self.deadline_ms < self.straggle_ms):
            raise ValueError(
                "need base_ms < deadline_ms < straggle_ms, got "
                f"({self.base_ms}, {self.deadline_ms}, "
                f"{self.straggle_ms})")

    def latencies(self, alive: np.ndarray,
                  rng: np.random.Generator) -> np.ndarray:
        alive = np.asarray(alive, bool)
        lat = self.base_ms + rng.exponential(self.jitter_ms,
                                             size=alive.shape)
        # Arrived == before the deadline, by construction: the jitter
        # tail is clipped just under it.
        lat = np.minimum(lat, self.deadline_ms * (1 - 1e-6))
        return np.where(alive, lat, lat + self.straggle_ms)


def simulate_shard_ttft(assignment: Assignment, W: np.ndarray,
                        alive: np.ndarray, lat: np.ndarray, *,
                        deadline_ms: float, straggle_ms: float,
                        eps: float = 1e-3, max_retries: int = 16
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(coded_ttft (T, n), uncoded_ttft (T, m)) over T rounds.

    Coded rule per shard i of round t: if alpha_i = (A w_t)_i > eps,
    TTFT is the fastest arrived replica holding i; otherwise pay one
    deadline and retry on round t+1's draw (rows are reused
    cyclically). Shards still unserved after ``max_retries`` wait the
    stragglers out -- the adversarial model pins the same replicas
    every round, and waiting is then the only exit.

    Uncoded rule: shard i lives only on machine i; its TTFT is that
    machine's latency, straggle and all. Same ``lat`` matrix, so the
    comparison is paired draw for draw.
    """
    T, m = alive.shape
    n = assignment.n
    served = sw.served_blocks(assignment, W, eps)          # (T, n)
    lat_arrived = np.where(alive, lat, np.inf)             # (T, m)
    # min over each shard's replica support, per round
    shard_lat = np.stack(
        [lat_arrived[:, assignment.machines_of_block(i)].min(axis=1)
         for i in range(n)], axis=1)                       # (T, n)

    ttft = np.zeros((T, n))
    pending = np.ones((T, n), bool)
    for depth in range(max_retries + 1):
        rows = (np.arange(T) + depth) % T
        hit = pending & served[rows]
        ttft[hit] += shard_lat[rows][hit]
        pending &= ~served[rows]
        if not pending.any():
            break
        ttft[pending] += deadline_ms
    ttft[pending] += straggle_ms                           # wait it out

    if m == n:
        uncoded = lat                                      # (T, m)
    else:
        # replication changes n; draw an uncoded fleet from the same
        # latency columns (machine i serves shard i)
        uncoded = lat[:, :m]
    return ttft, uncoded


def percentile_row(scheme: str, model: str, p: float,
                   samples: np.ndarray) -> dict:
    """One BENCH_serve.json latency row."""
    flat = np.asarray(samples, float).ravel()
    return {"scheme": scheme, "straggler_model": model, "p": p,
            "p50_ms": float(np.percentile(flat, 50)),
            "p99_ms": float(np.percentile(flat, 99)),
            "mean_ms": float(flat.mean())}
