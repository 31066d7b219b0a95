"""Coded prefill service: the paper's replicate-and-decode machinery
applied to admission rounds.

Each admission round, the layer samples an alive mask from the
configured ``core.stragglers`` process (a straggler here is a replica
slice answering after the deadline), decodes it with the optimal O(m)
decoder into machine weights w (w_j = 0 on stragglers), and serves
every shard whose combine weight alpha_i = (A w)_i is usable
(``core.step_weights.served_blocks``). A shard both of whose replicas
straggled pays one deadline and retries on a fresh round. The alpha
that served a request's shard is what the engine multiplies into that
request's first-token logits -- the debiased combine of "whichever
replicas arrive first". Decodes are memoised by mask, which pays off
for stagnant straggler processes.

``UncodedPrefillLayer`` is the d=1 baseline with the same interface:
one replica per shard, nothing to combine, so a straggling replica is
waited out at full ``straggle_ms``.

Copy of ``repro.serve.coded``: NumPy throughout and the same RNG
calls, so shard services are bit-identical to the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs import CodingConfig
from repro_torch.core import step_weights as sw
from repro_torch.dist import coded_train

from .latency import ReplicaLatencyModel


@dataclasses.dataclass(frozen=True)
class ShardService:
    """How one request's prefill shard got served."""
    shard: int
    alpha: float        # combine weight applied to first-token logits
    ttft_ms: float      # synthetic shard service latency
    retries: int


class CodedPrefillLayer:
    """d-replicated prefill shards over an expander assignment."""

    def __init__(self, coding: CodingConfig, m_replicas: int,
                 latency: Optional[ReplicaLatencyModel] = None, *,
                 eps: float = 1e-3, max_retries: int = 16):
        self.coding = coding
        self.assignment = coded_train.make_assignment(coding, m_replicas)
        self.model = sw.make_straggler_model(
            self.assignment, coding.straggler_model, coding.straggler_p)
        self.rng = np.random.default_rng(coding.seed)
        self.latency = latency or ReplicaLatencyModel(m=m_replicas)
        self.eps = eps
        self.max_retries = max_retries
        self._memo: Dict[bytes, Tuple[np.ndarray, np.ndarray]] = {}
        self.rounds = 0
        self.decode_calls = 0
        self._next_shard = 0

    def assign_shards(self, k: int) -> List[int]:
        """Round-robin the next k requests over the n prefill shards."""
        n = self.assignment.n
        out = [(self._next_shard + i) % n for i in range(k)]
        self._next_shard = (self._next_shard + k) % n
        return out

    def _round(self):
        alive = self.model.sample(self.rng)
        self.rounds += 1
        key = alive.tobytes()
        hit = self._memo.get(key)
        if hit is None:
            # Serving combines *identical* replica outputs, so the
            # alpha-bar debias scale (a training-expectation device)
            # stays off: scale=1 keeps alpha == 1 exactly when every
            # replica arrives, which is what makes the p=0 coded
            # stream bit-identical to the single-replica stream.
            hit = sw.step_weights(
                self.assignment, alive, method=self.coding.decoding,
                p=self.coding.straggler_p)
            self._memo[key] = hit
            self.decode_calls += 1
        w, alpha = hit
        lat = self.latency.latencies(alive, self.rng)
        return alive, alpha, np.where(alive, lat, np.inf)

    def serve_shards(self, shards: List[int]) -> List[ShardService]:
        """Serve one admission group's shards; the group shares each
        round's mask (they face the same replica fleet at the same
        moment), retries consume fresh rounds."""
        results: List[Optional[ShardService]] = [None] * len(shards)
        remaining = set(range(len(shards)))
        waited_ms = 0.0
        for r in range(self.max_retries + 1):
            _, alpha, lat_arrived = self._round()
            for idx in sorted(remaining):
                i = shards[idx]
                if alpha[i] > self.eps:
                    support = self.assignment.machines_of_block(i)
                    t = float(lat_arrived[support].min())
                    results[idx] = ShardService(
                        i, float(alpha[i]), waited_ms + t, r)
            remaining -= {i for i, s in enumerate(results)
                          if s is not None}
            if not remaining:
                return results
            waited_ms += self.latency.deadline_ms
        for idx in remaining:
            # Every replica of this shard straggles round after round
            # (the adversarial attack): wait them out. All replicas
            # present => the full-alive decode, alpha == 1.
            results[idx] = ShardService(
                shards[idx], 1.0, waited_ms + self.latency.straggle_ms,
                self.max_retries + 1)
        return results


class UncodedPrefillLayer:
    """d=1 baseline: shard i lives only on replica i."""

    def __init__(self, coding: CodingConfig, m_replicas: int,
                 latency: Optional[ReplicaLatencyModel] = None):
        self.assignment = coded_train.make_assignment(
            dataclasses.replace(coding, scheme="uncoded"), m_replicas)
        self.model = sw.make_straggler_model(
            self.assignment, coding.straggler_model, coding.straggler_p)
        self.rng = np.random.default_rng(coding.seed)
        self.latency = latency or ReplicaLatencyModel(m=m_replicas)
        self.rounds = 0
        self.decode_calls = 0
        self._next_shard = 0

    def assign_shards(self, k: int) -> List[int]:
        n = self.assignment.n
        out = [(self._next_shard + i) % n for i in range(k)]
        self._next_shard = (self._next_shard + k) % n
        return out

    def serve_shards(self, shards: List[int]) -> List[ShardService]:
        alive = self.model.sample(self.rng)
        self.rounds += 1
        lat = self.latency.latencies(alive, self.rng)
        return [ShardService(i, 1.0, float(lat[i]), 0) for i in shards]
