"""Continuous-batching coded serving, ported from ``repro.serve``.

The engine (``engine.ServeEngine``) packs per-request KV caches into a
fixed slot pool (``cache_pool.CachePool``) and advances every slot one
token per device step: prefill is prompt replay interleaved
token-for-token with decode (``scheduler.ContinuousScheduler``).

The replica-as-straggler model: each prefill shard is replicated d=2
times over ``core.assignment.expander_assignment`` (shards are the
expander's vertices, replica slices its edges); per-replica latency
comes from the ``core.stragglers`` processes; the replicas that arrive
first are combined with the weights w of the paper's optimal O(m)
decoder (``coded.CodedPrefillLayer``). Replicas compute identical
outputs, so the combine scales the shard's first-token logits by its
alpha_i = (A w)_i; a shard with no usable weight pays one deadline and
retries.

The differential pins: at p=0 every alpha_i is exactly 1.0 and the
coded stream is bit-identical to the uncoded one; the engine's streams
are bit-identical to ``reference.sequential_serve`` under any admission
order.
"""

from .cache_pool import CachePool, slot_rows
from .coded import CodedPrefillLayer, ShardService, UncodedPrefillLayer
from .engine import (PoolStep, ServeEngine, place_params, pool_step,
                     validate_budget)
from .latency import (ReplicaLatencyModel, percentile_row,
                      simulate_shard_ttft)
from .reference import sequential_serve
from .scheduler import (ContinuousScheduler, IterationPlan, Request,
                        SequentialScheduler)

__all__ = [
    "CachePool", "CodedPrefillLayer", "ContinuousScheduler",
    "IterationPlan", "PoolStep", "ReplicaLatencyModel", "Request",
    "ServeEngine", "SequentialScheduler", "ShardService",
    "UncodedPrefillLayer", "percentile_row", "place_params", "pool_step",
    "sequential_serve", "simulate_shard_ttft", "slot_rows",
    "validate_budget",
]
