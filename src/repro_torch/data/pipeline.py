"""Data pipeline: synthetic corpora + the coded block partitioner.

The partitioner is where the paper's assignment matrix meets the batch:
a global batch of sequences is split into n data blocks, the blocks are
shuffled by the per-run permutation rho (Algorithm 2's unbiasedness
trick), and each of the m coded workers receives the concatenation of
its assigned blocks (two, for graph schemes). The emitted ``coded
batch`` has a leading machine axis of size m that the distributed
runtime shards over the (pod, data) mesh axes; ``unique_blocks`` is
the deduplicated view of the same partition (one row per block, no
replication) for the mesh-reproduction train path.

Copy of ``repro.data.pipeline``: NumPy only, so batches are
bit-identical to the reference's for the same seed and step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.core.assignment import Assignment


@dataclasses.dataclass
class SyntheticLM:
    """Deterministic synthetic token stream (zipf-ish unigram mixture +
    a copy motif so the loss is learnable)."""

    vocab_size: int
    seq_len: int
    seed: int = 0

    def batch(self, global_batch: int, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed + 7919 * step)
        V = self.vocab_size
        ranks = np.arange(1, V + 1)
        probs = 1.0 / ranks
        probs /= probs.sum()
        toks = rng.choice(V, size=(global_batch, self.seq_len + 1),
                          p=probs)
        # copy motif: second half repeats the first half for 1/4 of rows
        k = global_batch // 4
        half = (self.seq_len + 1) // 2
        toks[:k, half:2 * half] = toks[:k, :half]
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }


@dataclasses.dataclass
class CodedBatcher:
    """Maps a global batch -> per-machine replicated blocks.

    ``assignment``: block-level matrix (n x m). The global batch size
    must be divisible by n; block i is rows [i*bs : (i+1)*bs] after the
    rho shuffle. Output tensors have shape (m, load, block_rows, ...)
    where load = max blocks/machine (graph schemes: exactly 2).
    """

    assignment: Assignment
    shuffle_seed: Optional[int] = 0

    def __post_init__(self):
        n, m = self.assignment.n, self.assignment.m
        load = self.assignment.load
        # machine -> its block ids, padded to `load` by repeating the
        # first block with weight 0 (mask) for irregular assignments.
        ids = np.zeros((m, load), dtype=np.int64)
        mask = np.zeros((m, load), dtype=np.float32)
        for j in range(m):
            bs = self.assignment.blocks_of_machine(j)
            ids[j, :len(bs)] = bs
            mask[j, :len(bs)] = 1.0
            if len(bs) < load:
                ids[j, len(bs):] = bs[0] if len(bs) else 0
        self.block_ids = ids
        self.block_mask = mask
        if self.shuffle_seed is not None:
            rng = np.random.default_rng(self.shuffle_seed)
            self.rho = rng.permutation(n)
        else:
            self.rho = np.arange(n)

    def code_batch(self, batch: Dict[str, np.ndarray]
                   ) -> Dict[str, np.ndarray]:
        n = self.assignment.n
        out = {}
        for k, v in batch.items():
            gb = v.shape[0]
            if gb % n:
                raise ValueError(f"global batch {gb} not divisible by "
                                 f"n={n} blocks")
            bs = gb // n
            blocks = v.reshape((n, bs) + v.shape[1:])
            blocks = blocks[self.rho]          # rho shuffle
            out[k] = blocks[self.block_ids]    # (m, load, bs, ...)
        out["block_weight"] = self.block_mask  # (m, load)
        return out

    def unique_blocks(self, batch: Dict[str, np.ndarray]
                      ) -> Dict[str, np.ndarray]:
        """Dedup emitter: global batch -> (n, block_rows, ...) unique
        blocks after the rho shuffle -- the same data ``code_batch``
        replicates onto machines, emitted once per block. Row i here is
        the data block the assignment's block id i carries, so the
        per-block weights ``v = A @ w``
        (``core.step_weights.block_weights``) line up by construction
        and ``sum_i v_i grad L_i`` equals the replicated machine
        combine without the d-fold recompute.
        """
        n = self.assignment.n
        out = {}
        for k, v in batch.items():
            gb = v.shape[0]
            if gb % n:
                raise ValueError(f"global batch {gb} not divisible by "
                                 f"n={n} blocks")
            bs = gb // n
            out[k] = v.reshape((n, bs) + v.shape[1:])[self.rho]
        return out


@dataclasses.dataclass
class SyntheticRegression:
    """The paper's Section VIII least-squares data, streamed in blocks."""

    N: int
    k: int
    noise: float
    seed: int = 0

    def generate(self):
        rng = np.random.default_rng(self.seed)
        X = rng.normal(size=(self.N, self.k)) / np.sqrt(self.k)
        theta = rng.normal(size=self.k)
        Y = X @ theta + self.noise * rng.normal(size=self.N)
        return X, Y, theta


def data_iterator(source: SyntheticLM, batcher: Optional[CodedBatcher],
                  global_batch: int, steps: int
                  ) -> Iterator[Dict[str, np.ndarray]]:
    for step in range(steps):
        b = source.batch(global_batch, step)
        yield batcher.code_batch(b) if batcher is not None else b
