"""Straggler process models.

The paper analyses two models (Defs I.2 / I.3) and empirically observes a
third (Section VIII: "which machines are straggling tends to stay
stagnant throughout a run"):

- ``BernoulliStragglers``  : each machine straggles i.i.d. w.p. p.
- ``AdversarialStragglers``: worst-case |S| <= pm, instantiated with the
  attacks that achieve the known worst cases per scheme.
- ``MarkovStragglers``     : stagnant/bursty process matching the
  cluster observation; used to show why expander codes beat the FRC on
  real clusters even though the FRC is optimal for i.i.d. stragglers.

All models emit an ``alive`` boolean mask of shape (m,): True = machine
responded in time.

Copy of ``repro.core.stragglers``: masks come from the same
``np.random.Generator`` calls, so a seeded stream is bit-identical to the
reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .assignment import Assignment


class StragglerModel:
    def sample(self, rng: np.random.Generator) -> np.ndarray:
        raise NotImplementedError


@dataclasses.dataclass
class BernoulliStragglers(StragglerModel):
    m: int
    p: float

    def sample(self, rng: np.random.Generator) -> np.ndarray:
        return rng.random(self.m) >= self.p


@dataclasses.dataclass
class FixedCountStragglers(StragglerModel):
    """Exactly floor(pm) uniformly random stragglers (the |S| <= pm
    budget of Def I.3 with a random, non-adversarial S)."""

    m: int
    p: float

    def sample(self, rng: np.random.Generator) -> np.ndarray:
        # Clamp: p >= 1 (every machine straggling) must yield the
        # all-dead mask, not an over-sized choice() draw.
        s = min(int(np.floor(self.p * self.m)), self.m)
        alive = np.ones(self.m, dtype=bool)
        alive[rng.choice(self.m, size=s, replace=False)] = False
        return alive


@dataclasses.dataclass
class MarkovStragglers(StragglerModel):
    """Two-state Markov chain per machine with stationary straggle
    probability p and mean sojourn ``persistence`` steps: stagnant
    stragglers, matching the paper's cluster observation."""

    m: int
    p: float
    persistence: float = 10.0
    _state: Optional[np.ndarray] = None

    def sample(self, rng: np.random.Generator) -> np.ndarray:
        # Transition rates chosen so the stationary distribution is
        # (1-p, p) and the straggling state persists ~``persistence``.
        leave_straggle = 1.0 / self.persistence
        enter_straggle = leave_straggle * self.p / max(1.0 - self.p, 1e-9)
        if self._state is None:
            self._state = rng.random(self.m) < self.p  # True = straggling
        u = rng.random(self.m)
        nxt = np.where(self._state, u >= leave_straggle,
                       u < enter_straggle)
        self._state = nxt
        return ~nxt


@dataclasses.dataclass
class AdversarialStragglers(StragglerModel):
    """Def I.3 as a *process*: every step replays the worst-case
    |S| <= pm attack for the carried assignment (the adversary knows the
    scheme and has no reason to move). Wraps ``adversarial_mask`` so the
    attack plugs into the same ``sample(rng)`` protocol the stochastic
    models use; the RNG is accepted and ignored."""

    assignment: Assignment
    p: float
    _mask: Optional[np.ndarray] = None

    def sample(self, rng: np.random.Generator) -> np.ndarray:
        if self._mask is None:
            self._mask = adversarial_mask(self.assignment, self.p)
        return self._mask.copy()


# ---------------------------------------------------------------------------
# Adversarial attacks (Def I.3 instantiations)
# ---------------------------------------------------------------------------


def adversarial_mask_graph(assignment: Assignment, p: float) -> np.ndarray:
    """Worst-case-style attack on a graph scheme (Remark V.4): isolate
    floor(pm / d) vertices by straggling every edge incident to them,
    choosing greedily to respect the budget."""
    g = assignment.graph
    if g is None:
        raise ValueError("graph attack needs a graph assignment")
    budget = int(np.floor(p * g.m))
    inc = g.incident_edges()
    dead = np.zeros(g.m, dtype=bool)
    spent = 0
    # Greedy: repeatedly kill the vertex whose remaining live edges are
    # fewest (cheapest full isolation next).
    order = np.argsort([len(e) for e in inc])
    for v in order:
        cost = sum(1 for j in inc[v] if not dead[j])
        if spent + cost > budget:
            continue
        for j in inc[v]:
            dead[j] = True
        spent += cost
    # Spend any remainder arbitrarily (extra stragglers never help A).
    for j in range(g.m):
        if spent >= budget:
            break
        if not dead[j]:
            dead[j] = True
            spent += 1
    return ~dead


def adversarial_mask_frc(assignment: Assignment, p: float) -> np.ndarray:
    """Worst case for the FRC: straggle whole groups of d machines, each
    erasing one block entirely -- error pm/d blocks out of n = m/d,
    i.e. normalized error p (Table I)."""
    A = assignment.A
    n, m = A.shape
    budget = int(np.floor(p * m))
    alive = np.ones(m, dtype=bool)
    spent = 0
    for i in range(n):
        js = np.nonzero(A[i])[0]
        if spent + js.size > budget:
            break
        alive[js] = False
        spent += js.size
    return alive


def _mask_error(assignment: Assignment, alive: np.ndarray) -> float:
    """Normalized optimal-decoding error of one mask -- the objective
    the search attacks below maximise. Local import: ``decoding``
    imports this module's consumers."""
    from .decoding import decode, normalized_error

    return normalized_error(
        decode(assignment, alive, method="optimal").alpha)


def adversarial_mask_cyclic(assignment: Assignment, p: float) -> np.ndarray:
    """Attack portfolio for cyclic/shifted schemes (Raviv et al.):
    the worst straggler set is either a *consecutive window* (which
    fully erases window-minus-d+1 blocks once the budget exceeds the
    shift width -- the attack that breaks MDS-style cyclic codes) or
    an *arithmetic progression* (spread kills maximise per-block
    damage at small budgets). Both families are enumerated -- O(m)
    candidate masks, one decode each -- and the worst is returned;
    exact against the C(m, pm) brute-force oracle on every small-m
    case pinned in tests/test_adversarial_oracle.py."""
    m = assignment.m
    budget = int(np.floor(p * m))
    if budget == 0:
        return np.ones(m, dtype=bool)
    candidates = [[j % m for j in range(budget)]]  # consecutive window
    for stride in range(2, m // budget + 1):
        dead = [(j * stride) % m for j in range(budget)]
        if len(set(dead)) == budget:
            candidates.append(dead)
    best_mask, best_err = None, -1.0
    for dead in candidates:
        alive = np.ones(m, dtype=bool)
        alive[dead] = False
        e = _mask_error(assignment, alive)
        if e > best_err:
            best_mask, best_err = alive, e
    return best_mask


def adversarial_mask_bibd(assignment: Assignment, p: float) -> np.ndarray:
    """Marginal-error greedy attack for block-design schemes (Kadhe et
    al.): grow the straggler set one machine at a time, each round
    killing the machine whose removal maximises the realized decoding
    error. O(budget * m) decodes; exact against the brute-force
    oracle on every small design pinned in
    tests/test_adversarial_oracle.py (the pairwise balance that makes
    BIBDs adversarially strong also flattens the search landscape)."""
    m = assignment.m
    budget = int(np.floor(p * m))
    alive = np.ones(m, dtype=bool)
    for _ in range(budget):
        best_j, best_err = None, -1.0
        for j in np.nonzero(alive)[0]:
            alive[j] = False
            e = _mask_error(assignment, alive)
            alive[j] = True
            if e > best_err:
                best_j, best_err = j, e
        alive[best_j] = False
    return alive


def adversarial_mask(assignment: Assignment, p: float) -> np.ndarray:
    if assignment.graph is not None:
        return adversarial_mask_graph(assignment, p)
    if assignment.name.startswith("frc"):
        return adversarial_mask_frc(assignment, p)
    if assignment.name.startswith("cyclic_mds"):
        return adversarial_mask_cyclic(assignment, p)
    if assignment.name.startswith("bibd"):
        return adversarial_mask_bibd(assignment, p)
    # Generic greedy: kill machines covering the rarest blocks first.
    A = assignment.A
    m = A.shape[1]
    budget = int(np.floor(p * m))
    replication = A.sum(axis=1)
    machine_score = (A / np.maximum(replication[:, None], 1)).sum(axis=0)
    order = np.argsort(-machine_score)
    alive = np.ones(m, dtype=bool)
    alive[order[:budget]] = False
    return alive
