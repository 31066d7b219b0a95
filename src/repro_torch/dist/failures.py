"""Failure detection: per-step machine heartbeats -> observed masks.

Copy of ``repro.dist.failures`` (plain Python and NumPy). Each of the m
coded workers reports a completion time for every train step (its
heartbeat), and ``HeartbeatMonitor`` turns those times into the round's
alive mask by deadline:

* a report within the machine's current deadline: alive this round;
* a late or missing report is a **miss**: the machine is left out of
  this round's combine, and its next deadline grows by an exponential
  backoff factor;
* the first ``grace`` consecutive misses raise no ``straggle`` event,
  though they always leave the machine out of the mask;
* ``dead_after`` consecutive misses declare the machine **dead**: left
  out for good, its heartbeats ignored from then on. The ``dead`` event
  is what triggers the elastic re-assignment
  (``coded_train.elastic_reassign``).

The monitor is a ledger over (step, times): it neither sleeps nor
threads, so the chaos harness's virtual times (``dist.chaos``) and a
real cluster's reported ones go through the same code. Every state
change is a ``FailureEvent``, which the train summary's ``chaos`` object
aggregates (steps to detect, death steps). ``SurvivorMap`` maps original
machine ids to the current generation's logical ones.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

# Machine states the monitor tracks (per original machine id).
OK, STRAGGLING, DEAD = "ok", "straggling", "dead"


@dataclasses.dataclass(frozen=True)
class FailureEvent:
    """One observed state transition, as the event log records it.

    ``kind``: ``straggle`` (consecutive misses exceeded the grace
    allowance), ``recover`` (a heartbeat landed after misses),
    ``dead`` (``dead_after`` consecutive misses -- permanent),
    ``reassign`` (elastic re-draw; emitted by the driver, not the
    monitor, with the surviving-machine detail).
    """

    step: int
    kind: str
    machine: int
    detail: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return {"step": int(self.step), "kind": self.kind,
                "machine": int(self.machine),
                "detail": {k: (v.tolist() if isinstance(v, np.ndarray)
                               else v) for k, v in self.detail.items()}}


@dataclasses.dataclass
class HeartbeatMonitor:
    """Per-step, per-machine heartbeat ledger -> observed alive masks.

    ``deadline`` is the base per-step completion budget (same unit as
    the reported timestamps); a machine with ``k`` consecutive misses
    is next judged against ``deadline * backoff**k`` (capped at
    ``max_backoff`` doublings). ``grace`` consecutive misses are
    tolerated before a ``straggle`` event is emitted; ``dead_after``
    consecutive misses declare the machine dead for good. Missing
    heartbeats are reported as ``np.inf`` (or ``nan``) timestamps.
    """

    m: int
    deadline: float = 1.0
    backoff: float = 2.0
    max_backoff: int = 4
    grace: int = 1
    dead_after: int = 3

    def __post_init__(self):
        if self.m < 1:
            raise ValueError("m must be >= 1")
        if self.deadline <= 0:
            raise ValueError("deadline must be positive")
        if self.backoff < 1.0:
            raise ValueError("backoff must be >= 1")
        if self.dead_after < 1:
            raise ValueError("dead_after must be >= 1")
        self.misses = np.zeros(self.m, dtype=np.int64)
        self.state = [OK] * self.m
        self.dead_at: Dict[int, int] = {}     # machine -> death step
        self.first_miss: Dict[int, int] = {}  # machine -> run start
        self.events: List[FailureEvent] = []
        self._drained = 0

    def current_deadline(self, j: int) -> float:
        """Machine j's deadline for the next report, after backoff."""
        k = min(int(self.misses[j]), self.max_backoff)
        return self.deadline * self.backoff ** k

    def is_dead(self, j: int) -> bool:
        return self.state[j] == DEAD

    @property
    def dead_machines(self) -> np.ndarray:
        return np.array(sorted(self.dead_at), dtype=np.int64)

    def observe(self, step: int, times: np.ndarray) -> np.ndarray:
        """Record one step's heartbeats; return the observed mask.

        ``times`` is (m,) seconds-per-machine for this step (``inf`` /
        ``nan`` = no heartbeat arrived). Returns the (m,) alive mask
        this round's combine should decode around: True only for
        machines whose report beat their current (backoff-scaled)
        deadline. Dead machines stay False forever; their timestamps
        are ignored (a revived process must re-register as a new
        machine -- consistent with elastic re-assignment having
        already re-drawn the code without it).
        """
        times = np.asarray(times, dtype=np.float64)
        if times.shape != (self.m,):
            raise ValueError(f"times must be ({self.m},), "
                             f"got {times.shape}")
        alive = np.zeros(self.m, dtype=bool)
        for j in range(self.m):
            if self.state[j] == DEAD:
                continue
            t = times[j]
            on_time = np.isfinite(t) and t <= self.current_deadline(j)
            if on_time:
                if self.misses[j]:
                    self.events.append(FailureEvent(
                        step, "recover", j,
                        {"missed_steps": int(self.misses[j])}))
                self.misses[j] = 0
                self.state[j] = OK
                self.first_miss.pop(j, None)
                alive[j] = True
                continue
            # A miss: excluded from this round's combine regardless of
            # grace -- grace only delays the *event*, never widens the
            # mask (a machine that did not report has no gradient).
            self.first_miss.setdefault(j, step)
            self.misses[j] += 1
            if self.misses[j] == self.grace + 1 and \
                    self.state[j] == OK:
                self.state[j] = STRAGGLING
                self.events.append(FailureEvent(
                    step, "straggle", j,
                    {"deadline": float(self.current_deadline(j)),
                     "since_step": int(self.first_miss[j])}))
            if self.misses[j] >= self.dead_after:
                self.state[j] = DEAD
                self.dead_at[j] = step
                self.events.append(FailureEvent(
                    step, "dead", j,
                    {"since_step": int(self.first_miss[j]),
                     "steps_to_detect":
                         int(step - self.first_miss[j] + 1)}))
        return alive

    def drain_events(self) -> List[FailureEvent]:
        """Events appended since the last drain (the driver's per-step
        poll; the full history stays in ``.events``)."""
        new = self.events[self._drained:]
        self._drained = len(self.events)
        return new

    def steps_to_detect(self) -> Dict[int, int]:
        """machine -> steps from first miss to declared dead, for every
        machine that died (the BENCH chaos-row detection metric)."""
        out = {}
        for ev in self.events:
            if ev.kind == "dead":
                out[ev.machine] = ev.detail["steps_to_detect"]
        return out


def events_to_json(events) -> list:
    """Serialize a FailureEvent list for the summary / artifact log."""
    return [ev.to_json() for ev in events]


@dataclasses.dataclass
class SurvivorMap:
    """Original machine ids <-> current logical machine indices.

    The heartbeat monitor and the chaos injector speak *original*
    machine ids for the whole run; after an elastic re-assignment the
    coding runtime's m' logical machines are the survivors in original-
    id order. This map does the bookkeeping both ways and shrinks as
    machines die.
    """

    m: int

    def __post_init__(self):
        self.survivors = np.arange(self.m, dtype=np.int64)

    @property
    def alive_count(self) -> int:
        return int(self.survivors.size)

    def remove(self, dead) -> np.ndarray:
        """Drop original ids in ``dead``; returns the new survivors."""
        dead = set(int(d) for d in np.atleast_1d(dead))
        unknown = dead - set(self.survivors.tolist())
        if unknown:
            raise ValueError(f"machines {sorted(unknown)} are not "
                             "current survivors")
        self.survivors = np.array(
            [j for j in self.survivors if int(j) not in dead],
            dtype=np.int64)
        return self.survivors

    def localize(self, mask: np.ndarray) -> np.ndarray:
        """(m_original,) observed mask -> (m_current,) logical mask."""
        mask = np.asarray(mask, dtype=bool)
        if mask.shape != (self.m,):
            raise ValueError(f"mask must be ({self.m},), "
                            f"got {mask.shape}")
        return mask[self.survivors]
