"""Chaos mode: seeded virtual failures for the heartbeat pipeline.

Copy of ``repro.dist.chaos`` (plain Python and NumPy). Under ``--chaos``
the straggler masks are not sampled: the per-machine completion times a
cluster would report are simulated, with faults from a seeded schedule,
and ``failures.HeartbeatMonitor`` derives the masks by deadline, as it
would from real heartbeats.

Spec (``--chaos <spec>``, events separated by semicolons, machine ids
are original ids on the starting m machines)::

    kill:J@S            machine J dies for good at step S
    rack:J,K,...@S      every listed machine dies at step S
    delay:J@S-E[:X]     machine J's completion time is multiplied by X
                        (default 10) for S <= step < E
    flap:J@S-E[:K]      machine J alternates K steps dark and K steps
                        healthy (default K=1) for S <= step < E

Example: ``kill:1@3;delay:2@5-8:20;flap:0@4-12:2``.

``random_schedule(m, steps, seed)`` draws a seeded mix of these.
``ChaosInjector`` turns a schedule into per-step (m,) times: healthy
machines report ``base_time`` plus seeded jitter, delayed ones scaled
times, killed or dark ones ``inf``. All randomness is one
``default_rng`` stream consumed in step order, so a run is reproducible
from (spec, seed).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

KINDS = ("kill", "rack", "delay", "flap")


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One scheduled fault. ``end`` is exclusive; permanent faults
    (kill/rack) carry ``end=None``. ``magnitude`` is the delay factor
    for ``delay`` and the dark/healthy period for ``flap``."""

    kind: str
    machines: Tuple[int, ...]
    start: int
    end: int = None
    magnitude: float = 0.0

    def active(self, step: int) -> bool:
        if step < self.start:
            return False
        return self.end is None or step < self.end


def _parse_window(text: str) -> Tuple[int, int]:
    lo, _, hi = text.partition("-")
    start, end = int(lo), int(hi)
    if end <= start:
        raise ValueError(f"empty chaos window {text!r}")
    return start, end


def parse_chaos_spec(spec: str, m: int) -> List[ChaosEvent]:
    """Parse ``--chaos`` spec text into a validated event list."""
    events = []
    for part in filter(None, (s.strip() for s in spec.split(";"))):
        try:
            kind, _, rest = part.partition(":")
            body, _, when = rest.partition("@")
            if kind in ("kill", "rack"):
                machines = tuple(int(j) for j in body.split(","))
                events.append(ChaosEvent(kind, machines, int(when)))
            elif kind == "delay":
                when, _, mag = when.partition(":")
                start, end = _parse_window(when)
                events.append(ChaosEvent(
                    kind, (int(body),), start, end,
                    float(mag) if mag else 10.0))
            elif kind == "flap":
                when, _, period = when.partition(":")
                start, end = _parse_window(when)
                events.append(ChaosEvent(
                    kind, (int(body),), start, end,
                    float(int(period)) if period else 1.0))
            else:
                raise ValueError(f"unknown chaos kind {kind!r} "
                                 f"(known: {KINDS})")
        except ValueError as e:
            raise ValueError(f"bad chaos event {part!r}: {e}") from e
    for ev in events:
        for j in ev.machines:
            if not 0 <= j < m:
                raise ValueError(f"chaos machine {j} out of range "
                                 f"for m={m}")
    return events


def random_schedule(m: int, steps: int, seed: int = 0, *,
                    n_events: int = 3) -> List[ChaosEvent]:
    """A seeded mixed schedule for soak/fuzz runs: at most one kill
    (keep a decodable majority), the rest transient delays and flaps
    spread over the run."""
    rng = np.random.default_rng(seed)
    events: List[ChaosEvent] = []
    machines = rng.permutation(m)
    for i in range(n_events):
        j = int(machines[i % m])
        start = int(rng.integers(1, max(2, steps - 2)))
        if i == 0 and m > 2:
            events.append(ChaosEvent("kill", (j,), start))
            continue
        end = int(min(steps, start + rng.integers(2, 5)))
        if rng.random() < 0.5:
            events.append(ChaosEvent("delay", (j,), start, end,
                                     float(rng.integers(5, 30))))
        else:
            events.append(ChaosEvent("flap", (j,), start, end, 1.0))
    return events


@dataclasses.dataclass
class ChaosInjector:
    """Schedule -> per-step virtual heartbeat timestamps.

    ``completion_times(step)`` returns the (m,) vector of seconds each
    *original* machine took this step: ``base_time`` + seeded jitter
    when healthy, scaled by the delay factor under an active ``delay``
    window, ``inf`` when killed or in a flap's dark phase. The jitter
    draw happens for every machine every step (dead included), so the
    stream a given (spec, seed) produces is independent of detection
    timing -- reproducibility the differential tests rely on.
    """

    schedule: List[ChaosEvent]
    m: int
    base_time: float = 0.1
    jitter: float = 0.2
    seed: int = 0

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed + 0xC4A05)
        self._killed_at = {}
        for ev in self.schedule:
            if ev.kind in ("kill", "rack"):
                for j in ev.machines:
                    self._killed_at[j] = min(
                        ev.start, self._killed_at.get(j, ev.start))

    def killed(self, step: int) -> np.ndarray:
        """(m,) bool: machines whose kill step has passed."""
        out = np.zeros(self.m, dtype=bool)
        for j, s in self._killed_at.items():
            out[j] = step >= s
        return out

    def completion_times(self, step: int) -> np.ndarray:
        times = self.base_time * (
            1.0 + self.jitter * self.rng.random(self.m))
        for ev in self.schedule:
            if not ev.active(step):
                continue
            for j in ev.machines:
                if ev.kind in ("kill", "rack"):
                    times[j] = np.inf
                elif ev.kind == "delay":
                    times[j] *= ev.magnitude
                elif ev.kind == "flap":
                    period = max(1, int(ev.magnitude))
                    dark = ((step - ev.start) // period) % 2 == 0
                    if dark:
                        times[j] = np.inf
        return times
