"""The port's failure detector and chaos injector against the reference's.

``repro_torch.dist.failures`` and ``repro_torch.dist.chaos`` are copies
of plain-Python reference modules, so every pin here is bit for bit:
the same heartbeat times go through both monitors and must give the
same masks, event lists (``to_json``), ``steps_to_detect``, dead
machines and deadlines; both injectors must give the same completion
times from one (spec, seed). Mirrors ``tests/test_failures.py`` test for
test where it applies.
"""

import numpy as np
import pytest

from repro.dist import chaos as rchaos
from repro.dist import failures as rfail
from repro_torch.configs import CodingConfig
from repro_torch.core import step_weights as sw
from repro_torch.dist import chaos as tchaos
from repro_torch.dist import coded_train
from repro_torch.dist import failures as tfail


def _monitors(m=4, **kw):
    kw.setdefault("deadline", 1.0)
    kw.setdefault("dead_after", 3)
    return rfail.HeartbeatMonitor(m, **kw), tfail.HeartbeatMonitor(m, **kw)


def _observe_both(mons, step, times):
    """One step through both monitors; the masks and the new events
    must be equal. Returns the port's mask."""
    r, t = mons
    a_r = r.observe(step, np.array(times, dtype=np.float64))
    a_t = t.observe(step, np.array(times, dtype=np.float64))
    np.testing.assert_array_equal(a_t, a_r)
    assert a_t.dtype == a_r.dtype
    assert tfail.events_to_json(t.drain_events()) == \
        rfail.events_to_json(r.drain_events())
    return a_t


def _assert_same(mons):
    r, t = mons
    assert tfail.events_to_json(t.events) == rfail.events_to_json(r.events)
    assert t.steps_to_detect() == r.steps_to_detect()
    np.testing.assert_array_equal(t.dead_machines, r.dead_machines)
    assert t.dead_at == r.dead_at and t.state == r.state
    np.testing.assert_array_equal(t.misses, r.misses)
    for j in range(r.m):
        assert t.current_deadline(j) == r.current_deadline(j)


# ------------------------------------------------------ HeartbeatMonitor

def test_all_on_time_all_alive_no_events():
    mons = _monitors()
    for step in range(5):
        assert _observe_both(mons, step, np.full(4, 0.5)).all()
    _assert_same(mons)
    assert mons[1].events == [] and mons[1].steps_to_detect() == {}


def test_miss_is_excluded_immediately_even_within_grace():
    mons = _monitors(grace=2)
    times = np.full(4, 0.5)
    times[2] = np.inf
    alive = _observe_both(mons, 0, times)
    assert not alive[2] and alive[[0, 1, 3]].all()
    _assert_same(mons)
    assert mons[1].events == []


def test_straggle_after_grace_backoff_cap_and_recovery():
    mons = _monitors(grace=1, backoff=2.0, max_backoff=4, dead_after=10)
    times = np.full(4, 0.5)
    times[1] = 5.0                      # late, not absent
    gone = times.copy()
    gone[1] = np.inf
    stream = [times, times] + [gone] * 6 + [times]
    for step, t in enumerate(stream):
        _observe_both(mons, step, t)
        _assert_same(mons)
    kinds = [e.kind for e in mons[1].events]
    assert kinds == ["straggle", "recover"]
    assert mons[1].current_deadline(1) == 1.0


def test_dead_after_k_misses_stays_dead_and_ignores_zombies():
    mons = _monitors(dead_after=3)
    dead_t = np.full(4, 0.5)
    dead_t[0] = np.nan                  # nan == no heartbeat
    for step in range(3):
        assert not _observe_both(mons, step, dead_t)[0]
    alive = _observe_both(mons, 3, np.full(4, 0.1))
    assert not alive[0] and alive[1:].all()
    _assert_same(mons)
    assert mons[1].steps_to_detect() == {0: 3}
    assert mons[1].dead_machines.tolist() == [0]


def test_recovery_interrupts_death_countdown():
    mons = _monitors(dead_after=3)
    miss = np.full(4, 0.5)
    miss[2] = np.inf
    for step, t in enumerate([miss, miss, np.full(4, 0.5), miss, miss]):
        _observe_both(mons, step, t)
    _assert_same(mons)
    assert not mons[1].is_dead(2)


@pytest.mark.parametrize("seed", range(6))
def test_random_heartbeats_give_identical_ledgers(seed):
    """Seeded streams of on-time, late, missing and nan reports at
    random deadlines, grace and dead_after."""
    rng = np.random.default_rng(seed)
    m = int(rng.integers(2, 9))
    mons = _monitors(m, deadline=float(rng.uniform(0.3, 1.5)),
                     grace=int(rng.integers(0, 3)),
                     dead_after=int(rng.integers(1, 6)),
                     backoff=float(rng.uniform(1.0, 3.0)),
                     max_backoff=int(rng.integers(0, 5)))
    for step in range(40):
        times = rng.exponential(0.6, m)
        times[rng.random(m) < 0.15] = np.inf
        times[rng.random(m) < 0.05] = np.nan
        _observe_both(mons, step, times)
    _assert_same(mons)


def test_monitor_validation_matches_reference():
    for kw in (dict(m=0), dict(m=4, deadline=0.0),
               dict(m=4, backoff=0.5), dict(m=4, dead_after=0)):
        with pytest.raises(ValueError):
            rfail.HeartbeatMonitor(**kw)
        with pytest.raises(ValueError):
            tfail.HeartbeatMonitor(**kw)
    with pytest.raises(ValueError):
        _monitors()[1].observe(0, np.zeros(3))


def test_events_serialize_to_plain_json_types():
    mons = _monitors(grace=0, dead_after=2)
    t = np.full(4, 0.5)
    t[3] = np.inf
    _observe_both(mons, 0, t)
    _observe_both(mons, 1, t)
    out = tfail.events_to_json(mons[1].events)
    assert [e["kind"] for e in out] == ["straggle", "dead"]
    for e in out:
        assert isinstance(e["step"], int)
        assert isinstance(e["machine"], int)
        assert all(not isinstance(v, np.generic)
                   for v in e["detail"].values())
    ev = tfail.FailureEvent(2, "reassign", -1,
                            {"survivors": np.arange(3)})
    assert ev.to_json() == rfail.FailureEvent(
        2, "reassign", -1, {"survivors": np.arange(3)}).to_json()


# ----------------------------------------------------------- SurvivorMap

def test_survivor_map_remove_and_localize():
    r, t = rfail.SurvivorMap(5), tfail.SurvivorMap(5)
    for s in (r, t):
        s.remove([1, 3])
    np.testing.assert_array_equal(t.survivors, r.survivors)
    assert t.survivors.tolist() == [0, 2, 4] and t.alive_count == 3
    mask = np.array([True, False, False, True, True])
    np.testing.assert_array_equal(t.localize(mask), r.localize(mask))
    with pytest.raises(ValueError):
        t.remove([1])                   # already gone
    with pytest.raises(ValueError):
        t.localize(np.ones(3, dtype=bool))


# ------------------------------------------------- chaos spec + injector

SPECS = ("kill:1@3; rack:0,2@5; delay:3@4-8:20; flap:2@6-12:2",
         "delay:0@1-2;flap:1@1-3", "kill:2@4", "rack:0,1@2;kill:0@1")


def _events(evs):
    return [(e.kind, e.machines, e.start, e.end, e.magnitude) for e in evs]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_chaos_spec_equals_reference(spec):
    assert _events(tchaos.parse_chaos_spec(spec, m=4)) == \
        _events(rchaos.parse_chaos_spec(spec, m=4))


@pytest.mark.parametrize("bad", ["explode:1@3", "kill:9@3", "delay:0@5-5",
                                 "kill:x@3", "flap:1@3"])
def test_parse_chaos_spec_rejects_as_the_reference(bad):
    with pytest.raises(ValueError) as want:
        rchaos.parse_chaos_spec(bad, m=4)
    with pytest.raises(ValueError) as got:
        tchaos.parse_chaos_spec(bad, m=4)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed,m,steps,n", [(3, 6, 20, 4), (0, 2, 5, 3),
                                            (11, 9, 40, 6)])
def test_random_schedule_equals_reference(seed, m, steps, n):
    got = tchaos.random_schedule(m, steps, seed=seed, n_events=n)
    assert _events(got) == _events(rchaos.random_schedule(
        m, steps, seed=seed, n_events=n))
    assert sum(e.kind == "kill" for e in got) <= 1


@pytest.mark.parametrize("spec", SPECS)
def test_injector_times_equal_reference(spec):
    r = rchaos.ChaosInjector(rchaos.parse_chaos_spec(spec, 4), 4, seed=7)
    t = tchaos.ChaosInjector(tchaos.parse_chaos_spec(spec, 4), 4, seed=7)
    for step in range(14):
        np.testing.assert_array_equal(t.completion_times(step),
                                      r.completion_times(step))
        np.testing.assert_array_equal(t.killed(step), r.killed(step))


def test_injector_feeds_monitor_as_the_reference():
    """Injected kill -> missed heartbeats -> straggle -> dead, through
    both packages, with detection after dead_after steps."""
    inj = [mod.ChaosInjector(mod.parse_chaos_spec("kill:2@4;delay:0@1-3",
                                                  4), 4, seed=0)
           for mod in (rchaos, tchaos)]
    mons = _monitors(deadline=0.5, dead_after=3)
    for step in range(10):
        times = [i.completion_times(step) for i in inj]
        np.testing.assert_array_equal(times[1], times[0])
        _observe_both(mons, step, times[1])
    _assert_same(mons)
    assert mons[1].dead_machines.tolist() == [2]
    assert mons[1].steps_to_detect() == {2: 3}
    assert mons[1].dead_at[2] == 6


# --------------------------------------------- the runtime's mask sources

def test_runtime_weights_from_observed_masks():
    cfg = CodingConfig(scheme="expander", replication=2, seed=0)
    rt = coded_train.CodingRuntime(cfg, 4, device="cpu",
                                   mask_source=sw.ObservedMaskSource(4))
    alive_in = np.array([True, False, True, True])
    rt.mask_source.push(alive_in)
    w, alive = rt.step_weights()
    np.testing.assert_array_equal(alive, alive_in)
    assert w.shape == (4,) and w[1] == 0.0
    assert np.isfinite(w).all() and w[alive_in].sum() > 0
    with pytest.raises(ValueError):
        coded_train.CodingRuntime(cfg, 4, device="cpu",
                                  mask_source=sw.ObservedMaskSource(5))


def test_dead_machine_stream_keeps_weights_zero_and_finite():
    cfg = CodingConfig(scheme="expander", replication=2, seed=2)
    masks = np.ones((6, 4), dtype=bool)
    masks[:, 3] = False                 # machine 3 dead all run
    rt = coded_train.CodingRuntime(
        cfg, 4, device="cpu", mask_source=sw.ReplayedMaskSource(masks))
    for _ in range(6):
        w, _ = rt.step_weights()
        assert w[3] == 0.0 and np.isfinite(w).all()
    assert np.isfinite(rt.scale)


def test_adversarial_budget_past_survivors_after_shrink():
    cfg = CodingConfig(scheme="expander", replication=2,
                       straggler_model="adversarial", straggler_p=0.9,
                       seed=1)
    rt1 = coded_train.elastic_reassign(
        coded_train.CodingRuntime(cfg, 6, device="cpu"), [4],
        generation=1)
    mask = rt1.model.sample(np.random.default_rng(0))
    assert rt1.m == 5 and mask.shape == (5,)
    w = rt1.weights_for(mask)
    assert np.isfinite(w).all() and (w[~mask] == 0).all()
    assert np.isfinite(rt1.scale) and rt1.scale > 0
