"""The port's ``CodingRuntime`` against the reference's, on the CPU.

Everything here is host NumPy in both packages, so every pin is bit for
bit: the debias scale (including the m >= 782 batch that reaches the
torch label propagator's work threshold), the assignments of the scheme
zoo, and the per-step masks, weights, decisions and straggler estimates
of seeded streams under each adaptive policy. Mirrors the runtime parts
of ``tests/test_coding_runtime.py``, ``tests/test_adaptive.py`` and
``tests/test_scheme_zoo.py``.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import repro.core.step_weights as rsw
from repro.configs import CodingConfig as RCoding
from repro.core import expander_assignment as r_expander
from repro.dist import coded_train as RT
from repro_torch.configs import CodingConfig as TCoding
from repro_torch.core import step_weights as tsw
from repro_torch.core.assignment import expander_assignment as t_expander
from repro_torch.dist import coded_train as TT

CPU = "cpu"
# (scheme, m, replication): one machine count each scheme builds at
ZOO = (("expander", 12, 3), ("frc", 12, 3), ("uncoded", 12, 1),
       ("cyclic_mds", 12, 3), ("bibd", 6, 3), ("random_regular", 12, 3))
POLICIES = (None, "adaptive", "always_optimal", "always_fixed")


def _pair(m, runtime=None, **cfg):
    """(reference runtime, port runtime) on one CodingConfig."""
    extra = runtime or {}
    return (RT.CodingRuntime(RCoding(**cfg), m, **extra),
            TT.CodingRuntime(TCoding(**cfg), m, device=CPU, **extra))


# ------------------------------------------------------------------ C1

def test_debias_scale_at_m1000_equals_reference_on_the_host():
    """Fault C1: 1000 x 256 mask entries reach the propagator's work
    threshold; device="cpu" keeps the decode on the host."""
    want = rsw.debias_scale_mc(r_expander(1000, 2, vertex_transitive=True,
                                          seed=0),
                               p=0.2, trials=256, seed=0x5EED)
    A = t_expander(1000, 2, vertex_transitive=True, seed=0)
    got = tsw.debias_scale_mc(A, p=0.2, trials=256, seed=0x5EED,
                              device=CPU)
    assert got == want
    assert tsw.debias_scale_mc(A, p=0.2, trials=256, seed=0x5EED,
                               backend="torch", device=CPU) == want
    assert tsw.debias_scale_mc(A, p=0.2, trials=256, seed=0x5EED,
                               backend="numpy") == want


def test_runtime_scale_at_m1000_equals_reference_on_the_host():
    cfg = dict(scheme="expander", replication=2, straggler_p=0.2)
    want = RT.CodingRuntime(RCoding(**cfg), 1000).scale
    rt = TT.CodingRuntime(TCoding(**cfg), 1000, device=CPU)
    assert rt.scale == want
    assert rt.device == CPU


def test_runtime_without_a_card_needs_the_host_device(monkeypatch):
    """device=None means the card: at m = 1000 the debias batch asks for
    it, and raises without one rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        TT.CodingRuntime(TCoding(scheme="expander", replication=2,
                                 straggler_p=0.2), 1000)


# ------------------------------------------------------ the scheme zoo

@pytest.mark.parametrize("scheme,m,d", ZOO + (("bibd", 7, 3),
                                              ("bibd", 13, 4),
                                              ("cyclic_mds", 4, 2),
                                              ("random_regular", 8, 2)))
def test_make_assignment_equals_reference(scheme, m, d):
    a_r = RT.make_assignment(RCoding(scheme=scheme, replication=d,
                                     seed=2), m)
    a_t = TT.make_assignment(TCoding(scheme=scheme, replication=d,
                                     seed=2), m)
    assert (a_t.m, a_t.n, a_t.name) == (a_r.m, a_r.n, a_r.name)
    np.testing.assert_array_equal(a_t.A, a_r.A)


def test_make_assignment_rejects_an_unknown_scheme():
    with pytest.raises(ValueError, match="unknown scheme"):
        TT.make_assignment(TCoding(scheme="lattice", replication=2), 4)


# ------------------------------------------- per-step streams, bitwise

def _assert_same_state(rt_r, rt_t):
    assert rt_t.scale == rt_r.scale
    assert rt_t.decode_calls == rt_r.decode_calls
    assert rt_t.steps_sampled == rt_r.steps_sampled
    assert rt_t.decision_counts == rt_r.decision_counts
    if rt_r.policy is None:
        assert rt_t.policy is None
        return
    e_r, e_t = rt_r.estimator.estimate(), rt_t.estimator.estimate()
    assert (e_t.p_hat, e_t.persistence_hat, e_t.steps) == \
        (e_r.p_hat, e_r.persistence_hat, e_r.steps)
    np.testing.assert_array_equal(e_t.transition_hat, e_r.transition_hat)
    d_r, d_t = rt_r.last_decision, rt_t.last_decision
    assert (d_t.method, d_t.p, d_t.lookahead) == \
        (d_r.method, d_r.p, d_r.lookahead)
    assert rt_t.suggested_lookahead() == rt_r.suggested_lookahead()


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("scheme,m,d", ZOO)
def test_step_stream_equals_reference(scheme, m, d, policy):
    model = "markov" if policy else "bernoulli"
    rt_r, rt_t = _pair(m, scheme=scheme, replication=d, straggler_p=0.2,
                       straggler_model=model, seed=5,
                       runtime=dict(adaptive=policy))
    for _ in range(30):
        w_r, a_r = rt_r.step_weights()
        w_t, a_t = rt_t.step_weights()
        np.testing.assert_array_equal(a_t, a_r)
        assert w_t.dtype == w_r.dtype == np.float32
        np.testing.assert_array_equal(w_t, w_r)
        np.testing.assert_array_equal(rt_t.block_weights(w_t),
                                      rt_r.block_weights(w_r))
    _assert_same_state(rt_r, rt_t)


@pytest.mark.parametrize("policy", POLICIES)
def test_lookahead_equals_reference_and_per_step(policy):
    kw = dict(scheme="expander", replication=4, straggler_p=0.15,
              straggler_model="markov", seed=3,
              runtime=dict(adaptive=policy))
    rt_r, rt_t = _pair(12, **kw)
    _, per_step = _pair(12, **kw)
    for _ in range(4):
        W_r, A_r = rt_r.weights_lookahead(5)
        W_t, A_t = rt_t.weights_lookahead(5)
        np.testing.assert_array_equal(A_t, A_r)
        np.testing.assert_array_equal(W_t, W_r)
        for w, a in zip(W_t, A_t):
            w1, a1 = per_step.step_weights()
            np.testing.assert_array_equal(a1, a)
            np.testing.assert_array_equal(w1, w)
    _assert_same_state(rt_r, rt_t)
    assert per_step.decision_counts == rt_t.decision_counts


def test_always_optimal_is_bit_identical_to_no_policy():
    kw = dict(scheme="expander", replication=4, straggler_p=0.15,
              straggler_model="markov", seed=3)
    plain = TT.CodingRuntime(TCoding(**kw), 12, device=CPU)
    anchored = TT.CodingRuntime(TCoding(**kw), 12, device=CPU,
                                adaptive="always_optimal")
    assert plain.scale == anchored.scale
    for _ in range(25):
        w1, a1 = plain.step_weights()
        w2, a2 = anchored.step_weights()
        np.testing.assert_array_equal(a1, a2)
        np.testing.assert_array_equal(w1, w2)
    W1, _ = plain.weights_lookahead(6)
    W2, _ = anchored.weights_lookahead(6)
    np.testing.assert_array_equal(W1, W2)
    assert plain.decode_calls == anchored.decode_calls


def test_adaptive_settles_on_optimal_and_counts_decisions():
    rt = TT.CodingRuntime(TCoding(scheme="expander", replication=4,
                                  straggler_model="markov",
                                  straggler_p=0.25, seed=3), 12,
                          device=CPU, adaptive="adaptive")
    for _ in range(40):
        w, alive = rt.step_weights()
        assert np.all(w[~alive] == 0)
    assert sum(rt.decision_counts.values()) == 40
    assert rt.decision_counts["optimal"] > 30
    assert 0.0 < rt.estimator.estimate().p_hat < 1.0


def test_cache_keys_separate_methods_as_the_reference():
    rt_r, rt_t = _pair(12, scheme="expander", replication=4, seed=3,
                       straggler_p=0.15)
    mask = np.array([True] * 10 + [False] * 2)
    for rt in (rt_r, rt_t):
        w_opt = rt.weights_for(mask, method="optimal")
        w_fix = rt.weights_for(mask, method="fixed", p=0.25)
        assert rt.decode_calls == 2 and not np.array_equal(w_opt, w_fix)
        rt.weights_for(mask, method="fixed", p=0.25)
        assert rt.decode_calls == 2
    np.testing.assert_array_equal(rt_t.weights_for(mask, method="fixed",
                                                   p=0.25),
                                  rt_r.weights_for(mask, method="fixed",
                                                   p=0.25))
    np.testing.assert_array_equal(rt_t.weights_for(mask),
                                  rt_r.weights_for(mask))


def test_prefetcher_under_a_policy_equals_per_step():
    kw = dict(scheme="cyclic_mds", replication=2, straggler_p=0.2,
              straggler_model="markov", seed=1)
    fetched = TT.CodingRuntime(TCoding(**kw), 4, device=CPU,
                               adaptive="adaptive")
    per_step = TT.CodingRuntime(TCoding(**kw), 4, device=CPU,
                                adaptive="adaptive")
    with ThreadPoolExecutor(max_workers=1) as pool:
        pre = TT.LookaheadPrefetcher(fetched, pool, 3, 11)
        for _ in range(11):
            w, a = pre.next()
            w1, a1 = per_step.step_weights()
            np.testing.assert_array_equal(a, a1)
            np.testing.assert_array_equal(w, w1)
    assert fetched.decision_counts == per_step.decision_counts


def test_adversarial_scale_equals_reference():
    rt_r, rt_t = _pair(12, scheme="expander", replication=3, seed=1,
                       straggler_model="adversarial", straggler_p=0.25,
                       runtime=dict(adaptive="adaptive"))
    assert rt_t.scale == rt_r.scale
    for _ in range(5):
        w_r, _ = rt_r.step_weights()
        w_t, _ = rt_t.step_weights()
        np.testing.assert_array_equal(w_t, w_r)
