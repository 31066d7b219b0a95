"""The port's elastic re-assignment against the reference's, on the CPU.

``elastic_seed``, ``elastic_coding`` and ``elastic_reassign`` are host
NumPy in both packages: the generation codings, the re-drawn assignment
matrices and the debias scales are pinned bit for bit, chained over two
generations. Within the port, the trajectory after a death is
bit-identical to a fresh run launched on the survivors from the same
state (the reference's ``tests/test_elastic.py`` pin, on the torch
step, under ``torch.use_deterministic_algorithms``: without it a CPU
reduction in the backward pass may change order between runs). Mirrors
``tests/test_elastic.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import CodingConfig as RCoding
from repro.dist import coded_train as RT
from repro_torch import tree as T
from repro_torch.configs import CodingConfig as TCoding, get_config
from repro_torch.core import step_weights as sw
from repro_torch.data.pipeline import CodedBatcher, SyntheticLM
from repro_torch.dist import coded_train as TT
from repro_torch.models import model as M
from repro_torch.optim import optimizers as opt_mod

CPU = "cpu"
SCHEMES = ("expander", "frc", "uncoded", "cyclic_mds", "random_regular")


def _coding(cls, **kw):
    kw.setdefault("scheme", "expander")
    kw.setdefault("replication", 2)
    kw.setdefault("seed", 0)
    return cls(**kw)


def _fields(c):
    return dataclasses.asdict(c)


# ------------------------------------------- elastic_seed / elastic_coding

def test_elastic_seed_equals_reference():
    for seed in (0, 7, 123):
        for g in range(6):
            assert TT.elastic_seed(seed, g) == RT.elastic_seed(seed, g)
    with pytest.raises(ValueError):
        TT.elastic_seed(7, -1)


@pytest.mark.parametrize("scheme", SCHEMES + ("bibd",))
@pytest.mark.parametrize("d", [2, 3, 4])
def test_elastic_coding_equals_reference(scheme, d):
    for m_new in range(1, 13):
        for g in (1, 2):
            got = TT.elastic_coding(_coding(TCoding, scheme=scheme,
                                            replication=d, seed=3),
                                    m_new, g)
            want = RT.elastic_coding(_coding(RCoding, scheme=scheme,
                                             replication=d, seed=3),
                                     m_new, g)
            assert _fields(got) == _fields(want)
    with pytest.raises(ValueError):
        TT.elastic_coding(_coding(TCoding), 0, 1)


def test_elastic_coding_degrades_replication():
    base = _coding(TCoding, replication=4)
    assert TT.elastic_coding(base, 6, 1).replication == 4
    assert TT.elastic_coding(base, 5, 1).replication == 2
    frc = _coding(TCoding, scheme="frc")
    assert TT.elastic_coding(frc, 5, 1).replication == 1
    solo = TT.elastic_coding(base, 1, 2)
    assert solo.scheme == "uncoded" and solo.replication == 1
    before = _fields(base)
    TT.elastic_coding(base, 3, 1)
    assert _fields(base) == before


# -------------------------------------------------------- elastic_reassign

@pytest.mark.parametrize("scheme,m,d,dead", [
    ("expander", 6, 2, ([2], [0])), ("expander", 12, 3, ([1, 5], [3])),
    ("frc", 6, 2, ([0], [4])), ("cyclic_mds", 6, 3, ([2], [1])),
    ("random_regular", 8, 2, ([6, 7], [0, 1])),
    ("uncoded", 4, 1, ([1], [0]))])
def test_reassign_chain_equals_reference(scheme, m, d, dead):
    cfg = dict(scheme=scheme, replication=d, straggler_p=0.2, seed=4)
    rt_r = RT.CodingRuntime(RCoding(**cfg), m)
    rt_t = TT.CodingRuntime(TCoding(**cfg), m, device=CPU)
    for g, ids in enumerate(dead, start=1):
        rt_r = RT.elastic_reassign(rt_r, ids, generation=g)
        rt_t = TT.elastic_reassign(rt_t, ids, generation=g)
        assert rt_t.m == rt_r.m
        assert _fields(rt_t.coding) == _fields(rt_r.coding)
        np.testing.assert_array_equal(rt_t.assignment.A, rt_r.assignment.A)
        assert rt_t.scale == rt_r.scale
        assert rt_t.device == CPU
        for _ in range(5):
            w_r, a_r = rt_r.step_weights()
            w_t, a_t = rt_t.step_weights()
            np.testing.assert_array_equal(a_t, a_r)
            np.testing.assert_array_equal(w_t, w_r)


def test_reassign_matches_fresh_runtime():
    rt0 = TT.CodingRuntime(_coding(TCoding), 6, device=CPU)
    rt1 = TT.elastic_reassign(rt0, [2], generation=1)
    fresh = TT.CodingRuntime(TT.elastic_coding(rt0.coding, 5, 1), 5,
                             device=CPU)
    np.testing.assert_array_equal(rt1.assignment.A, fresh.assignment.A)
    assert rt1.scale == fresh.scale
    rng = np.random.default_rng(9)
    for _ in range(6):
        mask = rng.random(5) > 0.3
        np.testing.assert_array_equal(rt1.weights_for(mask),
                                      fresh.weights_for(mask))


def test_reassign_validates_dead_ids():
    rt0 = TT.CodingRuntime(_coding(TCoding), 4, device=CPU)
    for bad in ([1, 1], [4], [-1]):
        with pytest.raises(ValueError):
            TT.elastic_reassign(rt0, bad, generation=1)


def test_reassign_carries_mask_source_policy_and_device():
    rt0 = TT.CodingRuntime(_coding(TCoding, straggler_model="markov"), 12,
                           device=CPU, adaptive="adaptive",
                           debias_trials=64, cache_size=7)
    obs = sw.ObservedMaskSource(10)
    rt1 = TT.elastic_reassign(rt0, [0, 1], generation=1, mask_source=obs)
    assert rt1.mask_source is obs
    assert rt1.policy is not None and rt1.estimator.m == 10
    assert (rt1.device, rt1.debias_trials, rt1.cache_size) == (CPU, 64, 7)
    with pytest.raises(ValueError):
        TT.elastic_reassign(rt0, [1], generation=1,
                            mask_source=sw.ObservedMaskSource(12))


# ------------------------------------------------ trajectory, in the port

def _run_steps(cfg, opt, runtime, src, params, opt_state, start, steps,
               bs=2):
    """The driver's per-generation loop in miniature: dedup path, masks
    from the runtime's source."""
    A = runtime.assignment
    batcher = CodedBatcher(A, shuffle_seed=0)
    step_fn = TT.make_train_step(
        cfg, opt, dedup=True, norm_scale=TT.dedup_norm_scale(A),
        alpha_weights=TT.alpha_bar_weights(A))
    losses = []
    for step in range(start, start + steps):
        blocks = {k: torch.from_numpy(v) for k, v in
                  batcher.unique_blocks(src.batch(A.n * bs, step)).items()}
        w, _ = runtime.step_weights()
        v = torch.from_numpy(runtime.block_weights(w))
        with torch.no_grad():
            params, opt_state, met = step_fn(params, opt_state, blocks, v)
        losses.append(float(met["loss"]))
    return params, opt_state, losses


def _clone(tree):
    return T.map(lambda x: x.clone(), tree)


def _tree_bit_equal(a, b):
    for x, y in zip(T.leaves(a), T.leaves(b)):
        assert torch.equal(x, y)


@pytest.fixture
def deterministic():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


def test_elastic_trajectory_bit_identical_to_fresh_run(deterministic):
    cfg = get_config("granite-3-8b").smoke_variant()
    coding = _coding(TCoding)
    opt = opt_mod.get_optimizer("adamw", 1e-3)
    src = SyntheticLM(cfg.vocab_size, 16, seed=0)
    rng = np.random.default_rng(11)
    masks0 = rng.random((3, 4)) > 0.2          # generation 0, m = 4
    masks1 = rng.random((3, 3)) > 0.2          # generation 1, m' = 3
    params = M.init_params(cfg, seed=0, device=CPU)
    rt0 = TT.CodingRuntime(coding, 4, device=CPU,
                           mask_source=sw.ReplayedMaskSource(masks0))
    p_mid, o_mid, _ = _run_steps(cfg, opt, rt0, src, params,
                                 opt.init(params), 0, 3)
    rt1 = TT.elastic_reassign(rt0, [1], generation=1,
                              mask_source=sw.ReplayedMaskSource(masks1))
    p_el, o_el, l_el = _run_steps(cfg, opt, rt1, src, _clone(p_mid),
                                  _clone(o_mid), 3, 3)
    fresh = TT.CodingRuntime(TT.elastic_coding(coding, 3, 1), 3,
                             device=CPU,
                             mask_source=sw.ReplayedMaskSource(masks1))
    p_fr, o_fr, l_fr = _run_steps(cfg, opt, fresh, src, _clone(p_mid),
                                  _clone(o_mid), 3, 3)
    assert l_el == l_fr and np.isfinite(l_el).all()
    _tree_bit_equal(p_el, p_fr)
    _tree_bit_equal(o_el, o_fr)


def test_elastic_uncoded_degeneration_still_trains():
    rt0 = TT.CodingRuntime(_coding(TCoding, straggler_p=0.0), 3,
                           device=CPU)
    rt1 = TT.elastic_reassign(rt0, [0], generation=1)
    assert rt1.m == 2 and rt1.coding.scheme == "uncoded"
    rt2 = TT.elastic_reassign(rt1, [1], generation=2)
    assert rt2.m == 1 and rt2.coding.scheme == "uncoded"
    w = rt2.weights_for(np.array([True]))
    assert w.shape == (1,) and np.isfinite(w).all()
    cfg = get_config("granite-3-8b").smoke_variant()
    opt = opt_mod.get_optimizer("adamw", 1e-3)
    params = M.init_params(cfg, seed=0, device=CPU)
    _, _, losses = _run_steps(cfg, opt, rt1,
                              SyntheticLM(cfg.vocab_size, 16, seed=0),
                              params, opt.init(params), 0, 3)
    assert np.isfinite(losses).all()

