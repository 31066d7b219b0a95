"""The port's host-side coding machinery against ``repro.core``.

Everything here is NumPy in both packages, driven by the same
``np.random.default_rng`` calls, so the pin is bit-for-bit (exact array
equality, no tolerance): graphs, assignment matrices, straggler masks,
decoded w and alpha, served blocks, batched alphas, and the shard
services of the coded and uncoded prefill layers.
"""

import dataclasses

import numpy as np
import pytest

import repro.core as rc
import repro.core.step_weights as rsw
from repro import serve as RS
from repro.configs import CodingConfig as RCoding
from repro.dist import coded_train as rct
import repro_torch.core as tc
import repro_torch.core.step_weights as tsw
from repro_torch import serve as TS
from repro_torch.configs import CodingConfig as TCoding
from repro_torch.dist import coded_train as tct

SCHEMES = ("expander", "frc", "uncoded")
MODELS = ("bernoulli", "markov", "adversarial", "fixed_count")


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,d,vt", [(12, 4, True), (16, 4, True),
                                    (2184, 6, True), (10, 3, False),
                                    (20, 6, True), (9, 8, True)])
def test_make_expander_edges_identical(n, d, vt):
    assert tc.make_expander(n, d, vertex_transitive=vt).edges == \
        rc.make_expander(n, d, vertex_transitive=vt).edges


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("m,d", [(8, 2), (12, 3), (24, 4)])
def test_assignment_identical(scheme, m, d):
    a = tct.make_assignment(TCoding(scheme=scheme, replication=d), m)
    b = rct.make_assignment(RCoding(scheme=scheme, replication=d), m)
    _eq(a.A, b.A)
    assert a.name == b.name and a.machines == b.machines
    assert (a.graph is None) == (b.graph is None)
    if a.graph is not None:
        assert a.graph.edges == b.graph.edges


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("method", ["optimal", "fixed"])
def test_mask_stream_and_decode_identical(scheme, model, method):
    m, d, p, seed, steps = 12, 2, 0.3, 7, 25
    A_t = tct.make_assignment(TCoding(scheme=scheme, replication=d), m)
    A_r = rct.make_assignment(RCoding(scheme=scheme, replication=d), m)
    mt = tsw.make_straggler_model(A_t, model, p)
    mr = rsw.make_straggler_model(A_r, model, p)
    rng_t, rng_r = (np.random.default_rng(seed),
                    np.random.default_rng(seed))
    masks = []
    for _ in range(steps):
        at, ar = mt.sample(rng_t), mr.sample(rng_r)
        _eq(at, ar)
        masks.append(at)
        wt, alt = tsw.step_weights(A_t, at, method=method, p=p)
        wr, alr = rsw.step_weights(A_r, ar, method=method, p=p)
        _eq(wt, wr)
        _eq(alt, alr)
        _eq(tsw.served_blocks(A_t, wt), rsw.served_blocks(A_r, wr))
        _eq(tsw.block_weights(A_t, wt), rsw.block_weights(A_r, wr))
    # the generators end in the same state
    _eq(rng_t.random(4), rng_r.random(4))
    masks = np.stack(masks)
    Wt, ALt = tsw.batched_step_weights(A_t, masks, method=method, p=p)
    Wr, ALr = rsw.batched_step_weights(A_r, masks, method=method, p=p)
    _eq(Wt, Wr)
    _eq(ALt, ALr)
    _eq(tc.batched_alpha(A_t, masks, method=method, p=p),
        rc.batched_alpha(A_r, masks, method=method, p=p))


@pytest.mark.parametrize("m,d,p", [(24, 4, 0.2), (8, 2, 0.5),
                                   (6552, 6, 0.1)])
def test_batched_graph_decoder_identical(m, d, p):
    A_t = tc.expander_assignment(m, d)
    A_r = rc.expander_assignment(m, d)
    masks = np.random.default_rng(1).random((16, m)) >= p
    _eq(tc.batched_optimal_alpha_graph(A_t.graph, masks),
        rc.batched_optimal_alpha_graph(A_r.graph, masks, backend="numpy"))


@pytest.mark.parametrize("scheme", ["expander", "frc"])
@pytest.mark.parametrize("model", MODELS)
def test_coded_prefill_services_identical(scheme, model):
    kw = dict(scheme=scheme, replication=2, straggler_model=model,
              straggler_p=0.3, seed=5)
    lt = TS.CodedPrefillLayer(TCoding(**kw), 8, max_retries=4)
    lr = RS.CodedPrefillLayer(RCoding(**kw), 8, max_retries=4)
    for k in (3, 4, 1, 4, 2, 4, 4, 3, 4, 4):
        st = lt.serve_shards(lt.assign_shards(k))
        sr = lr.serve_shards(lr.assign_shards(k))
        assert [dataclasses.astuple(s) for s in st] == \
            [dataclasses.astuple(s) for s in sr]
    assert (lt.rounds, lt.decode_calls) == (lr.rounds, lr.decode_calls)


@pytest.mark.parametrize("model", MODELS)
def test_uncoded_prefill_services_identical(model):
    kw = dict(scheme="uncoded", straggler_model=model, straggler_p=0.4,
              seed=2)
    lt = TS.UncodedPrefillLayer(TCoding(**kw), 8)
    lr = RS.UncodedPrefillLayer(RCoding(**kw), 8)
    for k in (4, 4, 2, 8, 1, 3):
        st = lt.serve_shards(lt.assign_shards(k))
        sr = lr.serve_shards(lr.assign_shards(k))
        assert [dataclasses.astuple(s) for s in st] == \
            [dataclasses.astuple(s) for s in sr]


def test_simulate_shard_ttft_identical():
    m, rounds, p = 16, 200, 0.2
    A_t = tc.expander_assignment(m, 2)
    A_r = rc.expander_assignment(m, 2)
    rng = np.random.default_rng(0)
    alive = rng.random((rounds, m)) >= p
    W, _ = tsw.batched_step_weights(A_t, alive)
    lat_t = TS.ReplicaLatencyModel(m=m)
    lat = np.stack([lat_t.latencies(a, rng) for a in alive])
    kw = dict(deadline_ms=lat_t.deadline_ms, straggle_ms=lat_t.straggle_ms)
    for a, b in zip(TS.simulate_shard_ttft(A_t, W, alive, lat, **kw),
                    RS.simulate_shard_ttft(A_r, W, alive, lat, **kw)):
        _eq(a, b)


def test_adversarial_masks_identical():
    for m, d, p in [(24, 4, 0.25), (12, 3, 0.5)]:
        for scheme in SCHEMES:
            A_t = tct.make_assignment(TCoding(scheme=scheme,
                                              replication=d), m)
            A_r = rct.make_assignment(RCoding(scheme=scheme,
                                              replication=d), m)
            _eq(tc.adversarial_mask(A_t, p), rc.adversarial_mask(A_r, p))


def test_unported_scheme_is_rejected():
    with pytest.raises(ValueError, match="unknown scheme"):
        tct.make_assignment(TCoding(scheme="lattice", replication=3), 7)
    # the scheme zoo is ported: bibd builds the reference's design
    np.testing.assert_array_equal(
        tct.make_assignment(TCoding(scheme="bibd", replication=3), 7).A,
        rct.make_assignment(RCoding(scheme="bibd", replication=3), 7).A)
