"""The port's host-side coding runtime and checkpoints against the JAX
package, on the CPU: coding runtimes' weight and mask streams bit for
bit, the lookahead prefetcher against the per-step stream, mask sources
and the debias scale, and checkpoints loading across the packages both
ways (split from ``test_torch_train.py``)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.step_weights as rsw
from repro.checkpoint import checkpoint as rckpt
from repro.configs import CodingConfig as RCoding
from repro.core import expander_assignment as r_expander
from repro.dist import coded_train as RT
from repro.optim import optimizers as ropt
from repro_torch import tree as T
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import CodingConfig as TCoding
from repro_torch.core import step_weights as tsw
from repro_torch.core.assignment import expander_assignment as t_expander
from repro_torch.dist import coded_train as TT

from torch_train_common import (_assert_trees, _cfgs, _ref_params, _t,
                                _two_threads)


# ---------------------------------------------------- host runtime

@pytest.mark.parametrize("scheme", ["expander", "frc", "uncoded"])
@pytest.mark.parametrize("model", ["bernoulli", "markov", "adversarial"])
def test_coding_runtime_streams_bit_identical(scheme, model):
    kw = dict(scheme=scheme, replication=2, decoding="optimal",
              straggler_model=model, straggler_p=0.25, seed=3)
    r = RT.CodingRuntime(RCoding(**kw), 8)
    t = TT.CodingRuntime(TCoding(**kw), 8)
    assert t.scale == r.scale
    for _ in range(4):
        (rw, ra), (tw, ta) = r.step_weights(), t.step_weights()
        np.testing.assert_array_equal(ra, ta)
        np.testing.assert_array_equal(rw, tw)
        assert tw.dtype == np.float32
    r.skip(3)
    t.skip(3)
    (rW, rA), (tW, tA) = r.weights_lookahead(6), t.weights_lookahead(6)
    np.testing.assert_array_equal(rA, tA)
    np.testing.assert_array_equal(rW, tW)
    np.testing.assert_array_equal(r.block_weights(rW[0]),
                                  t.block_weights(tW[0]))
    assert t.decode_calls == r.decode_calls


def test_lookahead_prefetcher_equals_per_step_stream():
    from concurrent.futures import ThreadPoolExecutor
    coding = TCoding(scheme="expander", replication=2, straggler_p=0.3,
                     straggler_model="markov", seed=1)
    per_step = TT.CodingRuntime(coding, 8)
    want = [per_step.step_weights() for _ in range(11)]
    with ThreadPoolExecutor(max_workers=1) as pool:
        pre = TT.LookaheadPrefetcher(TT.CodingRuntime(coding, 8), pool,
                                     horizon=4, total_steps=11)
        for w, a in want:
            gw, ga = pre.next()
            np.testing.assert_array_equal(gw, w)
            np.testing.assert_array_equal(ga, a)
        with pytest.raises(RuntimeError, match="exhausted"):
            pre.next()


def test_mask_sources_and_debias_match_reference():
    rA = r_expander(12, 3, vertex_transitive=True, seed=0)
    tA = t_expander(12, 3, vertex_transitive=True, seed=0)
    assert tsw.debias_scale_mc(tA, p=0.3, trials=64, seed=5) == \
        rsw.debias_scale_mc(rA, p=0.3, trials=64, seed=5)
    alphas = np.random.default_rng(0).random((10, 6))
    from repro.kernels.batched_alpha.ops import debias_scale
    assert tsw.debias_scale(alphas) == debias_scale(alphas)
    rm = rsw.make_straggler_model(rA, "markov", 0.2)
    tm = tsw.make_straggler_model(tA, "markov", 0.2)
    rr, tr = rsw.sample_mask_stream(rA, rm, steps=5, shuffle=True,
                                    rng=np.random.default_rng(2)), \
        tsw.sample_mask_stream(tA, tm, steps=5, shuffle=True,
                               rng=np.random.default_rng(2))
    for a, b in zip(rr, tr):
        np.testing.assert_array_equal(a, b)
    masks = np.random.default_rng(4).random((3, 12)) > 0.2
    rep = tsw.ReplayedMaskSource(masks)
    rep.skip(1)
    np.testing.assert_array_equal(rep.next_mask(), masks[1])
    with pytest.raises(RuntimeError, match="cannot skip"):
        rep.skip(5)
    obs = tsw.ObservedMaskSource(12)
    with pytest.raises(RuntimeError, match="no observed mask"):
        obs.next_mask()
    obs.push(masks[2])
    np.testing.assert_array_equal(obs.next_mask(), masks[2])
    with pytest.raises(RuntimeError, match="fast-forwarded"):
        obs.skip(1)
    adapt = TT.CodingRuntime(TCoding(replication=2), 4,
                             adaptive="adaptive")
    assert adapt.policy is not None and adapt.decision_counts == {}


# ------------------------------------------------------- checkpoints

def _composite(tree, rcfg):
    opt = ropt.adamw(1e-3)
    p = jax.tree.map(jnp.asarray, tree)
    state = opt.init(p)
    g = jax.tree.map(lambda x: 0.1 * jnp.ones_like(x), p)
    _, state = opt.update(g, state, p)
    return {"params": p, "opt_state": state,
            "compress": RT.compress_mod.init_state(p, 2)}


def test_checkpoint_cross_loads_both_ways(tmp_path):
    rcfg, tcfg = _cfgs()
    ref_state = jax.tree.map(np.asarray, _composite(_ref_params(rcfg),
                                                    rcfg))
    # reference -> port
    rckpt.save(str(tmp_path / "r"), ref_state, step=5)
    assert tckpt.latest_step(str(tmp_path / "r")) == 5
    like = T.map(_t, ref_state)
    got = tckpt.restore(str(tmp_path / "r"), like)
    _assert_trees(got, ref_state, rtol=0, atol=0)
    assert got["opt_state"]["step"].dtype == torch.int32
    # port -> reference
    tckpt.save(str(tmp_path / "t"), got, step=7)
    back = rckpt.restore(str(tmp_path / "t"), ref_state)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_state)):
        np.testing.assert_array_equal(a, b)
    with open(tmp_path / "t" / "ckpt_00000007.json") as f:
        ours = json.load(f)
    with open(tmp_path / "r" / "ckpt_00000005.json") as f:
        theirs = json.load(f)
    assert ours["keys"] == theirs["keys"]
    # the driver's template list: a params-only checkpoint of reference
    # parameters falls through to the "params" template
    rckpt.save(str(tmp_path / "p"), ref_state["params"], step=0)
    templates = [("compressed", like),
                 ("composite", {k: like[k] for k in ("params",
                                                     "opt_state")}),
                 ("params", like["params"])]
    label, params = tckpt.restore_any(str(tmp_path / "p"), templates)
    assert label == "params"
    _assert_trees(params, ref_state["params"], rtol=0, atol=0)
    label, _ = tckpt.restore_any(str(tmp_path / "t"), templates)
    assert label == "compressed"


def test_restore_fallback_walks_past_a_torn_checkpoint(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3)}
    d = str(tmp_path)
    tckpt.save(d, tree, step=1)
    tckpt.save(d, {"a": tree["a"] + 1}, step=2)
    with open(os.path.join(d, "ckpt_00000002.npz"), "wb") as f:
        f.write(b"torn")
    step, label, state = tckpt.restore_fallback(d, [("x", tree)])
    assert (step, label) == (1, "x")
    assert torch.equal(state["a"], tree["a"])
    with pytest.raises(ValueError, match="leaves"):
        tckpt.restore(d, {"a": tree["a"], "b": tree["a"]}, step=1)
