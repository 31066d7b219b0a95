"""The port's training slice against the JAX package, on the CPU.

Reference parameters cross into the port through NumPy
(``convert.params_from_numpy``); masks, weights and batches are made
with NumPy and handed to both packages. Tolerances, each with its
reason:

- the loss and gradients of ``train_loss``, float32: rtol 1e-5 on the
  loss, rtol 2e-4 / atol 2e-5 on every gradient leaf (the reference's
  own ``_tree_allclose``): the libraries sum in different orders;
- optimizer trajectories (same gradient stream): rtol 1e-5 / atol 1e-7;
  ``b ** step`` and the square root may round differently by an ulp;
- port-internal identities (autograd == explicit combine, dedup ==
  replicated, manual == autograd, microbatched == single shot): the
  reference tests' tolerances (tests/test_dist.py, tests/test_dedup.py);
- train-step trajectories against the reference, 3 AdamW steps: losses
  rtol 1e-4; 99.9 % of the parameters within rtol 2e-3 / atol 5e-4
  (tests/test_dedup.py's trajectory tolerance) and all of them within
  atol 2 lr per step. Adam divides by sqrt(v): where a gradient entry is
  near zero, float32 rounding (or, under int8 and sign_packed, one
  flipped quantized value or sign bit) can turn into an update of the
  other sign, an lr-sized difference on that entry alone;
- the drivers' loss streams from one params-only checkpoint: rtol 1e-4
  (measured ~2e-5 on the int8 path).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.step_weights as rsw
from repro.checkpoint import checkpoint as rckpt
from repro.configs import CodingConfig as RCoding, get_config as rget
from repro.core import expander_assignment as r_expander
from repro.data.pipeline import CodedBatcher, SyntheticLM
from repro.dist import coded_train as RT
from repro.launch.mesh import make_test_mesh
from repro.models import model as RM
from repro.optim import optimizers as ropt
from repro_torch import tree as T
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import CodingConfig as TCoding, get_config as tget
from repro_torch.core import compress as tcomp
from repro_torch.core import step_weights as tsw
from repro_torch.core.assignment import expander_assignment as t_expander
from repro_torch.dist import coded_train as TT
from repro_torch.kernels.coded_combine import ops as cc_ops
from repro_torch.launch import train as ttrain
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import optimizers as topt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
TRAJ_TOL = dict(rtol=2e-3, atol=5e-4)


def _cfgs(arch="granite-3-8b", **over):
    return (rget(arch).smoke_variant().with_overrides(**over),
            tget(arch).smoke_variant().with_overrides(**over))


def _ref_params(rcfg, seed=0):
    return jax.tree.map(np.asarray,
                        RM.init_params(rcfg, jax.random.PRNGKey(seed)))


def _t(x):
    return torch.from_numpy(np.array(x))


def _tt(tree):
    """A NumPy / JAX tree as torch tensors on the CPU."""
    return T.map(_t, jax.tree.map(np.asarray, tree))


def _assert_trees(port, ref, **tol):
    """Leaf by leaf, in the flatten order both packages share."""
    pl, rl = T.leaves(port), jax.tree.leaves(ref)
    assert len(pl) == len(rl)
    assert T.paths(port) == ["/".join(str(k.key) for k in p) for p, _ in
                             jax.tree_util.tree_flatten_with_path(ref)[0]]
    for a, b in zip(pl, rl):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   np.asarray(b, np.float32), **tol)


def _setup(name="expander", bs=3, S=16, cfg_over=None):
    rcfg, tcfg = _cfgs(**(cfg_over or {}))
    A = {"expander": lambda: r_expander(4, 2, vertex_transitive=False,
                                        seed=1)}[name]()
    batcher = CodedBatcher(A, shuffle_seed=0)
    raw = SyntheticLM(rcfg.vocab_size, S, seed=0).batch(A.n * bs, 0)
    coded = batcher.code_batch(raw)
    blocks = batcher.unique_blocks(raw)
    tree = _ref_params(rcfg)
    return rcfg, tcfg, A, coded, blocks, tree


# ------------------------------------------------------------- the model

@pytest.mark.parametrize("variant", [
    ("granite-3-8b", {}), ("granite-3-8b", {"tie_embeddings": True}),
    ("granite-3-8b", {"sliding_window": 5}), ("qwen1.5-4b", {})])
def test_train_loss_and_grads_match_reference(variant):
    arch, over = variant
    rcfg, tcfg = _cfgs(arch, **over)
    tree = _ref_params(rcfg, seed=1)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, rcfg.vocab_size, (3, 12)).astype(np.int32)
    labels = rng.integers(0, rcfg.vocab_size, (3, 12)).astype(np.int32)
    labels[1, 4] = -1                       # masked label position
    batch = {"tokens": tokens, "labels": labels}

    norm = labels.size       # normalised as the coded losses are

    def rloss(p):
        return RM.train_loss(p, batch, rcfg, per_example=True).sum() / norm
    r_l, r_g = jax.value_and_grad(rloss)(tree)
    params = params_from_numpy(tree, tcfg, device="cpu")
    t_l, t_g = TT.value_and_grad(
        lambda p: TM.train_loss(p, T.map(_t, batch), tcfg,
                                per_example=True).sum() / norm, params)
    np.testing.assert_allclose(t_l.item(), float(r_l), rtol=1e-5)
    _assert_trees(t_g, r_g, **GRAD_TOL)
    per = TM.train_loss(params, T.map(_t, batch), tcfg, per_example=True)
    np.testing.assert_allclose(
        per.numpy(), np.asarray(RM.train_loss(tree, batch, rcfg,
                                              per_example=True)),
        rtol=1e-5)


def test_forward_logits_match_reference_and_mask_padded_vocab():
    rcfg, tcfg = _cfgs(vocab_size=500)          # padded to 512
    tree = _ref_params(rcfg)
    tokens = np.random.default_rng(1).integers(0, 500, (2, 9)).astype(
        np.int32)
    want = np.asarray(RM.forward(tree, tokens, rcfg))
    got = TM.forward(params_from_numpy(tree, tcfg, device="cpu"),
                     _t(tokens), tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 9, 512)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    batch = {"tokens": tokens, "labels": tokens}
    np.testing.assert_allclose(
        TM.train_loss(params_from_numpy(tree, tcfg, device="cpu"),
                      T.map(_t, batch), tcfg).item(),
        float(RM.train_loss(tree, batch, rcfg)), rtol=1e-5)


# ------------------------------------------------------------ optimizers

def _grad_stream(params, steps, seed=0):
    rng = np.random.default_rng(seed)
    return [jax.tree.map(lambda p: rng.normal(size=p.shape).astype(
        np.float32), params) for _ in range(steps)]


@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("sgd", {"momentum": 0.9}), ("adamw", {}),
    ("adamw", {"weight_decay": 0.1}), ("adamw", {"b2": 0.999}),
    ("cosine_adamw", {})])
def test_optimizer_trajectories_match_reference(name, kw):
    params = {"a": np.ones((3, 4), np.float32),
              "b": {"c": np.linspace(-1, 1, 5).astype(np.float32)}}
    if name == "cosine_adamw":
        r_opt = ropt.adamw(ropt.cosine_schedule(1e-2, 2, 6))
        t_opt = topt.adamw(topt.cosine_schedule(1e-2, 2, 6))
    else:
        r_opt = ropt.get_optimizer(name, 1e-2, **kw)
        t_opt = topt.get_optimizer(name, 1e-2, **kw)
    rp, tp = jax.tree.map(jnp.asarray, params), _tt(params)
    rs, ts = r_opt.init(rp), t_opt.init(tp)
    for g in _grad_stream(params, 6):
        ru, rs = r_opt.update(jax.tree.map(jnp.asarray, g), rs, rp)
        rp = ropt.apply_updates(rp, ru)
        tu, ts = t_opt.update(_tt(g), ts, tp)
        tp = topt.apply_updates(tp, tu)
    _assert_trees(tp, rp, rtol=1e-5, atol=1e-7)
    _assert_trees(ts, rs, rtol=1e-5, atol=1e-7)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 6


def test_schedule_norms_and_clipping_match_reference():
    r_s = ropt.cosine_schedule(1.0, warmup=10, total=100)
    t_s = topt.cosine_schedule(1.0, warmup=10, total=100)
    for step in (0, 5, 10, 50, 100, 130):
        np.testing.assert_allclose(float(t_s(torch.tensor(step))),
                                   float(r_s(jnp.asarray(step))),
                                   rtol=1e-6, atol=1e-7)
    g = {"a": np.full((4,), 3.0, np.float32),
         "b": np.full((2, 2), -4.0, np.float32)}
    np.testing.assert_allclose(float(topt.global_norm(_tt(g))),
                               float(ropt.global_norm(g)), rtol=1e-6)
    for max_norm in (1.0, 100.0):
        tc, tn = topt.clip_by_global_norm(_tt(g), max_norm)
        rc, rn = ropt.clip_by_global_norm(
            jax.tree.map(jnp.asarray, g), max_norm)
        np.testing.assert_allclose(float(tn), float(rn), rtol=1e-6)
        _assert_trees(tc, rc, rtol=1e-6)
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.get_optimizer("lion", 1e-3)


# ------------------------------------------- port-internal identities

def _port(setup):
    rcfg, tcfg, A, coded, blocks, tree = setup
    return (tcfg, A, T.map(_t, coded), T.map(_t, blocks),
            params_from_numpy(tree, tcfg, device="cpu"))


def test_coded_grad_equals_explicit_combine_of_machine_grads():
    """grad(sum_j w_j L_j) == sum_j w_j g_j (tests/test_dist.py:49)."""
    tcfg, A, coded, _, params = _port(_setup())
    w = torch.tensor([1.0, 0.0, 0.7, 2.0])
    _, auto = TT.value_and_grad(
        lambda p: TT.coded_loss_fn(p, coded, w, tcfg), params)
    losses, per_machine = TT._per_machine_values_and_grads(
        params, coded, tcfg)
    manual = cc_ops.coded_combine_tree(per_machine, w)
    for a, b in zip(T.leaves(auto), T.leaves(manual)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)
    np.testing.assert_allclose(
        (w * losses).sum().item(),
        TT.coded_loss_fn(params, coded, w, tcfg).item(), rtol=1e-5)


def test_dedup_equals_replicated_loss_and_grads():
    tcfg, A, coded, blocks, params = _port(_setup())
    w = np.asarray([0.3, 1.2, 0.0, 0.9])
    v = tsw.block_weights(t_expander(4, 2, vertex_transitive=False,
                                     seed=1), w)
    ns = TT.dedup_norm_scale(A)
    l_rep, g_rep = TT.value_and_grad(lambda p: TT.coded_loss_fn(
        p, coded, _t(w.astype(np.float32)), tcfg), params)
    l_dd, g_dd = TT.value_and_grad(lambda p: TT.coded_loss_fn_dedup(
        p, blocks, _t(v.astype(np.float32)), tcfg, ns), params)
    np.testing.assert_allclose(l_rep.item(), l_dd.item(), rtol=1e-5)
    for a, b in zip(T.leaves(g_rep), T.leaves(g_dd)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)


def test_manual_collective_step_equals_autograd_step():
    tcfg, A, coded, _, params = _port(_setup(bs=2))
    opt = topt.sgd(1e-2)
    aw = TT.alpha_bar_weights(A)
    s_auto = TT.make_train_step(tcfg, opt, alpha_weights=aw)
    s_man = TT.make_manual_collective_train_step(tcfg, opt,
                                                 alpha_weights=aw)
    w = torch.tensor([1.0, 0.0, 0.7, 2.0])
    p1, _, m1 = s_auto(params, opt.init(params), coded, w)
    p2, _, m2 = s_man(params, opt.init(params), coded, w)
    np.testing.assert_allclose(m1["loss"].item(), m2["loss"].item(),
                               rtol=1e-5)
    np.testing.assert_allclose(m1["alpha_bar"].item(),
                               m2["alpha_bar"].item(), rtol=1e-6)
    for a, b in zip(T.leaves(p1), T.leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)
    # the streaming combine (two machines a chunk) is the same step
    s_str = TT.make_manual_collective_train_step(
        tcfg, opt, alpha_weights=aw, streaming_chunk=2)
    p3, _, m3 = s_str(params, opt.init(params), coded, w)
    np.testing.assert_allclose(m3["loss"].item(), m2["loss"].item(),
                               rtol=1e-5)
    for a, b in zip(T.leaves(p3), T.leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)
    with pytest.raises(ValueError, match="streaming_chunk"):
        TT.make_manual_collective_train_step(tcfg, opt,
                                             streaming_chunk=0)


@pytest.mark.parametrize("dedup", [False, True])
def test_microbatched_step_equals_single_shot(dedup):
    tcfg, A, coded, blocks, params = _port(_setup(bs=4))
    w = np.asarray([0.5, 1.5, 0.0, 1.0], np.float32)
    batch = blocks if dedup else coded
    wv = _t(A.A @ w).float() if dedup else _t(w)
    kw = dict(dedup=dedup, norm_scale=TT.dedup_norm_scale(A))
    opt = topt.sgd(1e-2)
    s1 = TT.make_train_step(tcfg, opt, n_microbatches=1, **kw)
    s4 = TT.make_train_step(tcfg, opt, n_microbatches=4, **kw)
    p1, _, m1 = s1(params, opt.init(params), batch, wv)
    p4, _, m4 = s4(params, opt.init(params), batch, wv)
    np.testing.assert_allclose(m1["loss"].item(), m4["loss"].item(),
                               rtol=1e-5)
    for a, b in zip(T.leaves(p1), T.leaves(p4)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)
    with pytest.raises(ValueError, match="not divisible"):
        TT.make_train_step(tcfg, opt, n_microbatches=3, **kw)(
            params, opt.init(params), batch, wv)


# ------------------------------- train-step trajectories vs the reference

@pytest.mark.parametrize("compress", [None, "int8", "sign_packed"])
@pytest.mark.parametrize("path", ["dedup", "replicated", "manual"])
def test_train_step_trajectory_matches_reference(compress, path):
    rcfg, tcfg, A, _, _, tree = _setup()
    lr = 1e-3
    r_opt, t_opt = ropt.adamw(lr), topt.adamw(lr)
    dedup = path == "dedup"
    aw = RT.alpha_bar_weights(A)
    ns = RT.dedup_norm_scale(A)
    if path == "manual":
        mesh = make_test_mesh((1, 1))
        r_step = jax.jit(RT.make_manual_collective_train_step(
            rcfg, r_opt, mesh, alpha_weights=aw, compress=compress))
        t_step = TT.make_manual_collective_train_step(
            tcfg, t_opt, alpha_weights=aw, compress=compress)
    else:
        kw = dict(dedup=dedup, norm_scale=ns, alpha_weights=aw,
                  compress=compress)
        r_step = jax.jit(RT.make_train_step(rcfg, r_opt, **kw))
        t_step = TT.make_train_step(tcfg, t_opt, **kw)
    rp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, tcfg, device="cpu")
    rs, ts = r_opt.init(rp), t_opt.init(tp)
    rows = A.n if dedup else A.m
    rc = RT.compress_mod.init_state(rp, rows) if compress else None
    tc = tcomp.init_state(tp, rows) if compress else None
    batcher = CodedBatcher(A, shuffle_seed=0)
    src = SyntheticLM(rcfg.vocab_size, 16, seed=0)
    rng = np.random.default_rng(1)
    for step in range(3):
        raw = src.batch(A.n * 2, step)
        b = batcher.unique_blocks(raw) if dedup else batcher.code_batch(raw)
        w = (rng.random(A.m) * (rng.random(A.m) > 0.3)).astype(np.float32)
        wv = (A.A @ w).astype(np.float32) if dedup else w
        rb = {k: jnp.asarray(v) for k, v in b.items()}
        if path == "manual":
            with make_test_mesh((1, 1)):
                r_out = (r_step(rp, rs, rc, rb, jnp.asarray(wv))
                         if compress else r_step(rp, rs, rb, jnp.asarray(wv)))
        else:
            r_out = (r_step(rp, rs, rc, rb, jnp.asarray(wv)) if compress
                     else r_step(rp, rs, rb, jnp.asarray(wv)))
        t_out = (t_step(tp, ts, tc, T.map(_t, b), _t(wv)) if compress
                 else t_step(tp, ts, T.map(_t, b), _t(wv)))
        if compress:
            rp, rs, rc, rm = r_out
            tp, ts, tc, tm = t_out
            assert float(tm["comm_bytes"]) == float(rm["comm_bytes"])
        else:
            rp, rs, rm = r_out
            tp, ts, tm = t_out
        np.testing.assert_allclose(tm["loss"].item(), float(rm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(tm["alpha_bar"].item(),
                                   float(rm["alpha_bar"]), rtol=1e-6)
    _assert_trees(tp, rp, rtol=0, atol=2 * lr * 3)
    far = total = 0
    for a, b in zip(T.leaves(tp), jax.tree.leaves(rp)):
        d = np.abs(a.numpy() - np.asarray(b))
        far += int((d > TRAJ_TOL["atol"] + TRAJ_TOL["rtol"]
                    * np.abs(np.asarray(b))).sum())
        total += d.size
    assert far <= 1e-3 * total, (far, total)


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


# ------------------------------------------------------------ driver

def test_driver_needs_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")
    with pytest.raises(RuntimeError, match="--device cpu"):
        ttrain.main(["--steps", "1"])


@pytest.mark.parametrize("flag", [
    (["--collective", "manual", "--stream-chunk", "3"], "divisible"),
    (["--stream-chunk", "2"], "--collective manual"),
    (["--chaos", "kill:1@3", "--no-dedup"], "dedup"),
    (["--event-log", "events.json"], "--chaos"),
    (["--production-mesh"], "needs 256 ranks"),
    (["--chaos", "kill:1@3", "--collective", "manual"], "dedup"),
    (["--chaos", "kill:1@3", "--ckpt-dir", "ckpt"], "--chaos"),
    (["--collective", "manual", "--dedup"], "dedup")])
def test_driver_refuses_later_slices_and_bad_combinations(flag, capsys):
    argv, says = flag
    with pytest.raises(SystemExit) as exc:
        ttrain.main(["--device", "cpu", "--steps", "1", *argv])
    assert says in capsys.readouterr().err + str(exc.value.code)


def test_driver_resume_replays_the_tail(tmp_path):
    args = ["--device", "cpu", "--steps", "4", "--seq-len", "16",
            "--block-size", "2", "--compress", "int8", "--ckpt-dir"]
    full = ttrain.main(args + [str(tmp_path / "a"), "--ckpt-every", "2"])
    os.remove(tmp_path / "a" / "ckpt_00000004.npz")
    resumed = ttrain.main(args + [str(tmp_path / "a")])
    assert resumed["start_step"] == 2
    assert resumed["losses"] == full["losses"][2:]
    for key in ("first_loss", "last_loss", "losses", "start_step", "steps",
                "m_workers", "scheme", "decoding", "path", "collective",
                "compress", "stream_chunk", "fsdp", "comm_bytes_per_step",
                "comm_bytes_per_step_float32", "decode_calls", "chaos"):
        assert key in full


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


@pytest.mark.parametrize("extra", [["--compress", "int8"],
                                   ["--collective", "manual"]])
def test_driver_loss_streams_match_reference_driver(tmp_path, extra):
    """Both drivers, same flags, each from its own copy of one
    params-only step-0 checkpoint of reference parameters."""
    rcfg = rget("qwen1.5-4b").smoke_variant()
    tree = _ref_params(rcfg, seed=3)
    for d in ("ref", "port"):
        rckpt.save(str(tmp_path / d), tree, step=0)
    flags = ["--arch", "qwen1.5-4b", "--steps", "6", "--seq-len", "32",
             "--block-size", "2", "--straggler-p", "0.2", *extra]
    env = _env()
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    ref = subprocess.run(
        [sys.executable, "-m", "repro.launch.train", *flags,
         "--ckpt-dir", str(tmp_path / "ref")], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=420)
    assert ref.returncode == 0, ref.stdout + ref.stderr
    port = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device",
         "cpu", *flags, "--ckpt-dir", str(tmp_path / "port")], cwd=REPO,
        env=_env(), capture_output=True, text=True, timeout=420)
    assert port.returncode == 0, port.stdout + port.stderr
    r = json.loads(ref.stdout.strip().splitlines()[-1])
    p = json.loads(port.stdout.strip().splitlines()[-1])
    assert r["m_workers"] == p["m_workers"] == 4
    for key in ("path", "collective", "compress", "comm_bytes_per_step",
                "comm_bytes_per_step_float32", "decode_calls"):
        assert p[key] == r[key], key
    np.testing.assert_allclose(p["losses"], r["losses"], rtol=1e-4)
