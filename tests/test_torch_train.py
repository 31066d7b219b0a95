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
  reference tests' tolerances (tests/test_dist.py, tests/test_dedup.py).

The rest of the slice's pins sit in files of their own, so that the
suite's workers run them side by side: the train-step trajectories
(``test_torch_train_trajectory_{dedup,replicated,manual}.py``), the
host runtime and checkpoints (``test_torch_train_runtime.py``) and the
driver (``test_torch_train_driver.py``); their helpers are in
``torch_train_common.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as RM
from repro.optim import optimizers as ropt
from repro_torch import tree as T
from repro_torch.core import step_weights as tsw
from repro_torch.core.assignment import expander_assignment as t_expander
from repro_torch.dist import coded_train as TT
from repro_torch.kernels.coded_combine import ops as cc_ops
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import optimizers as topt

from torch_train_common import (GRAD_TOL, _assert_trees, _cfgs, _ref_params,
                                _setup, _t, _tt, _two_threads)


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
