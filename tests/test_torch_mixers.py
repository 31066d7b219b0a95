"""The port's sequence mixers and MoE routers against the JAX package.

Mixer parameters are made by the reference (``jax.random``) and carried
into the port through NumPy; inputs are made with NumPy from a seed.
Port against reference, float32: atol = rtol = 2e-5, the two libraries'
float32 reduction orders (the chunked einsums, cumulative sums and the
sLSTM scan, which the port runs as a doubling scan where the reference
runs ``jax.lax.associative_scan``). Then the reference suite's own
identities (tests/test_mixers.py:57-107) on the port's functions:
chunked SSD and mLSTM equal their step-by-step decode, the sLSTM scan
its recurrence, within atol 2e-5; and a tie case for expert-choice
top-C, where the port must pick the reference's lower index.
"""

import jax
import numpy as np
import pytest
import torch

from repro.models import moe as rmoe, ssm as rssm, xlstm as rxl
from repro_torch import tree as T
from repro_torch.models import moe as tmoe, ssm as tssm, xlstm as txl

KEY = jax.random.PRNGKey(0)
TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: the suite's other workers share the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _carry(tree):
    return T.map(lambda a: torch.from_numpy(np.array(a)),
                 jax.tree.map(np.asarray, tree))


def _u(B, S, D, seed=1, scale=0.5):
    return (np.random.default_rng(seed).normal(size=(B, S, D)) *
            scale).astype(np.float32)


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), **(tol or TOL))


# ------------------------------------------------------ port vs reference

@pytest.mark.parametrize("S,chunk", [(37, 16), (64, 64), (5, 8)])
def test_ssm_forward_matches_reference(S, chunk):
    B, D, N = 2, 32, 8
    rp = rssm.init_ssm(KEY, D, N, expand=2, head_p=8)
    u = _u(B, S, D)
    want = rssm.ssm_forward(rp, u, d_state=N, expand=2, head_p=8,
                            chunk=chunk)
    got = tssm.ssm_forward(_carry(rp), torch.from_numpy(u), d_state=N,
                           expand=2, head_p=8, chunk=chunk)
    _close(got, want)


def test_ssm_decode_matches_reference():
    B, D, N, steps = 2, 32, 8, 5
    rp = rssm.init_ssm(KEY, D, N, expand=2, head_p=8)
    tp = _carry(rp)
    u = _u(B, steps, D)
    rs = rssm.init_ssm_state(B, D, N, expand=2, head_p=8)
    ts = tssm.init_ssm_state(B, D, N, expand=2, head_p=8, device="cpu")
    for t in range(steps):
        ry, rs = rssm.ssm_decode(rp, u[:, t:t + 1], rs, d_state=N,
                                 expand=2, head_p=8)
        ty, ts = tssm.ssm_decode(tp, torch.from_numpy(u[:, t:t + 1]), ts,
                                 d_state=N, expand=2, head_p=8)
        _close(ty, ry)
        _close(ts["h"], rs["h"])
        _close(ts["conv"], rs["conv"])


@pytest.mark.parametrize("S,chunk", [(29, 8), (7, 32)])
def test_mlstm_forward_and_decode_match_reference(S, chunk):
    B, D, H = 2, 32, 4
    rp = rxl.init_mlstm(KEY, D, H)
    tp = _carry(rp)
    u = _u(B, S, D)
    _close(txl.mlstm_forward(tp, torch.from_numpy(u), n_heads=H,
                             chunk=chunk),
           rxl.mlstm_forward(rp, u, n_heads=H, chunk=chunk))
    rs = rxl.init_mlstm_state(B, D, H)
    ts = txl.init_mlstm_state(B, D, H, device="cpu")
    for t in range(3):
        ry, rs = rxl.mlstm_decode(rp, u[:, t:t + 1], rs, n_heads=H)
        ty, ts = txl.mlstm_decode(tp, torch.from_numpy(u[:, t:t + 1]), ts,
                                  n_heads=H)
        _close(ty, ry)
        _close(ts["C"], rs["C"])


@pytest.mark.parametrize("S", [1, 2, 33, 64])
def test_slstm_forward_and_decode_match_reference(S):
    B, D = 2, 16
    rp = rxl.init_slstm(KEY, D)
    tp = _carry(rp)
    u = _u(B, S, D)
    _close(txl.slstm_forward(tp, torch.from_numpy(u)),
           rxl.slstm_forward(rp, u))
    rs = rxl.init_slstm_state(B, D)
    ts = txl.init_slstm_state(B, D, device="cpu")
    ry, rs = rxl.slstm_decode(rp, u[:, :1], rs)
    ty, ts = txl.slstm_decode(tp, torch.from_numpy(u[:, :1]), ts)
    _close(ty, ry)
    _close(ts["n"], rs["n"])


def _moe_params(D=32, F=16, E=4, shared=1):
    rp = rmoe.init_moe(KEY, D, F, E, shared, F * max(shared, 1))
    return rp, _carry(rp)


@pytest.mark.parametrize("top_k,cf,S", [(2, 1.0, 12), (1, 4.0, 1),
                                        (2, 2.0, 1), (3, 1.0, 9)])
def test_moe_expert_choice_matches_reference(top_k, cf, S):
    """Training capacity (cf = 1) and decode's E / top_k at S = 1,
    where every expert takes the one token."""
    rp, tp = _moe_params()
    x = _u(3, S, 32)
    ry, raux = rmoe.moe_expert_choice(rp, x, top_k=top_k,
                                      capacity_factor=cf)
    ty, taux = tmoe.moe_expert_choice(tp, torch.from_numpy(x), top_k=top_k,
                                      capacity_factor=cf)
    _close(ty, ry)
    assert float(taux) == float(raux) == 0.0


@pytest.mark.parametrize("shared", [0, 1])
def test_moe_token_choice_matches_reference(shared):
    rp, tp = _moe_params(shared=shared)
    x = _u(2, 10, 32)
    ry, raux = rmoe.moe_token_choice_dense(rp, x, top_k=2)
    ty, taux = tmoe.moe_token_choice_dense(tp, torch.from_numpy(x),
                                           top_k=2)
    _close(ty, ry)
    np.testing.assert_allclose(float(taux), float(raux), rtol=1e-6)


def test_expert_choice_ties_pick_the_lower_index():
    """A zero router gives every token the same probability 1 / E: each
    expert's top-C is then all ties, and jax.lax.top_k takes the C
    lowest token indices. The port must take the same tokens: a token
    past them (here the last one, on its own line of x) gets no routed
    output."""
    rp, tp = _moe_params(shared=0)
    rp = dict(rp, router={"w": np.zeros_like(np.asarray(rp["router"]["w"]))})
    tp = dict(tp, router={"w": torch.zeros_like(tp["router"]["w"])})
    x = _u(1, 8, 32)
    ry, _ = rmoe.moe_expert_choice(rp, x, top_k=2)       # C = 4 of 8
    ty, _ = tmoe.moe_expert_choice(tp, torch.from_numpy(x), top_k=2)
    _close(ty, ry)
    assert not ty[0, 4:].any() and ty[0, :4].abs().min() > 0
    vals, idx = tmoe.top_k_stable(torch.tensor([[1., 3., 3., 0., 3.]]), 3)
    assert idx.tolist() == [[1, 2, 4]] and vals.tolist() == [[3., 3., 3.]]


# -------------------------------------- the port's own chunked identities

@pytest.mark.parametrize("S,chunk", [(37, 16), (64, 64), (5, 8), (129, 32)])
def test_ssd_chunked_equals_sequential(S, chunk):
    B, D, N = 2, 32, 8
    p = _carry(rssm.init_ssm(KEY, D, N, expand=2, head_p=8))
    u = torch.from_numpy(_u(B, S, D))
    y = tssm.ssm_forward(p, u, d_state=N, expand=2, head_p=8, chunk=chunk)
    state = tssm.init_ssm_state(B, D, N, expand=2, head_p=8, device="cpu")
    ref = torch.cat([tssm.ssm_decode(p, u[:, t:t + 1], state, d_state=N,
                                     expand=2, head_p=8)[0]
                     for t in range(S)], dim=1)
    _close(y, ref.numpy(), atol=2e-5)


@pytest.mark.parametrize("S,chunk", [(29, 8), (48, 16), (7, 32)])
def test_mlstm_chunked_equals_sequential(S, chunk):
    B, D, H = 2, 32, 4
    p = _carry(rxl.init_mlstm(KEY, D, H))
    u = torch.from_numpy(_u(B, S, D))
    y = txl.mlstm_forward(p, u, n_heads=H, chunk=chunk)
    state = txl.init_mlstm_state(B, D, H, device="cpu")
    ref = torch.cat([txl.mlstm_decode(p, u[:, t:t + 1], state,
                                      n_heads=H)[0] for t in range(S)], 1)
    _close(y, ref.numpy(), atol=2e-5)


@pytest.mark.parametrize("S", [1, 33, 100])
def test_slstm_scan_equals_sequential(S):
    B, D = 2, 16
    p = _carry(rxl.init_slstm(KEY, D))
    u = torch.from_numpy(_u(B, S, D))
    y = txl.slstm_forward(p, u)
    st = txl.init_slstm_state(B, D, device="cpu")
    ref = torch.cat([txl.slstm_decode(p, u[:, t:t + 1], st)[0]
                     for t in range(S)], 1)
    _close(y, ref.numpy(), atol=2e-5)


def test_linear_scan_equals_its_recurrence():
    rng = np.random.default_rng(4)
    f = torch.from_numpy(rng.uniform(0, 1, (3, 77, 5)))
    x = torch.from_numpy(rng.normal(size=(3, 77, 5)))
    h, want = torch.zeros(3, 5, dtype=torch.float64), []
    for t in range(77):
        h = f[:, t] * h + x[:, t]
        want.append(h)
    np.testing.assert_allclose(txl.linear_scan(f, x).numpy(),
                               torch.stack(want, 1).numpy(), rtol=1e-12,
                               atol=1e-12)


def test_ssd_state_is_causal():
    B, S, D, N = 1, 24, 16, 4
    p = _carry(rssm.init_ssm(KEY, D, N, expand=2, head_p=8))
    u = torch.from_numpy(_u(B, S, D, seed=2, scale=1.0))
    y1 = tssm.ssm_forward(p, u, d_state=N, expand=2, head_p=8, chunk=8)
    u2 = u.clone()
    u2[:, -1] = 99.0
    y2 = tssm.ssm_forward(p, u2, d_state=N, expand=2, head_p=8, chunk=8)
    _close(y1[:, :-1], y2[:, :-1].numpy(), atol=1e-5)


@pytest.mark.parametrize("mixer", ["ssm", "mlstm"])
def test_gradients_stay_finite_past_the_exp_range(mixer):
    """A 256-step chunk whose cumulative log decay passes float32's exp
    range (about 88): the reference's where(mask, exp(seg), 0) has
    0 * inf in its gradient there (NaN); the port's masked decay takes
    exp(-inf) = 0 instead. Forward values agree with the reference."""
    B, S, D = 1, 256, 32
    u = _u(B, S, D, seed=5, scale=1.0)
    if mixer == "ssm":
        rp = rssm.init_ssm(KEY, D, 8, expand=2, head_p=8)
        rp = dict(rp, A_log=rp["A_log"] + 1.0)       # decay e^1 per dt
        fwd_r = lambda p, x: rssm.ssm_forward(      # noqa: E731
            p, x, d_state=8, expand=2, head_p=8)
        fwd_t = lambda p, x: tssm.ssm_forward(      # noqa: E731
            p, x, d_state=8, expand=2, head_p=8)
    else:
        rp = rxl.init_mlstm(KEY, D, 4)
        fwd_r = lambda p, x: rxl.mlstm_forward(p, x, n_heads=4)  # noqa
        fwd_t = lambda p, x: txl.mlstm_forward(p, x, n_heads=4)  # noqa
    want = jax.jit(fwd_r)(rp, u)
    tp = T.map(lambda a: a.requires_grad_(True), _carry(rp))
    got = fwd_t(tp, torch.from_numpy(u))
    _close(got, want, atol=1e-4, rtol=1e-4)
    ref_grads = jax.jit(jax.grad(lambda p: fwd_r(p, u).sum()))(rp)
    assert any(np.isnan(np.asarray(g)).any()
               for g in jax.tree.leaves(ref_grads))
    grads = torch.autograd.grad(got.sum(), T.leaves(tp))
    assert all(torch.isfinite(g).all() for g in grads)
