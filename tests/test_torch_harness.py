"""The port's Monte-Carlo and spectral harness against ``repro.core``.

On the CPU every stage of the harness is the reference's float64 NumPy
path, so the pins here are bit for bit (exact equality, no tolerance):
the scheme zoo's assignments and attacks, the batched decoder with its
warm-started labels and the torch propagator (run on the CPU), the
stacked fixed/FRC grids, ``monte_carlo_error`` / ``sweep_error`` /
``sweep_campaign`` rows including ``cov_norm``, the spectra, the closed
forms, the GD traces, the policy-regret report, and the harness CLI's
rows against the reference's benchmark functions at their fast sizes.
Inputs are made with NumPy from seeds and handed to both packages.

Sizes stay small: no m = 6552 decode above trials = 5, no dense SVD at
n = 2184. The card's side of the same functions is in ``chip_smoke.py``
and in the ``cuda`` tests of tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as tc
from repro.core import batched_decoding as rbd
from repro_torch.core import batched_decoding as tbd
from repro_torch.kernels.batched_alpha import ops as ba_ops
from repro_torch.kernels.spectral_matvec import ops as sm_ops

P_GRID = (0.05, 0.1, 0.2, 0.3)
CPU = "cpu"


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _both(name, *args, **kw):
    return getattr(rc, name)(*args, **kw), getattr(tc, name)(*args, **kw)


# ------------------------------------------------ graphs and schemes

@pytest.mark.parametrize("name,args,kw", [
    ("cyclic_mds_assignment", (12, 4), {}),
    ("cyclic_mds_assignment", (13, 3), {}),
    ("bibd_assignment", (13, 4), {}),
    ("bibd_assignment", (7, 3), {"design": "symmetric"}),
    ("bibd_assignment", (9, 3), {"design": "affine"}),
    ("bibd_assignment", (25, 5), {"design": "affine"}),
    ("random_matching_assignment", (12, 4), {"seed": 3}),
    ("random_matching_assignment", (40, 4), {"seed": 0}),
    ("bernoulli_assignment", (10, 20, 3), {"seed": 2}),
])
def test_zoo_assignments_identical(name, args, kw):
    a_r, a_t = _both(name, *args, **kw)
    _eq(a_t.A, a_r.A)
    assert (a_t.name, a_t.n, a_t.m, a_t.machines) == \
        (a_r.name, a_r.n, a_r.m, a_r.machines)
    assert a_t.A.flags.writeable == a_r.A.flags.writeable


def test_graph_constructions_and_spectra_identical():
    for q in (5, 13, 29):
        g_r, g_t = _both("paley_graph", q)
        assert g_t.edges == g_r.edges
        assert g_t.circulant_offsets == g_r.circulant_offsets
        assert g_t.spectral_expansion() == g_r.spectral_expansion()
    g_r, g_t = _both("random_matching_regular_graph", 30, 4, seed=1)
    assert g_t.edges == g_r.edges
    for method in ("dense", "lanczos"):
        assert g_t.spectral_expansion(method) == \
            g_r.spectral_expansion(method)
    _eq(tc.circulant_spectrum(24, (1, 5, 12)),
        rc.circulant_spectrum(24, (1, 5, 12)))
    lps_r = rc.expander_assignment(6552, 6, vertex_transitive=True).graph
    lps_t = tc.expander_assignment(6552, 6, vertex_transitive=True).graph
    assert lps_t.spectral_expansion() == lps_r.spectral_expansion()


@pytest.mark.parametrize("scheme", ["cyclic", "bibd"])
@pytest.mark.parametrize("p", [0.16, 0.31, 0.47])
def test_scheme_aware_attacks_identical(scheme, p):
    a_r, a_t = (_both("cyclic_mds_assignment", 13, 4) if scheme == "cyclic"
                else _both("bibd_assignment", 13, 4))
    _eq(tc.adversarial_mask(a_t, p), rc.adversarial_mask(a_r, p))
    fn = f"adversarial_mask_{scheme}"
    _eq(getattr(tc, fn)(a_t, p), getattr(rc, fn)(a_r, p))


def test_theory_values_identical():
    for p in (0.05, 0.2, 0.3):
        for d in (3, 6):
            for f in ("lower_bound_any_decoding",
                      "lower_bound_fixed_decoding", "lower_bound_fixed_cov",
                      "adversarial_bound_ramanujan", "frc_random_error"):
                assert getattr(tc.theory, f)(p, d) == \
                    getattr(rc.theory, f)(p, d)
            assert tc.theory.adversarial_bound_graph(p, d, 1.7) == \
                rc.theory.adversarial_bound_graph(p, d, 1.7)
        for f in ("adversarial_lower_bound_graph", "frc_adversarial_error"):
            assert getattr(tc.theory, f)(p) == getattr(rc.theory, f)(p)
    args = (1e-3, 10.0, 0.5, 2.0, 3.0, 0.1, 0.2, 40, 1.5)
    assert tc.theory.sgd_iterations(*args) == rc.theory.sgd_iterations(*args)
    args = (1e-3, 0.5, 2.0, 3.0, 0.1, 0.2, 40, 1.5)
    assert tc.theory.sgd_step_size(*args) == rc.theory.sgd_step_size(*args)
    for r in (0.01, 0.5):
        assert tc.theory.adversarial_noise_floor(0.5, 3.0, r, 1.5) == \
            rc.theory.adversarial_noise_floor(0.5, 3.0, r, 1.5)


# -------------------------------------------------- batched decoder

def _graph_pair(m=24, d=3):
    return (rc.expander_assignment(m, d, vertex_transitive=False, seed=1),
            tc.expander_assignment(m, d, vertex_transitive=False, seed=1))


@pytest.mark.parametrize("m,d,trials", [(24, 3, 40), (48, 4, 17),
                                        (6552, 6, 5)])
def test_torch_propagator_on_cpu_equals_numpy(m, d, trials):
    a_r, a_t = (rc.expander_assignment(m, d, vertex_transitive=m > 1000,
                                       seed=1),
                tc.expander_assignment(m, d, vertex_transitive=m > 1000,
                                       seed=1))
    u = np.random.default_rng(m).random((trials, m))
    for p in (0.1, 0.3):
        alive = u >= p
        want = rbd._propagate_numpy(a_r.graph, alive)
        _eq(tbd._propagate_numpy(a_t.graph, alive), want)
        _eq(tbd._propagate_torch(a_t.graph, alive, None,
                                 torch.device(CPU)), want)
        _eq(tc.batched_alpha(a_t, alive, backend="torch", device=CPU),
            rc.batched_alpha(a_r, alive, backend="numpy"))


def test_warm_started_labels_equal_cold_and_reference():
    a_r, a_t = _graph_pair(48, 4)
    u = np.random.default_rng(7).random((30, a_t.m))
    hi, lo = u >= 0.4, u >= 0.2      # nested: lo revives machines
    _, l_hi = tc.batched_alpha(a_t, hi, backend="numpy",
                               return_labels=True)
    _, l_hi_r = rc.batched_alpha(a_r, hi, backend="numpy",
                                 return_labels=True)
    _eq(l_hi, l_hi_r)
    cold, l_cold = tc.batched_alpha(a_t, lo, backend="numpy",
                                    return_labels=True)
    for backend in ("numpy", "torch"):
        warm, l_warm = tc.batched_alpha(a_t, lo, backend=backend,
                                        labels0=l_hi, return_labels=True,
                                        device=CPU)
        _eq(warm, cold)
        _eq(l_warm, l_cold)
    _eq(cold, rc.batched_alpha(a_r, lo, backend="numpy", labels0=l_hi_r))
    with pytest.raises(ValueError, match="labels0 must be"):
        tc.batched_alpha(a_t, lo, labels0=l_hi[:, :5])
    with pytest.raises(ValueError, match="labels0 is only meaningful"):
        tc.batched_alpha(tc.frc_assignment(12, 3),
                         np.ones((2, 12), bool), labels0=l_hi[:2])


def test_backend_dispatch(monkeypatch):
    _, a_t = _graph_pair()
    alive = np.ones((3, a_t.m), bool)
    with pytest.raises(ValueError, match="'torch'"):
        tc.batched_alpha(a_t, alive, backend="jax")
    with pytest.raises(ValueError, match="unknown backend"):
        tc.batched_alpha(a_t, alive, backend="cupy")
    assert tbd._resolve_backend("auto", tbd._TORCH_MIN_WORK, CPU) == \
        "numpy"
    assert tbd._resolve_backend("auto", tbd._TORCH_MIN_WORK - 1,
                                None) == "numpy"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        tbd._resolve_backend("auto", tbd._TORCH_MIN_WORK, None)


def test_fixed_and_frc_grids_identical():
    a_r, a_t = _graph_pair()
    f_r, f_t = rc.frc_assignment(24, 3), tc.frc_assignment(24, 3)
    masks = np.random.default_rng(2).random((3, 20, 24)) >= 0.25
    _eq(tc.fixed_alpha_grid(a_t, masks, (0.1, 0.2, 0.3)),
        rc.fixed_alpha_grid(a_r, masks, (0.1, 0.2, 0.3)))
    _eq(tc.frc_alpha_grid(f_t, masks), rc.frc_alpha_grid(f_r, masks))
    with pytest.raises(ValueError, match="p_grid"):
        tc.fixed_alpha_grid(a_t, masks, (0.1,))


# ----------------------------------------------- Monte-Carlo harness

@pytest.mark.parametrize("method", ["optimal", "fixed"])
@pytest.mark.parametrize("cov_method", ["dense", "lanczos"])
def test_monte_carlo_error_identical(method, cov_method):
    a_r, a_t = _graph_pair()
    for p in (0.1, 0.3):
        kw = dict(trials=60, method=method, seed=3, cov_method=cov_method)
        assert tc.monte_carlo_error(a_t, p, device=CPU, **kw) == \
            rc.monte_carlo_error(a_r, p, **kw)
    alphas = np.random.default_rng(1).normal(1.0, 0.1, (16, 8))
    _eq(tc.debias_alpha(alphas), rc.debias_alpha(alphas))
    assert tc.step_weights.debias_scale(alphas) == \
        ba_ops.debias_scale(alphas)


@pytest.mark.parametrize("scheme", ["expander", "frc", "adjacency",
                                    "cyclic_mds"])
def test_sweep_error_identical(scheme):
    if scheme == "expander":
        a_r, a_t = _graph_pair()
    elif scheme == "frc":
        a_r, a_t = _both("frc_assignment", 24, 3)
    elif scheme == "adjacency":
        a_r = rc.adjacency_assignment(rc.random_regular_graph(24, 3, 2))
        a_t = tc.adjacency_assignment(tc.random_regular_graph(24, 3, 2))
    else:
        a_r, a_t = _both("cyclic_mds_assignment", 12, 4)
    for method in ("optimal", "fixed"):
        kw = dict(trials=40, method=method, seed=5, cov_method="lanczos")
        assert tc.sweep_error(a_t, P_GRID, device=CPU, **kw) == \
            rc.sweep_error(a_r, P_GRID, **kw)


def test_sweep_campaign_identical_on_zoo_and_graph_schemes():
    ents_r = rc.scheme_zoo_entries(3, seed=0)
    ents_t = tc.scheme_zoo_entries(3, seed=0)
    for e_r, e_t in zip(ents_r, ents_t):
        assert e_t.resolved_label() == e_r.resolved_label()
        _eq(e_t.assignment.A, e_r.assignment.A)
    kw = dict(trials=48, seed=1, cov_method="blocked", cov_topk=2)
    assert tc.sweep_campaign(ents_t, P_GRID, device=CPU, **kw) == \
        rc.sweep_campaign(ents_r, P_GRID, **kw)
    a_r, a_t = _graph_pair()
    adv = np.stack([tc.adversarial_mask(a_t, p) for p in P_GRID])[:, None]
    camp_t = tc.sweep_campaign(
        [(a_t, "optimal"), (a_t, "fixed"),
         tc.CampaignEntry(a_t, label="adv", masks=adv, debias=False)],
        P_GRID, trials=30, device=CPU)
    camp_r = rc.sweep_campaign(
        [(a_r, "optimal"), (a_r, "fixed"),
         rc.CampaignEntry(a_r, label="adv", masks=adv, debias=False)],
        P_GRID, trials=30)
    assert camp_t == camp_r


def test_decode_grid_identical_and_checks_nesting():
    a_r, a_t = _graph_pair()
    u = np.random.default_rng(4).random((10, 24))
    masks = np.stack([u >= p for p in (0.3, 0.2, 0.1)])
    _eq(tc.decode_grid(a_t, masks, warm_start=True, device=CPU),
        rc.decode_grid(a_r, masks, warm_start=True))
    with pytest.raises(ValueError, match="nested"):
        tc.decode_grid(a_t, masks[::-1], warm_start=True, device=CPU)


def test_covariance_functions_identical():
    rng = np.random.default_rng(9)
    batch = rng.normal(1.0, 0.05, size=(20, 600))
    stack = rng.normal(1.0, 0.05, size=(3, 12, 600))
    for method in ("dense", "lanczos"):
        assert tc.covariance_spectral_norm(batch, method=method,
                                           device=CPU) == \
            rc.covariance_spectral_norm(batch, method=method)
    for method in ("dense", "lanczos", "blocked"):
        _eq(tc.covariance_spectral_norm_batch(stack, method=method,
                                              device=CPU),
            rc.covariance_spectral_norm_batch(stack, method=method))
    for method in ("dense", "block"):
        _eq(tc.covariance_topk(batch, 3, method=method, device=CPU),
            rc.covariance_topk(batch, 3, method=method))


# -------------------------------------- GD, adaptive policies, harness

def test_gcod_traces_identical():
    a_r, a_t = _graph_pair()
    prob_r = rc.LeastSquares.synthetic(N=96, k=8, noise=1.0,
                                       n_blocks=a_r.n, seed=0)
    prob_t = tc.LeastSquares.synthetic(N=96, k=8, noise=1.0,
                                       n_blocks=a_t.n, seed=0)
    for method in ("optimal", "fixed"):
        kw = dict(steps=20, lr=0.01, method=method, p=0.2, seed=2)
        tr_t = tc.gcod(prob_t, a_t, tc.BernoulliStragglers(m=24, p=0.2),
                       device=CPU, **kw)
        tr_r = rc.gcod(prob_r, a_r, rc.BernoulliStragglers(m=24, p=0.2),
                       **kw)
        assert tr_t.errors == tr_r.errors
        _eq(np.stack(tr_t.thetas), np.stack(tr_r.thetas))
        al = tc.precompute_alphas(a_t, tc.BernoulliStragglers(m=24, p=0.2),
                                  steps=20, method=method, p=0.2, seed=2,
                                  device=CPU)
        _eq(al, np.stack(tr_t.alphas))
    u_t = tc.uncoded_gd(tc.LeastSquares.synthetic(96, 8, 1.0, 24), 24,
                        0.2, steps=10, lr=0.01, device=CPU)
    u_r = rc.uncoded_gd(rc.LeastSquares.synthetic(96, 8, 1.0, 24), 24,
                        0.2, steps=10, lr=0.01)
    assert u_t.errors == u_r.errors


def test_policy_regret_report_identical():
    a_r, a_t = _both("expander_assignment", 12, 4, vertex_transitive=True)
    model = tc.step_weights.make_straggler_model(a_t, "markov", 0.15,
                                                 persistence=8.0)
    _, stream = tc.step_weights.sample_mask_stream(
        a_t, model, steps=120, shuffle=False,
        rng=np.random.default_rng(42))
    pols_t = {"adaptive": tc.AdaptivePolicy(),
              "fixed": tc.StaticPolicy(method="fixed", p=0.1)}
    pols_r = {"adaptive": rc.AdaptivePolicy(),
              "fixed": rc.StaticPolicy(method="fixed", p=0.1)}
    assert tc.policy_regret_report(a_t, stream, pols_t, burn_in=20) == \
        rc.policy_regret_report(a_r, stream, pols_r, burn_in=20)
    assert tc.make_policy("adaptive").decide(
        tc.OnlineStragglerEstimator(12).estimate()) == \
        tc.AdaptivePolicy().decide(tc.OnlineStragglerEstimator(12)
                                   .estimate())


def test_harness_cli_rows_equal_reference_benchmarks(capsys):
    """``launch.harness --fast --device cpu`` against the reference's
    benchmark functions at the same fast sizes."""
    from benchmarks import adversarial as r_adv
    from benchmarks import convergence as r_conv
    from benchmarks import decoding_error as r_dec
    from repro_torch.launch import harness
    out = harness.main(["--fast", "--device", CPU, "--section",
                        "decoding_error,adversarial,convergence"])
    rows = {k: v["rows"] for k, v in out["sections"].items()}
    assert rows["decoding_error"] == r_dec.regime1(trials=50) + \
        r_dec.regime2(trials=5)
    assert rows["adversarial"] == r_adv.run(m=312, d=6)
    assert rows["convergence"] == r_conv.run(m=104, d=4, N=104, k=20,
                                             steps=30, n_lrs=5)
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith('{"device": "cpu", "mode": "fast"')


def test_harness_zoo_section_equals_reference_campaign():
    from repro_torch.launch import harness
    rows = harness.zoo(3, trials=64, device=CPU)
    camp = rc.sweep_campaign(rc.scheme_zoo_entries(3, seed=0),
                             harness.ZOO_P_GRID, trials=64, seed=0,
                             cov=False)
    assert rows == [{"scheme": label, "p": r["p"],
                     "mean_error": r["mean_error"],
                     "std_error": r["std_error"]}
                    for label, rs in camp.items() for r in rs]


def test_harness_cli_rejects_bad_arguments():
    from repro_torch.launch import harness
    with pytest.raises(SystemExit):
        harness.main(["--fast", "--full", "--device", CPU])
    with pytest.raises(SystemExit):
        harness.main(["--section", "figure9", "--device", CPU])


def test_no_fallback_without_a_card(monkeypatch):
    """device=None means the card: without one every harness entry point
    raises instead of running on the CPU."""
    from repro_torch.launch import harness
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, a_t = _graph_pair()
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        harness.main(["--fast", "--section", "zoo"])
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        tc.sweep_campaign([a_t], (0.1,), trials=4)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        tc.monte_carlo_error(a_t, 0.1, trials=4)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        tc.covariance_spectral_norm(np.ones((3, 4)))
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        ba_ops.fused_error(np.ones((3, 4)))
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        sm_ops.prepare_operand(np.ones((3, 4)))
