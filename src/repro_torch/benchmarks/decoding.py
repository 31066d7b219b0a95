"""Decoder throughput and grid-sweep timings at the paper's scale.

Port of ``speed_report`` and ``sweep_report`` of
``benchmarks/decoding_error.py``: on the card m = 6552 machines, d = 6,
the LPS X^{5,13} graph (n = 2184), in every mode. On the CPU
(``--device cpu``) both run at m = 768, d = 6 (a vertex-transitive
circulant expander, n = 256): the paper's scale needs six dense
2184 x 2184 covariance SVDs on the host, minutes on a busy CPU, and a
CPU run checks paths and acceptances, not speed. On the card the batched
decode runs the torch label propagator at >= 200,000 mask entries, the
per-trial errors K6 ``fused_error`` and every matrix-free covariance
norm K7a ``gram_matvec`` (Lanczos) or K7b ``gram_matvec_batch``
(blocked Lanczos); the Lanczos orchestration, the scalar decoder and
the dense SVDs stay on the host, as in the reference. On the CPU every
number the reference computes comes out bit for bit (its NumPy paths).

* ``speed_report``: the scalar decoder (one mask at a time) against
  ``monte_carlo_error`` at 1000 trials, cov off, trials per second.
* ``sweep_report``: the regime-2 grid (6 p-points, 30 trials, cov on)
  as the per-point ``monte_carlo_error`` loop (dense covariance SVD) and
  as one ``sweep_error`` (Lanczos), mean/std bit-identical and
  covariance norms within 1e-6 relative on the host float64 path (5e-3
  where the Gram matvec runs in float32 on the card); the spectral
  primitives; ``sweep_campaign`` against the sequential per-scheme
  loop (bit-identical; >= 1.25x on the card); the compression grid
  (m = 24); the scheme zoo at m = 12 against its per-point oracles; and
  the adaptive-regret row (the adaptive policy must beat the best
  static fixed-decoding policy). Each check raises inline.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from repro_torch.core import (AdaptivePolicy, StaticPolicy, decode,
                              expander_assignment, monte_carlo_error,
                              policy_regret_report, scheme_zoo_entries,
                              spectral, sweep_campaign, sweep_error)
from repro_torch.core.compress import compression_campaign
from repro_torch.core.step_weights import (make_straggler_model,
                                           sample_mask_stream)
from repro_torch.kernels.spectral_matvec import ops as sm_ops

P_GRID = (0.05, 0.1, 0.15, 0.2, 0.25, 0.3)
# (m, d) by device type: the paper's regime 2 on the card
SCALE = {"cuda": (6552, 6), "cpu": (768, 6)}


def _scheme(dev):
    m, d = SCALE[torch.device(dev).type]
    A = expander_assignment(m, d, vertex_transitive=True, seed=0)
    return A, m, d, ("LPS X^{5,13}" if m == 6552 else
                     "vertex-transitive circulant expander")


def speed_report(dev, fast: bool = False) -> Dict:
    """Decoder throughput: the per-mask scalar decode loop against
    ``monte_carlo_error`` (sampling, batched decode, fused error; cov
    off), warmed once at the benchmark shape."""
    A, m, d, graph = _scheme(dev)
    p = 0.1
    scalar_trials = 3 if fast else 10
    batched_trials = 1000

    rng = np.random.default_rng(0)
    masks = rng.random((scalar_trials, m)) >= p
    t0 = time.perf_counter()
    for t in range(scalar_trials):
        decode(A, masks[t], method="optimal")
    scalar_s = time.perf_counter() - t0

    monte_carlo_error(A, p, trials=batched_trials, method="optimal",
                      cov=False, device=dev)
    t0 = time.perf_counter()
    batched = monte_carlo_error(A, p, trials=batched_trials,
                                method="optimal", cov=False, device=dev)
    batched_s = time.perf_counter() - t0
    scalar_tps = scalar_trials / scalar_s
    batched_tps = batched_trials / batched_s
    return {
        "m": m, "d": d, "p": p, "graph": graph,
        "scalar": {"trials": scalar_trials, "seconds": scalar_s,
                   "trials_per_sec": scalar_tps},
        "batched": {"trials": batched_trials, "seconds": batched_s,
                    "trials_per_sec": batched_tps,
                    "mean_error": batched["mean_error"],
                    "std_error": batched["std_error"]},
        "speedup": batched_tps / scalar_tps,
        "note": ("scalar = per-mask optimal decode; batched = the full "
                 "monte_carlo_error (sampling + batched decode + fused "
                 "error), cov off"),
    }


def sweep_report(dev) -> Dict:
    """Grid seconds, spectral timings, the campaign, the compression
    grid, the zoo and the adaptive-regret row, with their checks."""
    A, m, d, graph = _scheme(dev)
    trials = 30
    n = A.n

    t0 = time.perf_counter()
    per_point = [monte_carlo_error(A, p, trials=trials, method="optimal",
                                   seed=0, device=dev) for p in P_GRID]
    loop_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = sweep_error(A, P_GRID, trials=trials, method="optimal", seed=0,
                       cov_method="lanczos", device=dev)
    sweep_s = time.perf_counter() - t0

    bit_identical = all(
        r["mean_error"] == q["mean_error"]
        and r["std_error"] == q["std_error"]
        for r, q in zip(rows, per_point))
    cov_rel = max(abs(r["cov_norm"] - q["cov_norm"]) /
                  max(abs(q["cov_norm"]), 1e-30)
                  for r, q in zip(rows, per_point))
    # 1e-6 is a float64 property; the card's Gram matvec is float32
    cov_tol = 5e-3 if sm_ops.uses_kernel(dev) else 1e-6
    if not bit_identical:
        raise AssertionError("sweep_error diverged from per-point "
                             f"monte_carlo_error: {rows} vs {per_point}")
    if cov_rel > cov_tol:
        raise AssertionError(f"matrix-free cov norm off by {cov_rel:.3e} "
                             f"rel (> {cov_tol:g})")

    rng = np.random.default_rng(0)
    ab = rng.normal(loc=1.0, scale=0.05, size=(trials, n))
    t0 = time.perf_counter()
    dense_norm = spectral.covariance_spectral_norm(ab, method="dense",
                                                   device=dev)
    cov_dense_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lanczos_norm = spectral.covariance_spectral_norm(ab, method="lanczos",
                                                     device=dev)
    cov_lanczos_s = time.perf_counter() - t0
    lam2_impl = spectral.graph_lambda2.__wrapped__
    t0 = time.perf_counter()
    lam2_dense = lam2_impl(A.graph, "dense")
    lam2_dense_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lam2_lanczos = lam2_impl(A.graph, "lanczos")
    lam2_lanczos_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    spectral.circulant_spectrum(n, tuple(range(1, d // 2 + 1)))
    fft_s = time.perf_counter() - t0

    stack = rng.normal(loc=1.0, scale=0.05, size=(12, trials, n))
    t0 = time.perf_counter()
    per_slice = spectral.covariance_spectral_norm_batch(
        stack, method="lanczos", device=dev)
    cov_loop_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    blocked = spectral.covariance_spectral_norm_batch(
        stack, method="blocked", device=dev)
    cov_blocked_s = time.perf_counter() - t0
    blocked_rel = float(np.max(np.abs(blocked - per_slice) /
                               np.maximum(np.abs(per_slice), 1e-30)))

    entries = [(A, "optimal"), (A, "fixed")]
    t0 = time.perf_counter()
    seq = {f"{A.name}:{method}": sweep_error(
        A, P_GRID, trials=trials, method=method, seed=0,
        cov_method="lanczos", device=dev) for _, method in entries}
    seq_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    camp = sweep_campaign(entries, P_GRID, trials=trials, seed=0,
                          cov_method="blocked", device=dev)
    camp_s = time.perf_counter() - t0
    camp_cov_rel = 0.0
    for label, rows_seq in seq.items():
        for r_c, r_s in zip(camp[label], rows_seq):
            if r_c["mean_error"] != r_s["mean_error"] or \
                    r_c["std_error"] != r_s["std_error"]:
                raise AssertionError(
                    f"campaign diverged from per-scheme sweep_error at "
                    f"{label} p={r_s['p']}: {r_c} vs {r_s}")
            camp_cov_rel = max(camp_cov_rel,
                               abs(r_c["cov_norm"] - r_s["cov_norm"]) /
                               max(abs(r_s["cov_norm"]), 1e-30))
    if camp_cov_rel > cov_tol:
        raise AssertionError(f"campaign blocked cov off by "
                             f"{camp_cov_rel:.3e} rel (> {cov_tol:g})")
    campaign_speedup = seq_s / camp_s
    # a speed floor is a measurement: it holds on the card; a CPU run
    # (a shared host, at m = 768) records the ratio and checks the rest
    if campaign_speedup < 1.25 and sm_ops.uses_kernel(dev):
        raise AssertionError(
            f"campaign speedup {campaign_speedup:.2f}x < 1.25x over the "
            f"sequential per-scheme loop ({seq_s:.3f}s vs {camp_s:.3f}s)")

    A_c = expander_assignment(24, 3, vertex_transitive=False, seed=1)
    comp_trials, comp_dim = 200, 512
    t0 = time.perf_counter()
    comp_rows = compression_campaign(A_c, P_GRID, trials=comp_trials,
                                     dim=comp_dim, seed=0, device=dev)
    comp_s = time.perf_counter() - t0
    by_p: Dict[float, Dict[str, float]] = {}
    for r in comp_rows:
        by_p.setdefault(r["p"], {})[
            f"{r['codec']}:{r['decoding']}"] = r["mean_error"]
    for p, errs in by_p.items():
        none_e = errs["none:optimal"]
        if errs["int8:optimal"] > none_e * 1.10 + 1e-3:
            raise AssertionError(f"int8 decoding error at p={p} exceeds "
                                 f"1.10x uncompressed + 1e-3")
        for key in ("sign:optimal", "sign:majority_vote"):
            if errs[key] <= none_e:
                raise AssertionError(f"{key} error at p={p} should "
                                     "exceed the uncompressed error")

    zoo_entries = scheme_zoo_entries(3, seed=0)
    zoo_trials = 256
    t0 = time.perf_counter()
    zoo_camp = sweep_campaign(zoo_entries, P_GRID, trials=zoo_trials,
                              seed=0, cov=False, device=dev)
    zoo_camp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    zoo_rows = {}
    for e in zoo_entries:
        label = e.resolved_label()
        for i, p in enumerate(P_GRID):
            oracle = monte_carlo_error(e.assignment, p, trials=zoo_trials,
                                       seed=0, method=e.method, cov=False,
                                       device=dev)
            row = zoo_camp[label][i]
            if row["mean_error"] != oracle["mean_error"] or \
                    row["std_error"] != oracle["std_error"]:
                raise AssertionError(
                    f"scheme-zoo campaign diverged from per-point "
                    f"monte_carlo_error at {label} p={p}")
        zoo_rows[label] = [{"p": r["p"], "mean_error": r["mean_error"]}
                           for r in zoo_camp[label]]
    zoo_oracle_s = time.perf_counter() - t0

    A_z = zoo_entries[0].assignment  # expander, m = 12
    true_p, persistence, steps, burn_in = 0.15, 8.0, 400, 50
    markov = make_straggler_model(A_z, "markov", true_p,
                                  persistence=persistence)
    _, stream = sample_mask_stream(A_z, markov, steps=steps, shuffle=False,
                                   rng=np.random.default_rng(42))
    fixed_grid = (0.05, 0.1, 0.15, 0.2, 0.3)
    policies = {"adaptive": AdaptivePolicy()}
    for p_f in fixed_grid:
        policies[f"static_fixed(p={p_f})"] = StaticPolicy(method="fixed",
                                                          p=p_f)
    t0 = time.perf_counter()
    regret = policy_regret_report(A_z, stream, policies, burn_in=burn_in)
    regret_s = time.perf_counter() - t0
    best_fixed = min(v["regret"] for k, v in regret.items()
                     if k.startswith("static_fixed"))
    if regret["adaptive"]["regret"] >= best_fixed:
        raise AssertionError(
            f"adaptive regret {regret['adaptive']['regret']:.3e} does not "
            f"beat the best static fixed policy ({best_fixed:.3e})")

    return {
        "regime2_grid": {
            "m": m, "d": d, "n": n, "graph": graph,
            "p_grid": list(P_GRID), "trials": trials, "cov": True,
            "per_point_seconds": loop_s, "sweep_seconds": sweep_s,
            "speedup": loop_s / sweep_s,
            "bit_identical_mean_std": bit_identical,
            "cov_norm_max_rel_diff": cov_rel, "cov_tol": cov_tol,
        },
        "campaign": {
            "schemes": list(seq), "p_grid": list(P_GRID), "trials": trials,
            "sequential_seconds": seq_s, "campaign_seconds": camp_s,
            "speedup": campaign_speedup,
            "bit_identical_mean_std": True,  # enforced above
            "cov_norm_max_rel_diff": camp_cov_rel,
        },
        "spectral": {
            "cov_dense_svd_seconds": cov_dense_s,
            "cov_lanczos_seconds": cov_lanczos_s,
            "cov_rel_diff": abs(lanczos_norm - dense_norm) /
            max(abs(dense_norm), 1e-30),
            "cov_batch12_lanczos_loop_seconds": cov_loop_s,
            "cov_batch12_blocked_seconds": cov_blocked_s,
            "cov_blocked_rel_diff": blocked_rel,
            "lambda2_dense_seconds": lam2_dense_s,
            "lambda2_lanczos_seconds": lam2_lanczos_s,
            "lambda2_abs_diff": abs(lam2_lanczos - lam2_dense),
            "circulant_fft_seconds": fft_s,
        },
        "compression_grid": {
            "m": A_c.m, "d": 3, "graph": "random 3-regular",
            "p_grid": list(P_GRID), "trials": comp_trials,
            "dim": comp_dim, "seconds": comp_s, "rows": comp_rows,
        },
        "scheme_zoo": {
            "q": 3, "m": 12, "d": 4,
            "schemes": [e.resolved_label() for e in zoo_entries],
            "p_grid": list(P_GRID), "trials": zoo_trials,
            "campaign_seconds": zoo_camp_s,
            "per_point_oracle_seconds": zoo_oracle_s,
            "bit_identical_to_oracle": True,  # enforced above
            "rows": zoo_rows,
        },
        "adaptive_regret": {
            "scheme": A_z.name, "m": A_z.m, "straggler_model": "markov",
            "true_p": true_p, "persistence": persistence, "steps": steps,
            "burn_in": burn_in, "seconds": regret_s, "policies": regret,
            "best_static_fixed_regret": best_fixed,
            "adaptive_beats_best_static_fixed": True,  # enforced above
        },
        "note": ("per_point = the monte_carlo_error loop (dense "
                 "covariance SVD per p); sweep = sweep_error (shared "
                 "uniforms, warm-started labels, matrix-free cov norm); "
                 "campaign = sweep_campaign over [optimal, fixed] vs "
                 "the sequential per-scheme sweep_error loop"),
    }
