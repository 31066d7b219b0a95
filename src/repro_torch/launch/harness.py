"""The paper's Monte-Carlo and spectral harness on the port.

    python -m repro_torch.launch.harness [--fast|--full] [--device cpu] \
        [--section NAME,...]

The port's counterpart of the reference's paper-figure functions, with
their paper-claim asserts, one section each (every section by default):

- ``decoding_error``: Figure 3 / Section VIII-B, ``regime1`` (m = 24,
  d = 3, random 3-regular graph) and ``regime2`` (m = 6552, d = 6, the
  LPS X^{5,13} Ramanujan graph, n = 2184), each one ``sweep_campaign``
  (copies of ``benchmarks/decoding_error.py:regime1/regime2``), and the
  compression grid (``compression_campaign`` at the regime-1 scheme,
  trials = 200, dim = 512; the section's ``compression`` rows). Asserts
  that optimal decoding beats the fixed-decoding lower bound at p <= 0.1
  in regime 1, that int8 stays within 1.10x the uncompressed error
  + 1e-3, and that the sign and majority-vote rows lie above it.
- ``adversarial``: Section V / Table I, worst-case error of the expander
  scheme and the FRC under their attacks (a copy of
  ``benchmarks/adversarial.py:run``). Asserts Cor V.2 (ours <= the
  bound) and that the FRC fares no better than ours.
- ``zoo``: the cross-paper Figure-3 grid -- expander, FRC, cyclic-MDS,
  affine BIBD and random matchings at m = q(q+1) under one shared draw
  (the campaign of ``examples/scheme_zoo_figure3.py``).
- ``convergence``: Figures 4/5, coded gradient descent on least squares
  under Bernoulli stragglers (a copy of ``benchmarks/convergence.py:run``)
  with its asserts.
- ``bounds``: Props A.1/A.3 and Table III, Monte-Carlo errors against the
  information-theoretic lower bounds, the FRC meeting Prop A.3 (a copy
  of ``benchmarks/bounds.py:run``, m = 48, d = 4) with its asserts.
- ``expansion``: the Theorem IV.1 ablation, error against spectral
  expansion at equal d over six graphs in one campaign with each row's
  top-3 covariance spectrum (a copy of
  ``benchmarks/expansion_ablation.py:run``, p = 0.3) with its asserts.

``--fast`` (the default) runs the reference benchmark's reduced sizes,
``--full`` the paper's. The harness runs on the card unless
``--device cpu``; on the CPU every row equals the reference's bit for
bit. Rows print as ``key=value`` lines and a summary JSON prints last.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import (BernoulliStragglers, CampaignEntry,
                              LeastSquares, adjacency_assignment,
                              adversarial_mask, compression_campaign,
                              cycle_graph, expander_assignment,
                              frc_assignment, gcod, graph_assignment,
                              hypercube_graph, monte_carlo_error,
                              precompute_alphas, random_regular_graph,
                              scheme_zoo_entries, sweep_campaign, theory,
                              uncoded_assignment, uncoded_gd)
from repro_torch.core.graphs import lps_like_cayley_expander
from repro_torch.device import resolve

SECTIONS = ("decoding_error", "adversarial", "zoo", "convergence",
            "bounds", "expansion")
P_GRID = (0.05, 0.1, 0.15, 0.2, 0.25, 0.3)
ZOO_P_GRID = (0.05, 0.1, 0.15, 0.2, 0.25, 0.3, 0.35, 0.4)


def regime1(trials: int = 200, seed: int = 0, device=None) -> List[Dict]:
    A = expander_assignment(24, 3, vertex_transitive=False, seed=1)
    adj = adjacency_assignment(random_regular_graph(24, 3, seed=2),
                               name="expander[6]")
    camp = sweep_campaign(
        [(A, "optimal"), (A, "fixed"), (adj, "optimal")], P_GRID,
        trials=trials, seed=seed, device=device)
    opt = camp[f"{A.name}:optimal"]
    fix = camp[f"{A.name}:fixed"]
    exp6 = camp["expander[6]:optimal"]
    rows = []
    for i, p in enumerate(P_GRID):
        rows.append({
            "regime": "m24_d3", "p": p,
            "ours_optimal": opt[i]["mean_error"],
            "ours_optimal_cov": opt[i]["cov_norm"],
            "ours_fixed": fix[i]["mean_error"],
            "ours_fixed_cov": fix[i]["cov_norm"],
            "expander6_optimal": exp6[i]["mean_error"],
            "frc_optimal(theory)": theory.frc_random_error(p, 3),
            "lower_bound": theory.lower_bound_any_decoding(p, 3),
            "fixed_lower_bound": theory.lower_bound_fixed_decoding(p, 3),
        })
    return rows


def regime2(trials: int = 30, seed: int = 0, device=None) -> List[Dict]:
    A = expander_assignment(6552, 6, vertex_transitive=True, seed=0)
    camp = sweep_campaign([(A, "optimal"), (A, "fixed")], P_GRID,
                          trials=trials, seed=seed, device=device)
    opt = camp[f"{A.name}:optimal"]
    fix = camp[f"{A.name}:fixed"]
    rows = []
    for i, p in enumerate(P_GRID):
        rows.append({
            "regime": "m6552_d6_LPS", "p": p,
            "ours_optimal": opt[i]["mean_error"],
            "ours_optimal_cov": opt[i]["cov_norm"],
            "ours_fixed": fix[i]["mean_error"],
            "ours_fixed_cov": fix[i]["cov_norm"],
            "frc_optimal(theory)": theory.frc_random_error(p, 6),
            "lower_bound": theory.lower_bound_any_decoding(p, 6),
            "fixed_lower_bound": theory.lower_bound_fixed_decoding(p, 6),
        })
    return rows


def adversarial(m: int = 6552, d: int = 6, vertex_transitive: bool = True,
                device=None) -> List[Dict]:
    A = expander_assignment(m, d, vertex_transitive=vertex_transitive,
                            seed=0)
    F = frc_assignment(m, d)
    lam = A.graph.spectral_expansion()
    # Def I.3 attacks are deterministic: one "trial" per grid point, raw
    # (1/n)|alpha - 1|^2 errors (debias off) as the tables report them.
    camp = sweep_campaign(
        [CampaignEntry(A, "optimal", label="ours", debias=False,
                       masks=np.stack([adversarial_mask(A, p)
                                       for p in P_GRID])[:, None, :]),
         CampaignEntry(F, "optimal", label="frc", debias=False,
                       masks=np.stack([adversarial_mask(F, p)
                                       for p in P_GRID])[:, None, :])],
        P_GRID, trials=1, cov=False, device=device)
    rows = []
    for i, p in enumerate(P_GRID):
        rows.append({
            "m": m, "d": d, "p": p, "lambda": lam,
            "ours_adversarial": camp["ours"][i]["mean_error"],
            "frc_adversarial": camp["frc"][i]["mean_error"],
            "cor_v2_bound": theory.adversarial_bound_graph(p, d, lam),
            "graph_lower_bound": theory.adversarial_lower_bound_graph(p),
            "frc_theory": theory.frc_adversarial_error(p),
        })
    return rows


def zoo(q: int = 3, trials: int = 2000, seed: int = 0,
        device=None) -> List[Dict]:
    """The five schemes at m = q(q+1) under ONE shared uniform draw."""
    camp = sweep_campaign(scheme_zoo_entries(q, seed=seed), ZOO_P_GRID,
                          trials=trials, seed=seed, cov=False,
                          device=device)
    return [{"scheme": label, "p": r["p"], "mean_error": r["mean_error"],
             "std_error": r["std_error"]}
            for label, rows in camp.items() for r in rows]


def _grid_best(run_fn, lrs) -> Dict:
    best = None
    for lr in lrs:
        tr = run_fn(lr)
        err = tr.errors[-1]
        if not np.isfinite(err):
            continue
        if best is None or err < best["final_error"]:
            best = {"final_error": err, "lr": lr, "errors": tr.errors}
    return best or {"final_error": float("inf"), "lr": None,
                    "errors": []}


def convergence(m: int = 312, d: int = 6, N: int = 312, k: int = 40,
                p: float = 0.2, steps: int = 50, noise: float = 1.0,
                seed: int = 0, n_lrs: int = 8,
                device=None) -> List[Dict]:
    def prob_with(n_blocks):
        return LeastSquares.synthetic(N=N, k=k, noise=noise,
                                      n_blocks=n_blocks, seed=seed)
    prob = prob_with(2 * m // d)       # ours: n = 2m/d
    prob_frc = prob_with(m // d)       # FRC: n = m/d
    lrs = np.geomspace(1e-5, 3e-1, n_lrs)

    def model():
        return BernoulliStragglers(m=m, p=p)
    A_ours = expander_assignment(m, d, vertex_transitive=False, seed=0)
    A_frc = frc_assignment(m, d)
    rows = []

    def add(name, run_fn):
        best = _grid_best(run_fn, lrs)
        rows.append({"scheme": name, "p": p,
                     "final_error": best["final_error"],
                     "lr": best["lr"],
                     "first_error": best["errors"][0]
                     if best["errors"] else float("nan")})

    # Each scheme's mask stream is decoded once and replayed across the
    # step-size grid (the draws depend on (model, seed), not on lr).
    def pre(assignment, method, n_steps=steps):
        return precompute_alphas(assignment, model(), steps=n_steps,
                                 method=method, p=p, seed=seed,
                                 device=device)

    al_opt = pre(A_ours, "optimal")
    add("ours_optimal", lambda lr: gcod(
        prob, A_ours, model(), steps=steps, lr=lr, method="optimal",
        p=p, seed=seed, alphas=al_opt))
    al_fix = pre(A_ours, "fixed")
    add("ours_fixed", lambda lr: gcod(
        prob, A_ours, model(), steps=steps, lr=lr, method="fixed",
        p=p, seed=seed, alphas=al_fix))
    al_frc = pre(A_frc, "optimal")
    add("frc_optimal", lambda lr: gcod(
        prob_frc, A_frc, model(), steps=steps, lr=lr, method="optimal",
        p=p, seed=seed, alphas=al_frc))
    prob6 = prob_with(m)
    A6 = adjacency_assignment(random_regular_graph(m, d, seed=3),
                              name="expander6")
    al_6 = pre(A6, "fixed")
    add("expander6_fixed", lambda lr: gcod(
        prob6, A6, model(), steps=steps, lr=lr, method="fixed", p=p,
        seed=seed, alphas=al_6))
    al_unc = pre(uncoded_assignment(m), "fixed", n_steps=d * steps)
    add("uncoded_ignore", lambda lr: uncoded_gd(
        prob6, m, p, steps=d * steps, lr=lr, seed=seed, alphas=al_unc))
    return rows


def compression(trials: int = 200, dim: int = 512, seed: int = 0,
                device=None) -> List[Dict]:
    """The error-vs-p-vs-bits grid at the regime-1 scheme (m = 24,
    d = 3), as ``benchmarks/decoding_error.py`` runs it."""
    A = expander_assignment(24, 3, vertex_transitive=False, seed=1)
    return compression_campaign(A, P_GRID, trials=trials, dim=dim,
                                seed=seed, device=device)


def bounds(m: int = 48, d: int = 4, trials: int = 400,
           device=None) -> List[Dict]:
    """Props A.1/A.3, Table III: Monte-Carlo errors beside the lower
    bounds (a copy of ``benchmarks/bounds.py:run``)."""
    A = expander_assignment(m, d, vertex_transitive=False, seed=0)
    F = frc_assignment(m, d)
    rows = []
    for p in (0.1, 0.2, 0.3):
        opt = monte_carlo_error(A, p, trials=trials, method="optimal",
                                device=device)
        fix = monte_carlo_error(A, p, trials=trials, method="fixed",
                                device=device)
        frc = monte_carlo_error(F, p, trials=trials, method="optimal",
                                device=device)
        rows.append({
            "p": p, "d": d, "trials": trials, "n": A.n,
            "ours_optimal": opt["mean_error"],
            "ours_fixed": fix["mean_error"],
            "frc_optimal": frc["mean_error"],
            "bound_any": theory.lower_bound_any_decoding(p, d),
            "bound_fixed": theory.lower_bound_fixed_decoding(p, d),
        })
    return rows


def expansion(p: float = 0.3, trials: int = 300,
              device=None) -> List[Dict]:
    """Theorem IV.1 ablation: graphs of equal d and n but different
    spectral expansion in one campaign, with each row's top-3
    covariance spectrum (a copy of
    ``benchmarks/expansion_ablation.py:run``)."""
    cases = [
        ("cycle_n64_d2", cycle_graph(64)),
        ("hypercube_d4", hypercube_graph(4)),              # n=16, lam=2
        ("circulant_n16_d4", lps_like_cayley_expander(16, 4, seed=0)),
        ("random_regular_n16_d4", random_regular_graph(16, 4, seed=0)),
        ("random_regular_n64_d4", random_regular_graph(64, 4, seed=0)),
        ("random_regular_n64_d6", random_regular_graph(64, 6, seed=0)),
    ]
    entries = [CampaignEntry(graph_assignment(g, name=name), "optimal",
                             label=name) for name, g in cases]
    camp = sweep_campaign(entries, (p,), trials=trials, cov=False,
                          cov_topk=3, device=device)
    rows = []
    for name, g in cases:
        mc = camp[name][0]
        rows.append({"graph": name, "n": g.n, "d": g.replication_factor,
                     "lambda": g.spectral_expansion(), "p": p,
                     "error": mc["mean_error"],
                     "cov_top3": [round(x, 6) for x in mc["cov_topk"]]})
    return rows


def check_decoding_error(rows: List[Dict]) -> None:
    """Paper claim: optimal decoding is near the p^d/(1-p^d) optimum for
    small p and far below the fixed-coefficient bound (regime 1)."""
    for r in rows:
        if r["regime"] == "m24_d3" and r["p"] <= 0.1 and \
                not r["ours_optimal"] < r["fixed_lower_bound"]:
            raise AssertionError(f"regime 1: optimal decoding is not "
                                 f"below the fixed lower bound: {r}")


def check_adversarial(rows: List[Dict]) -> None:
    """Cor V.2 holds for the attacked graph scheme, and the FRC attack
    does at least as much damage as ours."""
    for r in rows:
        if not r["ours_adversarial"] <= r["cor_v2_bound"] + 1e-9:
            raise AssertionError(f"Cor V.2 bound violated: {r}")
        if not r["frc_adversarial"] >= r["ours_adversarial"]:
            raise AssertionError(f"FRC fared better than ours: {r}")


def check_convergence(rows: List[Dict]) -> None:
    """Optimal decoding converges no worse than fixed decoding or the
    expander code of [6] (5 % slack, the reference's)."""
    by = {r["scheme"]: r["final_error"] for r in rows}
    if not by["ours_optimal"] <= by["ours_fixed"] * 1.05 or \
            not by["ours_optimal"] <= by["expander6_fixed"] * 1.05:
        raise AssertionError(f"convergence claim failed: {by}")


def check_compression(rows: List[Dict]) -> None:
    """int8 noise stays in the straggler-error floor (1.10x + 1e-3); the
    sign rows, optimally decoded or voted, lie above the uncompressed
    error."""
    by_p: Dict[float, Dict[str, float]] = {}
    for r in rows:
        by_p.setdefault(r["p"], {})[
            f"{r['codec']}:{r['decoding']}"] = r["mean_error"]
    for p, errs in by_p.items():
        none_e = errs["none:optimal"]
        if errs["int8:optimal"] > none_e * 1.10 + 1e-3:
            raise AssertionError(f"int8 error {errs['int8:optimal']:.3e} "
                                 f"at p={p} exceeds 1.10x uncompressed "
                                 f"({none_e:.3e}) + 1e-3")
        for key in ("sign:optimal", "sign:majority_vote"):
            if errs[key] <= none_e:
                raise AssertionError(f"{key} error {errs[key]:.3e} at "
                                     f"p={p} should exceed the "
                                     f"uncompressed error {none_e:.3e}")


def check_bounds(rows: List[Dict]) -> None:
    """Monte-Carlo errors respect the lower bounds (0.85 slack for the
    noise; the any-decoding bound only where the expected erasure count
    is at least 5), and the FRC meets Prop A.3."""
    slack = 0.85
    for r in rows:
        if r["trials"] * r["n"] * r["bound_any"] >= 5:
            if not r["ours_optimal"] >= r["bound_any"] * slack:
                raise AssertionError(f"below the any-decoding bound: {r}")
            if not abs(r["frc_optimal"] - r["bound_any"]) <= \
                    0.5 * r["bound_any"] + 5e-3:
                raise AssertionError(f"FRC off Prop A.3: {r}")
        if not r["ours_fixed"] >= r["bound_fixed"] * slack:
            raise AssertionError(f"below the fixed-decoding bound: {r}")


def check_expansion(rows: List[Dict]) -> None:
    """The d = 2 cycle is far worse than a d = 4 graph, and d = 6 no
    worse than d = 4 at the same n."""
    by = {r["graph"]: r["error"] for r in rows}
    if not by["cycle_n64_d2"] > 2 * by["random_regular_n64_d4"]:
        raise AssertionError(f"cycle not worse than d=4: {by}")
    if not by["random_regular_n64_d6"] <= \
            by["random_regular_n64_d4"] + 1e-3:
        raise AssertionError(f"d=6 worse than d=4: {by}")


def run_section(name: str, fast: bool, device) -> Dict[str, List[Dict]]:
    """One section at the fast or the paper size, asserts included:
    ``{"rows": [...]}``, plus ``"compression"`` for decoding_error."""
    out = {}
    if name == "decoding_error":
        rows = regime1(trials=50 if fast else 200, device=device)
        rows += regime2(trials=5 if fast else 30, device=device)
        check_decoding_error(rows)
        out["compression"] = compression(device=device)
        check_compression(out["compression"])
    elif name == "adversarial":
        rows = adversarial(m=312 if fast else 6552, d=6, device=device)
        check_adversarial(rows)
    elif name == "zoo":
        rows = zoo(3, trials=256 if fast else 2000, device=device)
    elif name == "convergence":
        rows = convergence(m=104 if fast else 312, d=4 if fast else 6,
                           N=104 if fast else 312, k=20 if fast else 40,
                           steps=30 if fast else 50,
                           n_lrs=5 if fast else 8, device=device)
        check_convergence(rows)
    elif name == "bounds":
        rows = bounds(trials=150 if fast else 400, device=device)
        check_bounds(rows)
    elif name == "expansion":
        rows = expansion(trials=100 if fast else 300, device=device)
        check_expansion(rows)
    else:
        raise ValueError(f"unknown section {name!r}; known: {SECTIONS}")
    return {"rows": rows, **out}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--section", default=",".join(SECTIONS),
                    help=f"comma-separated, from {','.join(SECTIONS)}")
    ap.add_argument("--fast", action="store_true",
                    help="reduced sizes (the default unless --full)")
    ap.add_argument("--full", action="store_true",
                    help="the paper's sizes")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.fast and args.full:
        ap.error("--fast and --full are mutually exclusive")
    sections = [s for s in args.section.split(",") if s]
    for s in sections:
        if s not in SECTIONS:
            ap.error(f"unknown section {s!r}; known: {','.join(SECTIONS)}")
    device = resolve(args.device)
    fast = not args.full
    summary = {"device": str(device), "mode": "fast" if fast else "full",
               "sections": {}}
    for name in sections:
        t0 = time.perf_counter()
        out = run_section(name, fast, device)
        seconds = time.perf_counter() - t0
        for rows in out.values():
            for r in rows:
                print(",".join(f"{k}={v:.4g}" if isinstance(v, float)
                               else f"{k}={v}" for k, v in r.items()),
                      flush=True)
        summary["sections"][name] = {"seconds": seconds, **out}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
