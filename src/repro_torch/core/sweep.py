"""Grid-sweep Monte-Carlo engine: a whole (p_grid x trials) campaign
through one amortized decoding pipeline per scheme.

Common-random-numbers protocol
------------------------------
``monte_carlo_error(A, p, trials=T, seed=s)`` draws its masks as
``default_rng(s).random((T, m)) >= p`` -- the *same* uniforms for every
p. The sweep makes that sharing explicit: it samples
``u ~ U[0,1)^(T, m)`` once and derives ``alive = u >= p`` for every
grid point, so per-point results are bit-identical to calling
``monte_carlo_error`` once per p with the same seed, while paying mask
sampling and graph preprocessing (``_cover_dense`` and its device
tables) exactly once.

Warm-started labels
-------------------
Under shared uniforms the masks are *nested in p*: lowering p only
revives machines. The graph decoder therefore walks the grid in
descending p, seeding each point's label propagation with the previous
point's fixed-point cover labels: a finer component structure whose
labels are valid upper bounds for the coarser one, so min-propagation
converges in the few rounds it takes newly revived edges to merge
components -- and, because the fixed point (per-component label
minima) is seed-independent, alphas stay bit-identical to cold starts.

The per-p statistics then run through the fused ``batched_alpha``
error kernel and, for the covariance norm, the matrix-free spectral
pipeline (``core.spectral``) -- O(trials * n * iters) Lanczos instead
of the dense n x n SVD that dominated the per-point harness at the
paper's n=2184 scale.

Campaigns
---------
The paper's headline comparisons are *cross-scheme* (Figure 3,
Table I: ours vs FRC vs the expander code of [6] on the same straggler
draw). ``sweep_campaign`` runs several schemes' whole grids through
one pipeline: one uniform draw and mask stack per machine count, the
entire fixed/FRC grid as one stacked exact-counts GEMM, graph decodes
warm-started per scheme, and every (scheme, p) covariance norm from
one blocked lockstep Lanczos. Per-(scheme, p) rows stay bit-identical
to per-scheme ``sweep_error`` (the oracle this engine is
differential-tested against in tests/test_campaign.py).

Scheme zoo
----------
``scheme_zoo_entries(q)`` packages the cross-paper comparison grid:
every rival construction cited in PAPERS.md, instantiated at the ONE
machine count m = q(q+1) they all share (q an affine-plane order), so
the whole zoo faces the same ``bernoulli_uniforms(m, trials, seed)``
draw. At the default q=3 (m=12, d=q+1=4) the ``CampaignEntry`` table
is:

=====================  =======================================  ===  ==========
label                  construction                             n    decode
=====================  =======================================  ===  ==========
expander:optimal       paper's d-regular vertex-transitive      6    O(m) graph
                       expander (Def II.1)
frc:fixed              fractional repetition code (Table I)     3    counts GEMM
cyclic_mds:optimal     circulant shifted code (Raviv et al.,    12   pinv Eq. 9
                       1707.03858)
bibd_affine:optimal    affine-plane AG(2,q) block design        9    pinv Eq. 9
                       (Kadhe et al., 1904.13373); load q,
                       replication q+1
random_regular:        union of d random perfect matchings      6    O(m) graph
optimal                (Charles et al., 1711.06771)
=====================  =======================================  ===  ==========

Each entry's campaign rows are pinned bit-for-bit against its own
per-point oracle -- ``sweep_error`` and scalar ``monte_carlo_error``
-- in tests/test_scheme_zoo.py, and the cyclic/BIBD adversarial worst
cases against C(m, pm) brute force in
tests/test_adversarial_oracle.py.

Devices
-------
Copy of ``repro.core.sweep``. ``decode_grid``, ``sweep_error`` and
``sweep_campaign`` take a ``device`` (``None`` means the card) and hand
it to the decoder, the fused error reduction and the spectral pipeline.
On the CPU every stage is the reference's float64 NumPy path, so rows
are bit-identical to ``repro.core``; on the card the torch label
propagator (above its work threshold), the ``fused_error`` kernel and
the Gram-matvec kernels run on the device, while the decode's alpha
table and the Lanczos orchestration stay on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..device import resolve
from ..kernels.batched_alpha import ops as _ba_ops
from .assignment import (Assignment, bibd_assignment,
                         cyclic_mds_assignment, expander_assignment,
                         frc_assignment, random_matching_assignment)
from .batched_decoding import (batched_alpha, fixed_alpha_grid,
                               frc_alpha_grid, is_graph_scheme)
from .spectral import (covariance_spectral_norm,
                       covariance_spectral_norm_batch, covariance_topk)


def bernoulli_uniforms(m: int, trials: int, seed: int = 0) -> np.ndarray:
    """The shared-uniform draw of the sweep protocol: the (trials, m)
    batch ``monte_carlo_error`` thresholds against p."""
    return np.random.default_rng(seed).random((trials, m))


def decode_grid(assignment: Assignment, masks, *, method: str = "optimal",
                p_grid: Optional[Sequence[float]] = None,
                backend: str = "auto",
                warm_start: bool = False, device=None) -> np.ndarray:
    """Decode a (P, trials, m) stack of mask batches -> (P, trials, n).

    One shared pipeline for the whole grid: graph schemes reuse the
    cached cover incidence (and its device tables) across all
    P points; other schemes dispatch through ``batched_alpha`` per
    point (``p_grid`` supplies the per-point p for 'fixed' decoding).

    ``warm_start=True`` chains label propagation through the grid *in
    the given order*, seeding point i+1 with point i's labels. Only
    sound when each point's alive sets contain the previous point's
    (per trial) -- e.g. a shared-uniform Bernoulli grid ordered by
    descending p; the nesting is validated (a stale label seed would
    otherwise silently corrupt alphas). Results are bit-identical
    either way; warm starts only cut propagation rounds.
    """
    device = resolve(device)
    masks = np.asarray(masks, dtype=bool)
    if masks.ndim != 3:
        raise ValueError(f"masks must be (P, trials, m), got {masks.shape}")
    P = masks.shape[0]
    if p_grid is not None and len(p_grid) != P:
        raise ValueError(f"p_grid has {len(p_grid)} entries for {P} "
                         "mask batches")
    if method == "fixed" and p_grid is None:
        raise ValueError("fixed decoding needs the per-point p: pass "
                         "p_grid (weights are 1/(d (1-p)))")
    out = np.empty((P, masks.shape[1], assignment.n), dtype=np.float64)
    if method == "optimal" and is_graph_scheme(assignment):
        # Label chaining goes through the dispatching batched_alpha
        # entry point (its labels0/return_labels plumbing), so the
        # warm-start protocol reads the same for every pipeline that
        # sits on decode_grid.
        labels = None
        for i in range(P):
            if warm_start and i and not np.all(masks[i] >= masks[i - 1]):
                raise ValueError(
                    "warm_start needs nested masks: grid point "
                    f"{i} revokes machines alive at point {i - 1} "
                    "(order a shared-uniform grid by descending p, "
                    "or pass warm_start=False)")
            out[i], labels = batched_alpha(
                assignment, masks[i], method="optimal", backend=backend,
                labels0=labels if warm_start else None,
                return_labels=True, device=device)
    else:
        for i in range(P):
            p_i = 0.0 if p_grid is None else float(p_grid[i])
            out[i] = batched_alpha(assignment, masks[i], method=method,
                                   p=p_i, backend=backend, device=device)
    return out


def sweep_error(assignment: Assignment, p_grid: Sequence[float], *,
                trials: int, method: str = "optimal", seed: int = 0,
                debias: bool = True, backend: str = "auto",
                cov: bool = True, cov_method: str = "auto",
                warm_start: bool = True, device=None) -> List[Dict]:
    """Run the full Figure-3 grid for one scheme in one engine pass.

    Returns one dict per grid point (in ``p_grid`` order) with the
    ``monte_carlo_error`` keys plus ``p``; ``mean_error``/``std_error``
    are bit-identical to per-point ``monte_carlo_error(A, p,
    trials=trials, seed=seed)`` calls (shared-uniform protocol, same
    decode, same fused error kernel). ``cov_method`` selects the
    covariance-norm path ('dense' reproduces the historical SVD
    expression exactly; 'lanczos' is matrix-free; 'auto' switches to
    lanczos once n outgrows the dense crossover).
    """
    device = resolve(device)
    p_list = [float(p) for p in p_grid]
    u = bernoulli_uniforms(assignment.m, trials, seed)
    masks = np.stack([u >= p for p in p_list]) if p_list else \
        np.zeros((0, trials, assignment.m), dtype=bool)
    # Descending p = ascending alive sets: the nesting that makes
    # warm-started labels valid. Results are unsorted back afterwards.
    order = np.argsort(-np.asarray(p_list), kind="stable") if p_list \
        else np.zeros(0, dtype=np.int64)
    alphas = np.empty((len(p_list), trials, assignment.n))
    alphas[order] = decode_grid(
        assignment, masks[order], method=method,
        p_grid=[p_list[i] for i in order], backend=backend,
        warm_start=warm_start, device=device)
    rows: List[Dict] = []
    for i, p in enumerate(p_list):
        errs, scale = _ba_ops.fused_error(alphas[i], debias=debias,
                                          device=device)
        row = {
            "p": p,
            "mean_error": float(errs.mean()),
            "std_error": float(errs.std()),
        }
        if cov:
            row["cov_norm"] = covariance_spectral_norm(
                alphas[i] * scale, method=cov_method, device=device)
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# Multi-scheme campaigns
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CampaignEntry:
    """One scheme's seat in a ``sweep_campaign``.

    ``masks`` overrides the shared Bernoulli draw with an explicit
    (P, trials, m) stack -- the adversarial-attack harness, where each
    grid point's masks come from ``adversarial_mask`` rather than a
    straggler probability (warm-started labels are skipped there: the
    attack stacks are not nested in p). ``debias=False`` reports raw
    (1/n)|alpha - 1|^2 errors, as the worst-case tables do.
    """

    assignment: Assignment
    method: str = "optimal"      # 'optimal' | 'fixed'
    label: Optional[str] = None
    masks: Optional[np.ndarray] = None
    debias: bool = True

    def resolved_label(self) -> str:
        return self.label or f"{self.assignment.name}:{self.method}"


def scheme_zoo_entries(q: int = 3, *, seed: int = 0
                       ) -> List[CampaignEntry]:
    """The cross-paper comparison zoo at one shared machine count.

    m = q(q+1) is the unique count all five constructions share (see
    the module docstring's table): the affine plane of order q has
    exactly q^2 + q lines/machines, and d = q+1 then divides m (FRC),
    divides 2m (expander / random matchings), and is a valid circulant
    shift width -- so ``sweep_campaign(scheme_zoo_entries(q), ...)``
    evaluates every scheme against the SAME shared uniform draw, the
    protocol behind the paper's Figure-3/Table-I comparisons. q must
    be a prime affine-plane order (q=3 -> m=12 by default).
    """
    d, m = q + 1, q * (q + 1)
    return [
        CampaignEntry(expander_assignment(m, d, vertex_transitive=True,
                                          seed=seed),
                      method="optimal", label="expander:optimal"),
        CampaignEntry(frc_assignment(m, d), method="fixed",
                      label="frc:fixed"),
        CampaignEntry(cyclic_mds_assignment(m, d), method="optimal",
                      label="cyclic_mds:optimal"),
        CampaignEntry(bibd_assignment(q * q, q, design="affine"),
                      method="optimal", label="bibd_affine:optimal"),
        CampaignEntry(random_matching_assignment(m, d, seed=seed),
                      method="optimal", label="random_regular:optimal"),
    ]


EntryLike = Union[CampaignEntry, Assignment,
                  Tuple[Assignment, str], Tuple[Assignment, str, str]]


def _as_entry(e: EntryLike) -> CampaignEntry:
    if isinstance(e, CampaignEntry):
        return e
    if isinstance(e, Assignment):
        return CampaignEntry(assignment=e)
    if isinstance(e, tuple) and len(e) in (2, 3) and \
            isinstance(e[0], Assignment):
        return CampaignEntry(assignment=e[0], method=e[1],
                             label=e[2] if len(e) == 3 else None)
    raise TypeError(f"campaign entry must be CampaignEntry, Assignment "
                    f"or (assignment, method[, label]); got {e!r}")


def _campaign_alphas(entry: CampaignEntry, masks: np.ndarray,
                     p_list: List[float], *, backend: str,
                     warm_start: bool, device) -> np.ndarray:
    """(P, T, m) masks -> (P, T, n) alphas for one entry, through the
    cheapest pipeline that stays bit-identical to the per-scheme
    ``sweep_error`` oracle (see each branch)."""
    A = entry.assignment
    if entry.method == "fixed":
        # One stacked exact-counts GEMM for the whole grid
        # (bit-identical to per-point batched_fixed_alpha: integer
        # counts are summation-order-invariant).
        return fixed_alpha_grid(A, masks, p_list)
    if entry.method != "optimal":
        raise ValueError(f"unknown method {entry.method!r}")
    if is_graph_scheme(A):
        # Same descending-p / warm-started-label walk as sweep_error.
        order = np.argsort(-np.asarray(p_list), kind="stable") if \
            entry.masks is None and len(p_list) else \
            np.arange(len(p_list), dtype=np.int64)
        out = np.empty((len(p_list), masks.shape[1], A.n))
        out[order] = decode_grid(
            A, masks[order], method="optimal", backend=backend,
            warm_start=warm_start and entry.masks is None, device=device)
        return out
    if A.name.startswith("frc"):
        return frc_alpha_grid(A, masks)  # stacked exact counts
    return np.stack([batched_alpha(A, masks[i], method="optimal",
                                   backend=backend, device=device)
                     for i in range(masks.shape[0])]) if len(p_list) \
        else np.zeros((0, masks.shape[1], A.n))


def sweep_campaign(entries: Sequence[EntryLike],
                   p_grid: Sequence[float], *, trials: int,
                   seed: int = 0, backend: str = "auto",
                   debias: bool = True, cov: bool = True,
                   cov_method: str = "auto", warm_start: bool = True,
                   cov_topk: int = 0,
                   device=None) -> Dict[str, List[Dict]]:
    """Run several schemes' whole Figure-3 grids in ONE pipeline.

    The cross-scheme protocol of the paper's headline comparisons
    (Figure 3, Table I): every scheme of the same machine count m faces
    the *same* straggler draw. The campaign samples one
    ``bernoulli_uniforms(m, trials, seed)`` per distinct m, thresholds
    the whole (P, trials, m) mask stack once, and shares it across all
    entries of that m -- so per-(scheme, p) rows are bit-identical to
    per-scheme ``sweep_error(A, p_grid, trials=trials, seed=seed,
    method=...)`` calls (and hence to per-point ``monte_carlo_error``),
    while the work the sequential loop re-pays per scheme is paid once:

    * mask sampling + thresholding, per m instead of per scheme;
    * fixed/FRC decoding as ONE stacked (P * trials, m) exact-counts
      GEMM per scheme instead of P skinny per-point matmuls;
    * graph decodes warm-started through the nested-in-p label chain
      (as in ``sweep_error``), reusing the per-graph cover cache;
    * ALL (scheme, p) covariance norms through one blocked lockstep
      Lanczos over the stacked batch (``cov_method='blocked'``; 'auto'
      picks it past the dense crossover) -- a single kernel launch
      sequence instead of S*P Lanczos loops.

    ``entries`` accepts ``CampaignEntry`` (mask-stack overrides,
    per-entry debias), bare assignments (optimal decoding), or
    ``(assignment, method[, label])`` tuples. Returns an insertion-
    ordered dict label -> ``sweep_error``-shaped rows; ``cov_topk > 0``
    adds the leading covariance spectrum (``covariance_topk``) per row.
    ``device=None`` means the card.
    """
    device = resolve(device)
    ents = [_as_entry(e) for e in entries]
    if not ents:
        raise ValueError("campaign needs at least one entry")
    labels = [e.resolved_label() for e in ents]
    if len(set(labels)) != len(labels):
        raise ValueError(f"duplicate campaign labels {labels}; pass "
                         "explicit label= to disambiguate")
    p_list = [float(p) for p in p_grid]
    P = len(p_list)

    # One shared draw + mask stack per distinct machine count.
    shared_masks: Dict[int, np.ndarray] = {}
    for e in ents:
        m = e.assignment.m
        if e.masks is None and m not in shared_masks:
            u = bernoulli_uniforms(m, trials, seed)
            shared_masks[m] = np.stack([u >= p for p in p_list]) if P \
                else np.zeros((0, trials, m), dtype=bool)

    results: Dict[str, List[Dict]] = {}
    cov_slices: List[Tuple[str, int, np.ndarray]] = []
    for e, label in zip(ents, labels):
        if e.masks is not None:
            masks = np.asarray(e.masks, dtype=bool)
            if masks.ndim != 3 or masks.shape[0] != P or \
                    masks.shape[2] != e.assignment.m:
                raise ValueError(
                    f"entry {label!r} mask stack must be (P={P}, "
                    f"trials, m={e.assignment.m}), got {masks.shape}")
        else:
            masks = shared_masks[e.assignment.m]
        alphas = _campaign_alphas(e, masks, p_list, backend=backend,
                                  warm_start=warm_start, device=device)
        rows: List[Dict] = []
        for i, p in enumerate(p_list):
            errs, scale = _ba_ops.fused_error(
                alphas[i], debias=debias and e.debias, device=device)
            rows.append({
                "p": p,
                "mean_error": float(errs.mean()),
                "std_error": float(errs.std()),
            })
            if cov or cov_topk:
                scaled = alphas[i] * scale
                if cov:
                    cov_slices.append((label, i, scaled))
                if cov_topk:
                    rows[-1]["cov_topk"] = covariance_topk(
                        scaled, cov_topk, device=device).tolist()
        results[label] = rows

    if cov_slices:
        # Group equal-(trials, n) slices so the blocked path can stack
        # them; ``covariance_spectral_norm_batch`` owns the method
        # dispatch ('dense'/'lanczos' loop the per-point oracle, i.e.
        # bit-identical to sweep_error rows with that cov_method).
        groups: Dict[Tuple[int, int], List[int]] = {}
        for idx, (_, _, s) in enumerate(cov_slices):
            groups.setdefault(s.shape, []).append(idx)
        for idxs in groups.values():
            norms = covariance_spectral_norm_batch(
                np.stack([cov_slices[i][2] for i in idxs]),
                method=cov_method, device=device)
            for i, norm in zip(idxs, norms):
                label, pt, _ = cov_slices[i]
                results[label][pt]["cov_norm"] = float(norm)
    return results
