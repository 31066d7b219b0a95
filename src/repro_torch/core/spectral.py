"""Matrix-free spectral toolkit for the sweep engine and graph schemes.

Two spectral quantities gate the paper's harnesses at scale:

* ``|Cov(alpha-bar)|_2`` in the Figure 3 / Section VIII-B Monte-Carlo
  pipeline. The historical path formed the dense n x n covariance and
  ran a full SVD -- O(n^3) per p-point, ~3.5 s at the LPS n=2184 scale.
  ``covariance_spectral_norm`` instead runs Lanczos iteration directly
  on the centered (trials, n) batch: the covariance top eigenvalue is
  sigma_max(C)^2 / trials, reachable through Gram matvecs
  v -> X^T (X v) with X the tall-skinny orientation of C, i.e.
  O(trials * n * iters) and no n x n matrix ever formed. The matvec is
  the ``kernels.spectral_matvec`` package (the CUDA kernel on the card,
  the float64 NumPy oracle on the CPU). When the Krylov dimension min(trials, n) is
  small (the paper's trials=30 regime) Lanczos exhausts the space and
  the result is exact to rounding.

* ``lambda_2(Adj(G))`` behind ``Graph.spectral_expansion`` -- the
  quantity Thm IV.1 / Cor V.2 and the related expander schemes (Raviv
  et al., Charles et al.) all scale with. ``graph_lambda2`` dispatches:
  circulant graphs (cycles, Paley, the ``lps_like_cayley_expander``
  candidates) get their *exact* spectrum from one FFT of the offset
  indicator; large regular graphs get sparse-matvec Lanczos with the
  known top eigenvector (the all-ones direction) deflated; small or
  irregular graphs keep the dense eigvalsh.

Copy of ``repro.core.spectral``. The covariance functions take a
``device`` (``None`` means the card): on the CPU every stage is the
reference's float64 NumPy, so results are bit-identical to
``repro.core``; on the card the tall operand is staged once as float32
and every Gram matvec runs the CUDA kernel, while the Lanczos
orchestration and reorthogonalization stay host float64 NumPy, as the
reference's TPU path keeps them.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence, TYPE_CHECKING

import numpy as np
import torch

from ..device import resolve
from ..kernels.spectral_matvec import ops as _sm_ops

if TYPE_CHECKING:  # avoid a runtime cycle with .graphs
    from .graphs import Graph

# Below these sizes the dense path is both exact and cheap; Lanczos
# only pays off once the O(n^3) eigendecomposition dominates.
_DENSE_N_MAX = 512
_DENSE_COV_MAX = 512


# ---------------------------------------------------------------------------
# Lanczos extreme eigenvalue (full reorthogonalization)
# ---------------------------------------------------------------------------


def lanczos_lambda_max(matvec: Callable[[np.ndarray], np.ndarray],
                       dim: int, *, maxiter: int | None = None,
                       tol: float = 1e-12, seed: int = 0) -> float:
    """Largest eigenvalue of a symmetric operator given only matvecs.

    Full reorthogonalization (the Krylov bases here are tiny relative
    to the matvec cost), with restart on breakdown so invariant
    subspaces are enumerated rather than silently truncated: when
    ``maxiter`` covers the whole space the result is therefore exact to
    rounding, which is what the covariance-norm acceptance (1e-6
    relative of the dense SVD) and the closed-form graph tests rely on.
    Stops early once the top Ritz value is stable to ``tol`` (relative)
    for two consecutive iterations.
    """
    if dim <= 0:
        return 0.0
    rng = np.random.default_rng(seed)
    kmax = dim if maxiter is None else max(1, min(maxiter, dim))
    # Grow the basis geometrically: convergence usually takes a few
    # dozen iterations, so never preallocate the O(dim^2) worst case.
    Q = np.empty((min(kmax, 32), dim), dtype=np.float64)

    def ensure_row(i: int) -> None:
        nonlocal Q
        if i >= Q.shape[0]:
            Q = np.concatenate(
                [Q, np.empty((min(kmax, 2 * Q.shape[0]) - Q.shape[0],
                              dim))], axis=0)

    diag: list[float] = []
    off: list[float] = []
    q = rng.standard_normal(dim)
    q /= np.linalg.norm(q)
    Q[0] = q
    theta_prev = None
    stable = 0
    k = 0
    while True:
        w = np.asarray(matvec(Q[k]), dtype=np.float64)
        diag.append(float(Q[k] @ w))
        # Classical Gram-Schmidt against the whole basis, twice (the
        # standard "twice is enough" full reorthogonalization).
        w -= Q[:k + 1].T @ (Q[:k + 1] @ w)
        w -= Q[:k + 1].T @ (Q[:k + 1] @ w)
        b = float(np.linalg.norm(w))
        k += 1
        T = np.diag(diag)
        if off:
            idx = np.arange(len(off))
            T[idx, idx + 1] = off
            T[idx + 1, idx] = off
        theta = float(np.linalg.eigvalsh(T)[-1])
        if theta_prev is not None and \
                abs(theta - theta_prev) <= tol * max(1.0, abs(theta)):
            stable += 1
            if stable >= 2:
                return theta
        else:
            stable = 0
        theta_prev = theta
        if k == kmax:
            return theta
        ensure_row(k)
        if b <= 1e-13 * max(1.0, abs(diag[-1])):
            # Invariant subspace found: restart in its orthogonal
            # complement (off-diagonal 0 keeps T block-tridiagonal).
            q = rng.standard_normal(dim)
            q -= Q[:k].T @ (Q[:k] @ q)
            nq = float(np.linalg.norm(q))
            if nq < 1e-10:  # basis exhausted: theta is exact
                return theta
            off.append(0.0)
            Q[k] = q / nq
        else:
            off.append(b)
            Q[k] = w / b


def lanczos_lambda_max_batch(matvec: Callable[..., np.ndarray],
                             dim: int, nbatch: int, *,
                             maxiter: int | None = None,
                             tol: float = 1e-12,
                             seed: int = 0) -> np.ndarray:
    """Largest eigenvalues of ``nbatch`` symmetric operators of equal
    ``dim``, driven in lockstep through one *batched* matvec per
    iteration: ``matvec(V, idx)`` with V (B_active, dim) and ``idx``
    the int array of original slice indices V's rows correspond to.

    Per-slice state mirrors ``lanczos_lambda_max`` exactly: full
    reorthogonalization (batched einsums over the shared basis tensor),
    per-slice convergence counters, per-slice breakdown restarts, and
    exactness once a slice's Krylov space is exhausted. Converged
    slices are COMPACTED out of the active set (their result frozen at
    their own stopping iteration, like a sequential early-stop), so the
    lockstep's total matvec/reorth/eigen work tracks the *sum* of
    per-slice iteration counts, not B times the slowest slice -- that,
    plus one kernel launch sequence per iteration instead of B python
    Lanczos loops, is what the batch form buys.
    """
    B = int(nbatch)
    if B == 0:
        return np.zeros(0, dtype=np.float64)
    if dim <= 0:
        return np.zeros(B, dtype=np.float64)
    rng = np.random.default_rng(seed)
    kmax = dim if maxiter is None else max(1, min(maxiter, dim))
    result = np.zeros(B, dtype=np.float64)
    idx = np.arange(B)                     # active slice -> original
    Q = np.empty((B, min(kmax, 32), dim), dtype=np.float64)
    q = rng.standard_normal((B, dim))
    Q[:, 0] = q / np.linalg.norm(q, axis=1, keepdims=True)
    diag = np.empty((B, kmax))
    off = np.empty((B, kmax))
    theta_prev = np.full(B, np.nan)
    stable = np.zeros(B, dtype=np.int64)
    k = 0
    while True:
        w = np.asarray(matvec(Q[:, k], idx), dtype=np.float64)
        diag[:, k] = np.einsum("bd,bd->b", Q[:, k], w)
        for _ in range(2):  # "twice is enough" full reorthogonalization
            coeff = np.einsum("bkd,bd->bk", Q[:, :k + 1], w)
            w -= np.einsum("bkd,bk->bd", Q[:, :k + 1], coeff)
        beta = np.linalg.norm(w, axis=1)
        k += 1
        T = np.zeros((len(idx), k, k))
        di = np.arange(k)
        T[:, di, di] = diag[:, :k]
        if k > 1:
            j = np.arange(k - 1)
            T[:, j, j + 1] = off[:, :k - 1]
            T[:, j + 1, j] = off[:, :k - 1]
        theta = np.linalg.eigvalsh(T)[:, -1]  # batched tridiag eigen
        conv = np.abs(theta - theta_prev) <= \
            tol * np.maximum(1.0, np.abs(theta))
        stable = np.where(conv, stable + 1, 0)
        theta_prev = theta
        if k == kmax:
            result[idx] = theta
            return result
        if k >= Q.shape[1]:  # grow the shared basis geometrically
            extra = min(kmax, 2 * Q.shape[1]) - Q.shape[1]
            Q = np.concatenate(
                [Q, np.empty((len(idx), extra, dim))], axis=1)
        exhausted = np.zeros(len(idx), dtype=bool)
        small = beta <= 1e-13 * np.maximum(1.0, np.abs(diag[:, k - 1]))
        off[:, k - 1] = np.where(small, 0.0, beta)
        safe = np.where(small, 1.0, beta)
        Q[:, k] = w / safe[:, None]
        for b_i in np.nonzero(small)[0]:
            # Invariant subspace on slice b_i: restart in its orthogonal
            # complement (the off-diagonal 0 keeps T block-tridiagonal).
            qv = rng.standard_normal(dim)
            qv -= Q[b_i, :k].T @ (Q[b_i, :k] @ qv)
            nq = float(np.linalg.norm(qv))
            if nq < 1e-10:
                # Basis exhausted: theta is exact; retire the slice.
                exhausted[b_i] = True
            else:
                Q[b_i, k] = qv / nq
        finished = (stable >= 2) | exhausted
        if finished.any():
            result[idx[finished]] = theta[finished]
            keep = ~finished
            if not keep.any():
                return result
            idx = idx[keep]
            Q = Q[keep]
            diag = diag[keep]
            off = off[keep]
            theta_prev = theta_prev[keep]
            stable = stable[keep]


# ---------------------------------------------------------------------------
# Covariance spectral norm (matrix-free)
# ---------------------------------------------------------------------------


def covariance_spectral_norm(batch: np.ndarray, *, method: str = "auto",
                             maxiter: int | None = None,
                             tol: float = 1e-12, seed: int = 0,
                             device=None) -> float:
    """|Cov(rows of batch)|_2 for a (trials, n) batch.

    method 'dense' reproduces the historical expression bit-for-bit
    (center, form C^T C / trials, dense 2-norm); 'lanczos' never forms
    the n x n matrix: it runs ``lanczos_lambda_max`` on the Gram
    operator of the tall-skinny orientation of the centered batch
    (dimension min(trials, n)), dividing by trials. 'auto' picks
    lanczos once n outgrows the dense crossover. ``device`` stages the
    lanczos operand (``None`` means the card).
    """
    a = np.asarray(batch, dtype=np.float64)
    if a.ndim != 2:
        raise ValueError(f"batch must be (trials, n), got {a.shape}")
    device = resolve(device)
    trials, n = a.shape
    if trials == 0:
        return 0.0
    if method == "auto":
        method = "lanczos" if n > _DENSE_COV_MAX else "dense"
    centered = a - a.mean(axis=0, keepdims=True)
    if method == "dense":
        cov = centered.T @ centered / trials
        return float(np.linalg.norm(cov, 2))
    if method != "lanczos":
        raise ValueError(f"unknown cov method {method!r}")
    # Operate on the small side: X^T X is (k, k) with k = min(trials, n)
    # and shares its nonzero spectrum with the covariance * trials.
    # Stage the tall operand once (a device upload on the card) rather
    # than per Lanczos matvec.
    X = _sm_ops.prepare_operand(centered if trials >= n else centered.T,
                                device)
    k = X.shape[1]

    def mv(v: np.ndarray) -> np.ndarray:
        return _sm_ops.gram_matvec(X, v) / trials

    lam = lanczos_lambda_max(mv, k, maxiter=maxiter, tol=tol, seed=seed)
    return float(max(lam, 0.0))  # Gram operator is PSD; clip rounding


def covariance_spectral_norm_batch(batch: np.ndarray, *,
                                   method: str = "auto",
                                   maxiter: int | None = None,
                                   tol: float = 1e-12,
                                   seed: int = 0,
                                   device=None) -> np.ndarray:
    """|Cov|_2 for every slice of a (B, trials, n) stack at once.

    method 'blocked' is the sweep campaign's path: every slice is
    centered, oriented tall-skinny, stacked into one (B, R, k) operand,
    and all B norms come out of ONE lockstep Lanczos
    (``lanczos_lambda_max_batch`` over ``gram_matvec_batch``) -- a
    single kernel launch sequence instead of B python Lanczos loops.
    'dense' / 'lanczos' loop the per-slice ``covariance_spectral_norm``
    (the oracles the blocked path is differential-tested against);
    'auto' picks blocked once n outgrows the dense crossover. On the
    card the stack is staged once and the blocked path's matvecs run the
    batch kernel; the active sub-stack after a compaction is a device
    ``index_select``, cached until the active set changes again.
    """
    a = np.asarray(batch, dtype=np.float64)
    if a.ndim != 3:
        raise ValueError(f"batch must be (B, trials, n), got {a.shape}")
    device = resolve(device)
    B, trials, n = a.shape
    if B == 0:
        return np.zeros(0, dtype=np.float64)
    if trials == 0:
        return np.zeros(B, dtype=np.float64)
    if method == "auto":
        method = "blocked" if n > _DENSE_COV_MAX else "dense"
    if method in ("dense", "lanczos"):
        return np.asarray([
            covariance_spectral_norm(a[i], method=method, maxiter=maxiter,
                                     tol=tol, seed=seed, device=device)
            for i in range(B)])
    if method != "blocked":
        raise ValueError(f"unknown batch cov method {method!r}")
    centered = a - a.mean(axis=1, keepdims=True)
    X = centered if trials >= n else centered.transpose(0, 2, 1)
    k = X.shape[2]
    if _sm_ops.uses_kernel(device):
        Xs = _sm_ops.prepare_operand(X, device)  # staged once on device
        # idx only changes at compaction events; cache the gathered
        # sub-stack so steady-state iterations pay no device copy.
        sub_cache = {"key": None, "sub": Xs}

        def mv(V: np.ndarray, idx: np.ndarray) -> np.ndarray:
            key = idx.tobytes()
            if sub_cache["key"] != key:
                sub_cache["sub"] = Xs if len(idx) == B else \
                    Xs.index_select(0, torch.as_tensor(idx,
                                                       device=Xs.device))
                sub_cache["key"] = key
            return _sm_ops.gram_matvec_batch(sub_cache["sub"],
                                             V) / trials
    else:
        # CPU float64 oracle path: per-slice GEMVs, no stack copies
        # when the active set shrinks.
        Xs_list = [np.ascontiguousarray(X[i]) for i in range(B)]

        def mv(V: np.ndarray, idx: np.ndarray) -> np.ndarray:
            return np.stack([_sm_ops.gram_matvec(Xs_list[i], V[j])
                             for j, i in enumerate(idx)]) / trials

    lam = lanczos_lambda_max_batch(mv, k, B, maxiter=maxiter, tol=tol,
                                   seed=seed)
    return np.maximum(lam, 0.0)  # Gram operators are PSD; clip rounding


def covariance_topk(batch: np.ndarray, k: int, *, method: str = "auto",
                    maxiter: int | None = None, tol: float = 1e-12,
                    seed: int = 0, device=None) -> np.ndarray:
    """Top-k eigenvalues of Cov(rows of batch), descending, for a
    (trials, n) batch.

    The paper's bounds only ever need the top eigenvalue
    (``covariance_spectral_norm``); the ablations want the leading
    spectrum, so this runs *block* Lanczos (block size min(k, dim),
    full reorthogonalization, explicit Rayleigh-Ritz) on the Gram
    operator of the tall-skinny orientation -- each iteration is one
    ``gram_matvec_block`` pass over the centered batch, k right-hand
    sides at a time. Eigenvalues beyond the covariance rank are exact
    zeros (padded, never iterated for). method 'dense' is the oracle
    (full eigvalsh of the n x n covariance); 'auto' picks the block
    path once n outgrows the dense crossover. ``device`` stages the
    block operand (``None`` means the card).
    """
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    a = np.asarray(batch, dtype=np.float64)
    if a.ndim != 2:
        raise ValueError(f"batch must be (trials, n), got {a.shape}")
    device = resolve(device)
    trials, n = a.shape
    k = min(k, n) if n else 0
    if trials == 0 or k == 0:
        return np.zeros(max(k, 0), dtype=np.float64)
    if method == "auto":
        method = "block" if n > _DENSE_COV_MAX else "dense"
    centered = a - a.mean(axis=0, keepdims=True)
    if method == "dense":
        cov = centered.T @ centered / trials
        eigs = np.linalg.eigvalsh(cov)[::-1][:k]
        return np.maximum(eigs, 0.0)
    if method != "block":
        raise ValueError(f"unknown topk method {method!r}")
    X = _sm_ops.prepare_operand(centered if trials >= n else centered.T,
                                device)
    dim = X.shape[1]

    def mv_block(V: np.ndarray) -> np.ndarray:
        return _sm_ops.gram_matvec_block(X, V) / trials

    lam = _block_lanczos_topk(mv_block, dim, min(k, dim),
                              maxiter=maxiter, tol=tol, seed=seed)
    out = np.zeros(k, dtype=np.float64)  # rank-deficient tail is 0
    out[:lam.size] = np.maximum(lam, 0.0)
    return out


def _block_lanczos_topk(matvec_block: Callable[[np.ndarray], np.ndarray],
                        dim: int, k: int, *, maxiter: int | None = None,
                        tol: float = 1e-12, seed: int = 0) -> np.ndarray:
    """Top-k eigenvalues of a symmetric PSD operator via block Lanczos
    with explicit Rayleigh-Ritz: grow an orthonormal basis Q one
    k-column block per matvec sweep, keep A Q alongside, and read Ritz
    values off H = Q^T A Q. Full reorthogonalization plus random
    refill of rank-deficient block columns, so invariant subspaces are
    enumerated rather than truncated; when the basis exhausts R^dim the
    Ritz values are the exact spectrum. Stops early once all k leading
    Ritz values are stable to ``tol`` (relative) twice in a row.
    """
    if dim <= 0 or k <= 0:
        return np.zeros(0, dtype=np.float64)
    rng = np.random.default_rng(seed)
    b = min(k, dim)
    cap = dim if maxiter is None else min(dim, max(1, maxiter) * b)
    V = np.linalg.qr(rng.standard_normal((dim, b)))[0]
    Q = np.zeros((dim, 0))
    AQ = np.zeros((dim, 0))
    ritz_prev = None
    stable = 0
    while True:
        W = np.asarray(matvec_block(V), dtype=np.float64)
        Q = np.concatenate([Q, V], axis=1)
        AQ = np.concatenate([AQ, W], axis=1)
        H = Q.T @ AQ
        H = (H + H.T) / 2.0
        ritz = np.linalg.eigvalsh(H)[::-1][:k]
        if ritz_prev is not None and ritz_prev.size == ritz.size and \
                np.all(np.abs(ritz - ritz_prev) <=
                       tol * np.maximum(1.0, np.abs(ritz))):
            stable += 1
            if stable >= 2:
                return ritz
        else:
            stable = 0
        ritz_prev = ritz
        nxt = min(b, cap - Q.shape[1])
        if nxt <= 0:
            return ritz
        # Next block: A V orthogonalized against everything seen, twice;
        # rank-deficient columns refilled with fresh random directions.
        W = W[:, :nxt]
        for _ in range(2):
            W -= Q @ (Q.T @ W)
        cols = []
        for j in range(W.shape[1]):
            w = W[:, j]
            if cols:
                C = np.stack(cols, axis=1)
                w = w - C @ (C.T @ w)
            nw = float(np.linalg.norm(w))
            if nw <= 1e-10:
                for _ in range(3):  # refill: random, re-orthogonalized
                    w = rng.standard_normal(dim)
                    w -= Q @ (Q.T @ w)
                    if cols:
                        C = np.stack(cols, axis=1)
                        w -= C @ (C.T @ w)
                    nw = float(np.linalg.norm(w))
                    if nw > 1e-10:
                        break
                else:
                    # Space exhausted: Ritz values are exact already.
                    return ritz
            cols.append(w / nw)
        V = np.stack(cols, axis=1)


# ---------------------------------------------------------------------------
# Graph spectra
# ---------------------------------------------------------------------------


def circulant_spectrum(n: int, offsets: Sequence[int]) -> np.ndarray:
    """Exact adjacency spectrum of the circulant graph of Z_n with
    connection set {+-o : o in offsets} \\ {0} (deduplicated like
    ``graphs.circulant_graph``): lambda_k = sum_{s in S} e^{2 pi i ks/n}
    -- i.e. one FFT of the connection-set indicator. Returns the n
    eigenvalues in frequency order (index 0 is the degree)."""
    from .graphs import _canonical_offsets  # single dedup convention

    ind = np.zeros(n, dtype=np.float64)
    for o in _canonical_offsets(n, offsets):
        ind[o] = 1.0
        ind[n - o] = 1.0  # same slot when o = n/2: counted once
    # The connection set is symmetric, so the transform is real up to
    # rounding.
    return np.fft.fft(ind).real


def adjacency_matvec(graph: "Graph") -> Callable[[np.ndarray], np.ndarray]:
    """x -> Adj(G) x as a sparse bincount gather: O(m) per call, no
    dense n x n adjacency."""
    n = graph.n
    if not graph.edges:
        return lambda x: np.zeros(n, dtype=np.float64)
    e = np.asarray(graph.edges, dtype=np.int64)
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])

    def mv(x: np.ndarray) -> np.ndarray:
        return np.bincount(src, weights=np.asarray(x, np.float64)[dst],
                           minlength=n)

    return mv


@functools.lru_cache(maxsize=256)  # graphs are immutable; lambda_2 isn't
def graph_lambda2(graph: "Graph", method: str = "auto") -> float:
    """Second-largest adjacency eigenvalue of ``graph``.

    Matches ``sort(eigvalsh(Adj))[-2]`` (the historical definition,
    multiplicity included). Dispatch: 'fft' (exact, circulant metadata
    required), 'dense' (exact, O(n^3)), 'lanczos' (matrix-free; regular
    graphs only -- the top eigenvector is then the all-ones direction,
    which gets deflated so lambda_2 = lambda_max on 1-perp even when
    lambda_2 = d has multiplicity, e.g. disconnected graphs).
    """
    if method == "auto":
        if graph.circulant_offsets is not None:
            method = "fft"
        elif graph.n <= _DENSE_N_MAX or not graph.is_regular():
            method = "dense"
        else:
            method = "lanczos"
    if method == "fft":
        if graph.circulant_offsets is None:
            raise ValueError("fft lambda_2 needs circulant metadata")
        eigs = np.sort(circulant_spectrum(graph.n, graph.circulant_offsets))
        return float(eigs[-2])
    if method == "dense":
        eigs = np.sort(np.linalg.eigvalsh(graph.adjacency()))
        return float(eigs[-2])
    if method != "lanczos":
        raise ValueError(f"unknown lambda_2 method {method!r}")
    if not graph.is_regular():
        raise ValueError("lanczos lambda_2 needs a regular graph "
                         "(unknown Perron vector otherwise); use 'dense'")
    mv = adjacency_matvec(graph)
    d = float(graph.degrees()[0]) if graph.edges else 0.0

    def deflated(v: np.ndarray) -> np.ndarray:
        # P A P - (d+1) * 11^T/n: the all-ones direction is shifted to
        # -(d+1) < -d <= lambda_min, so lambda_max of this operator is
        # exactly lambda_2 (even when lambda_2 < 0, e.g. K_n).
        mean_in = v.mean()
        y = mv(v - mean_in)
        return y - y.mean() - (d + 1.0) * mean_in

    return float(lanczos_lambda_max(deflated, graph.n, seed=0))


def spectral_expansion(graph: "Graph", method: str = "auto") -> float:
    """lambda = max-degree - lambda_2; the ``Graph.spectral_expansion``
    implementation (see its docstring for semantics)."""
    d = float(np.max(graph.degrees())) if graph.edges else 0.0
    return d - graph_lambda2(graph, method)
