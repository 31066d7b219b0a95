"""Batched optimal decoding: alpha* for a whole (trials, m) batch of masks.

The scalar decoder (``decoding.optimal_alpha_graph``) runs one Python BFS
two-coloring per straggler mask. Every Monte-Carlo harness in the paper
(Figure 3, the m=6552 Section VIII-B simulations, the adversarial
sweeps) samples thousands of masks over the *same* graph, so this module
replaces the per-mask BFS with an array-level fixed-point iteration that
decodes the entire batch at once.

Formulation: pointer jumping on the bipartite double cover
----------------------------------------------------------

Everything the Section III characterisation needs -- connected
components of the surviving subgraph, bipartiteness of each component,
and the two side sizes |L|, |R| -- is recovered from connected
components of the *bipartite double cover* of G. The cover has two nodes
v0 = v and v1 = v + n per vertex v, and each surviving edge (u, v)
becomes the two cover edges (u0, v1) and (u1, v0). Standard facts:

* a component of G is bipartite  <=>  its cover splits into two
  components, one per side (v0's component collects the vertices at
  even distance from v, v1's the odd ones);
* a component is non-bipartite   <=>  v0 and v1 are merged (an odd walk
  exists), so the whole component lifts to a single cover component;
* an isolated vertex keeps v0 and v1 as two singleton components.

Components are labeled by min-label propagation with pointer jumping
(Shiloach-Vishkin style): labels start as node identity; each round
every node takes the minimum label over its surviving cover neighbours,
then shortcuts ``label <- label[label]``. Labels decrease monotonically
and the unique fixed point assigns every cover node the minimum node
index of its component, in O(log n) rounds. Each round is a
whole-(trials, 2n)-array operation: a gather of neighbour labels
through a degree-padded dense incidence (cover nodes inherit the vertex
degrees, so d-regular graphs pad to exactly d slots), a masked
min-reduce over the degree axis, and take-along-axis jumps. Backends:
NumPy for small batches, and torch tensor ops on the card for large ones
(``_propagate_torch``, the counterpart of the reference's jitted JAX
``lax.while_loop``, which is XLA and not a Pallas kernel).

Equivalence with the BFS decoder: let L[x] be the fixed-point label of
cover node x and r = min(L[v0], L[v1]) the component root. Then
``nonbipartite(v) = (L[v0] == L[v1])``, and for bipartite components
``color(v) = (L[v1] < L[v0])`` puts v on the root's side iff
L[v0] = r < L[v1] (the root's own cover component always carries the
smaller label, because the opposite side's minimum node index is
strictly larger). Side sizes s0, s1 are then integer bincounts per
(trial, root, color), and alpha follows the Section III table with the
*same float expressions* as the scalar decoder -- ``1 -/+ |s0-s1|/(s0+s1)``
on bipartite components (the ``1 - delta`` branch taken by the weakly
larger side, which also yields the isolated-vertex 0 via s=1/0), and 1
on non-bipartite components -- so batched and scalar alphas agree
bit-for-bit, not just to rounding.

Copy of ``repro.core.batched_decoding`` with the JAX backend replaced by
the torch one: ``backend`` is 'numpy' | 'torch' | 'auto' and ``device``
says where the torch propagator runs (``None`` means the card). Labels
are a unique fixed point, so every backend returns the same labels, and
``_alpha_from_labels`` stays host NumPy as in the reference.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import resolve
from .assignment import Assignment
from .graphs import Graph

# Below this many mask entries the upload and per-round launches of the
# torch path outweigh its device execution; "auto" uses NumPy there (the
# reference's threshold for its JAX path).
_TORCH_MIN_WORK = 200_000


# ---------------------------------------------------------------------------
# Double-cover incidence (fixed per graph, cached)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)  # bounded: tables are O(n*d) each
def _cover_dense(graph: Graph):
    """Degree-padded incidence of the double cover.

    Cover node u0 = u neighbours {v1 : (u,v) surviving}, u1 = u + n
    neighbours {v0}; both inherit vertex u's degree, so the incidence
    packs into dense (2n, deg_max) tables -- gather + min-reduce over
    the last axis then replaces a ragged segment reduction, which is
    what makes the batched sweep SIMD- and device-friendly. Padding slots point
    at the node itself via the sentinel edge m (always dead).

    Returns (pad_nbr, pad_edge), both (2n, deg_max) int32.
    """
    n, m = graph.n, graph.m
    # Cover nodes u0/u1 both inherit vertex u's degree.
    deg_max = max(int(graph.degrees().max(initial=0)), 1)
    pad_nbr = np.tile(np.arange(2 * n, dtype=np.int32)[:, None],
                      (1, deg_max))
    pad_edge = np.full((2 * n, deg_max), m, dtype=np.int32)
    fill = np.zeros(2 * n, dtype=np.int64)

    def put(x, y, j):
        pad_nbr[x, fill[x]] = y
        pad_edge[x, fill[x]] = j
        fill[x] += 1

    for j, (u, v) in enumerate(graph.edges):
        put(u, v + n, j)
        put(v + n, u, j)
        put(u + n, v, j)
        put(v, u + n, j)
    return pad_nbr, pad_edge


# ---------------------------------------------------------------------------
# Label-propagation backends: alive (T, m) -> cover labels (T, 2n)
# ---------------------------------------------------------------------------


def _label_dtype(n: int):
    """int16 labels when every node id -- and a 2n sentinel -- fits
    (2n is even, so 2n < 32768 iff 2n <= 32766 fits int16); halves the
    gather traffic of the memory-bound relax step. The torch backend
    works in int64 (``torch.gather`` indices) and hands labels back in
    this dtype, so warm-start labels round-trip losslessly.
    """
    return np.int16 if 2 * n < 32768 else np.int32


def _check_labels0(labels0, trials: int, n: int) -> np.ndarray:
    """Validate warm-start labels (see ``batched_optimal_alpha_graph``:
    only sound when the masks are supersets of the labels' masks)."""
    labels0 = np.asarray(labels0)
    if labels0.shape != (trials, 2 * n):
        raise ValueError(f"labels0 must be ({trials}, {2 * n}), "
                         f"got {labels0.shape}")
    return labels0.astype(_label_dtype(n), copy=False)


def _propagate_numpy(graph: Graph, alive: np.ndarray,
                     labels0: np.ndarray | None = None) -> np.ndarray:
    n = graph.n
    trials = alive.shape[0]
    pad_nbr, pad_edge = _cover_dense(graph)
    deg_max = pad_nbr.shape[1]
    # Column m is the always-dead sentinel edge; dead slots retarget to
    # the node itself, which is neutral under min.
    alive_ext = np.concatenate(
        [alive, np.zeros((trials, 1), dtype=bool)], axis=1)
    self_idx = np.arange(2 * n, dtype=np.int32)[:, None]
    nbr_eff = np.where(alive_ext[:, pad_edge], pad_nbr[None],
                       self_idx[None]).reshape(trials, 2 * n * deg_max)
    ldt = _label_dtype(n)
    if labels0 is None:
        labels = np.tile(np.arange(2 * n, dtype=ldt), (trials, 1))
    else:
        labels = _check_labels0(labels0, trials, n)
    while True:
        vals = np.take_along_axis(labels, nbr_eff, axis=1)
        new = np.minimum(labels,
                         vals.reshape(trials, 2 * n, deg_max).min(axis=2))
        while True:  # full path compression
            nxt = np.take_along_axis(new, new, axis=1)
            if np.array_equal(nxt, new):
                break
            new = nxt
        if np.array_equal(new, labels):
            return labels
        labels = new


@functools.lru_cache(maxsize=64)  # bounded: tables are O(n*d) each
def _torch_tables(graph: Graph, device: torch.device):
    """The flattened cover incidence on ``device``, int64 for
    ``torch.gather``: (nbr_flat, edge_flat), each (2n*deg_max,)."""
    pad_nbr, pad_edge = _cover_dense(graph)
    return (torch.as_tensor(pad_nbr.ravel().astype(np.int64), device=device),
            torch.as_tensor(pad_edge.ravel().astype(np.int64),
                            device=device))


def _propagate_torch(graph: Graph, alive: np.ndarray,
                     labels0: np.ndarray | None,
                     device: torch.device) -> np.ndarray:
    """The torch propagator: alive (T, m) -> cover labels (T, 2n) in
    ``_label_dtype(n)``, computed on ``device``.

    The same min-label relax and pointer jumps as the reference's JAX
    propagator: a *static* shared gather index (the flattened incidence)
    plus a precomputed liveness mask; dead slots read the 2n sentinel,
    neutral under min. Each round relaxes once and jumps three times;
    the loop ends when a round changes nothing. The fixed point --
    per-component label minima -- does not depend on the seed, so cold
    and warm starts agree bit for bit with ``_propagate_numpy``.
    """
    n = graph.n
    trials = alive.shape[0]
    deg_max = _cover_dense(graph)[0].shape[1]
    nbr_flat, edge_flat = _torch_tables(graph, device)
    alive_t = torch.as_tensor(np.ascontiguousarray(alive), device=device)
    alive_ext = torch.cat(
        [alive_t, torch.zeros((trials, 1), dtype=torch.bool,
                              device=device)], dim=1)
    pad_alive = alive_ext[:, edge_flat]           # (T, 2n*deg)
    if labels0 is None:
        labels = torch.arange(2 * n, dtype=torch.int64,
                              device=device).repeat(trials, 1)
    else:
        labels = torch.as_tensor(labels0.astype(np.int64), device=device)
    big = torch.tensor(2 * n, dtype=torch.int64, device=device)
    while True:
        vals = torch.where(pad_alive, labels[:, nbr_flat], big)
        new = torch.minimum(
            labels, vals.view(trials, 2 * n, deg_max).amin(dim=2))
        for _ in range(3):  # pointer jumping (cheap vs the relax)
            new = torch.gather(new, 1, new)
        if torch.equal(new, labels):
            return labels.cpu().numpy().astype(_label_dtype(n))
        labels = new


def _alpha_from_labels(labels: np.ndarray, n: int) -> np.ndarray:
    """Cover labels (T, 2n) -> alpha (T, n) float64, bit-identical to the
    scalar Section III decoder (see module docstring)."""
    trials = labels.shape[0]
    idt = np.int32 if 2 * trials * n < 2 ** 31 else np.int64
    l0 = labels[:, :n]
    l1 = labels[:, n:]
    nonbip_v = l0 == l1
    root = np.minimum(l0, l1).astype(idt)  # min vertex of the G-component
    color = l1 < l0  # False = root's side
    base = root + (np.arange(trials, dtype=idt) * n)[:, None]
    ids2 = (base << 1) | color
    cnt = np.bincount(ids2.ravel(), minlength=2 * trials * n)
    own_side = cnt[ids2]
    other_side = cnt[ids2 ^ 1]
    total = own_side + other_side
    nb_cnt = np.bincount(base[nonbip_v], minlength=trials * n)
    nb_comp = nb_cnt[base] > 0
    # Same float expressions as optimal_alpha_graph: delta, then 1 -/+.
    delta = np.abs(own_side - other_side) / total
    alpha = np.where(own_side >= other_side, 1.0 - delta, 1.0 + delta)
    return np.where(nb_comp, 1.0, alpha)


# ---------------------------------------------------------------------------
# Public batched decoders
# ---------------------------------------------------------------------------


def is_graph_scheme(assignment: Assignment) -> bool:
    """True for Def II.2 schemes (machines = edges of the carried
    graph): the schemes the O(m) component decoders serve. Single
    dispatch predicate shared by the scalar, batched and sweep paths.
    Keyed on the explicit ``machines`` marker, not the A shape --
    adjacency assignments also carry a graph, and for 2-regular graphs
    their n x n shape is indistinguishable from (n, m); they must fall
    through to the pseudoinverse."""
    return assignment.graph is not None and assignment.machines == "edges"


def _resolve_backend(backend: str, work: int, device) -> str:
    """'numpy' or 'torch' for a batch of ``work`` mask entries."""
    if backend == "jax":
        raise ValueError("backend 'jax' is the reference's; the port's "
                         "device backend is 'torch'")
    if backend not in ("auto", "numpy", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "auto":
        return ("torch" if work >= _TORCH_MIN_WORK and
                resolve(device).type == "cuda" else "numpy")
    return backend


def _check_masks(alive, m: int) -> np.ndarray:
    alive = np.asarray(alive, dtype=bool)
    if alive.ndim != 2:
        raise ValueError(f"alive must be (trials, m), got {alive.shape}")
    if alive.shape[1] != m:
        raise ValueError(f"alive has {alive.shape[1]} machines, wanted {m}")
    return alive


def batched_optimal_alpha_graph(graph: Graph, alive, *,
                                backend: str = "auto", labels0=None,
                                return_labels: bool = False,
                                device=None):
    """alpha* (trials, n) for a (trials, m) batch of masks over one graph.

    backend: 'numpy' | 'torch' | 'auto' ('auto' takes the torch
    propagator on the card for batches of at least ``_TORCH_MIN_WORK``
    mask entries and NumPy otherwise; 'torch' runs it on ``device``,
    which may be the CPU). ``device=None`` means the card, and is only
    resolved when the torch propagator could run.

    ``labels0`` warm-starts the label propagation with the (trials, 2n)
    cover labels of a *previous* decode whose masks were subsets of
    ``alive`` (per trial) -- the sweep engine's nested-in-p protocol.
    Any seed satisfying that containment leaves the fixed point (and
    hence alpha) bit-identical to a cold start; it only cuts rounds.
    ``return_labels=True`` additionally returns the fixed-point labels
    so the caller can seed the next grid point.
    """
    alive = _check_masks(alive, graph.m)
    trials = alive.shape[0]
    n = graph.n
    if trials == 0:
        out = np.zeros((0, n), dtype=np.float64)
        if return_labels:
            return out, np.zeros((0, 2 * n), dtype=_label_dtype(n))
        return out
    backend = _resolve_backend(backend, alive.size, device)
    if labels0 is not None:
        labels0 = _check_labels0(labels0, trials, n)
    # Chunk the batch so the (T, 2n, deg_max) gather stays in-cache-ish
    # and bounded in memory (~200 MB of int32 per intermediate).
    deg_max = _cover_dense(graph)[0].shape[1]
    chunk = max(1, int(5e7) // max(2 * n * deg_max, 1))
    ldt = _label_dtype(n)
    out = np.empty((trials, n), dtype=np.float64)
    out_labels = (np.empty((trials, 2 * n), dtype=ldt)
                  if return_labels else None)
    for lo in range(0, trials, chunk):
        part = alive[lo:lo + chunk]
        part_l0 = None if labels0 is None else labels0[lo:lo + chunk]
        if backend == "torch":
            labels = _propagate_torch(graph, part, part_l0,
                                      resolve(device))
        else:
            labels = _propagate_numpy(graph, part, part_l0)
        out[lo:lo + chunk] = _alpha_from_labels(labels, n)
        if out_labels is not None:
            out_labels[lo:lo + chunk] = labels
    if return_labels:
        return out, out_labels
    return out


def fixed_scale(d: float, p: float) -> float:
    """The Section VIII fixed-decoding coefficient 1/(d (1-p)).

    The single definition (validation included) shared by every fixed
    decoder -- scalar, batched, and the stacked grid -- whose
    bit-identity contract depends on this expression being evaluated
    identically everywhere."""
    if p >= 1.0:
        raise ValueError(f"fixed decoding requires p < 1, got p={p}")
    return 1.0 / (d * (1.0 - p))


def fixed_w(alive, d: float, p: float) -> np.ndarray:
    """Section VIII fixed weights: 1/(d (1-p)) on survivors, 0 on
    stragglers. ``alive`` may be a single (m,) mask or a (trials, m)
    batch; shared by the scalar and batched fixed decoders."""
    return np.where(alive, fixed_scale(d, p), 0.0)


def counts_are_exact(assignment: Assignment) -> bool:
    """True when every entry of A is a small nonnegative integer, so
    ``alive @ A.T`` runs entirely in exactly-representable integers:
    the sum is then independent of summation order / BLAS blocking, and
    a stacked (P*trials, m) grid matmul is bit-identical to per-point
    (or per-mask) matmuls. Every shipped scheme (graph / FRC /
    adjacency / Bernoulli / uncoded) satisfies this; the guard keeps a
    hypothetical weighted assignment on the order-sensitive path.
    The O(n*m) scan is cached on the assignment
    (``Assignment.integer_matrix``)."""
    return assignment.integer_matrix


def batched_fixed_alpha(assignment: Assignment, alive,
                        p: float) -> np.ndarray:
    """Section VIII fixed decoding for a batch: alpha = A w with
    w = 1/(d (1-p)) on survivors -- evaluated count-first
    (``(alive @ A.T) * c``, exact integer counts) for integer A so the
    result is batching-invariant; see ``decoding.fixed_decode``."""
    alive = _check_masks(alive, assignment.m)
    if not counts_are_exact(assignment):
        w = fixed_w(alive, assignment.replication_factor, p)
        return w @ assignment.A.T
    c = fixed_scale(assignment.replication_factor, p)
    return (alive.astype(np.float64) @ assignment.A.T) * c


def fixed_alpha_grid(assignment: Assignment, masks,
                     p_grid) -> np.ndarray:
    """Fixed decoding for a whole (P, trials, m) mask grid in ONE
    stacked counts matmul: alpha[i] = (masks[i] @ A.T) / (d (1-p_i)).

    Bit-identical to ``batched_fixed_alpha(A, masks[i], p_grid[i])``
    per point because the counts matmul is exact integer arithmetic
    (order-independent); the stacked (P*trials, m) GEMM is what makes
    the campaign's fixed path ~P times cheaper than the per-point loop
    (one well-blocked BLAS call instead of P skinny ones).
    """
    masks = np.asarray(masks, dtype=bool)
    if masks.ndim != 3 or masks.shape[2] != assignment.m:
        raise ValueError(f"masks must be (P, trials, {assignment.m}), "
                         f"got {masks.shape}")
    P, trials, m = masks.shape
    if len(p_grid) != P:
        raise ValueError(f"p_grid has {len(p_grid)} entries for {P} "
                         "mask batches")
    if not counts_are_exact(assignment):
        return np.stack([batched_fixed_alpha(assignment, masks[i],
                                             float(p_grid[i]))
                         for i in range(P)])
    d = assignment.replication_factor
    scales = np.asarray([fixed_scale(d, float(p)) for p in p_grid])
    counts = (masks.reshape(P * trials, m).astype(np.float64)
              @ assignment.A.T).reshape(P, trials, assignment.n)
    return counts * scales[:, None, None]


def batched_frc_alpha(assignment: Assignment, alive) -> np.ndarray:
    """FRC closed-form optimum for a batch: block survives (alpha = 1)
    iff any machine in its group survives."""
    alive = _check_masks(alive, assignment.m)
    counts = alive.astype(np.float64) @ (assignment.A > 0).T
    return (counts > 0).astype(np.float64)


def frc_alpha_grid(assignment: Assignment, masks) -> np.ndarray:
    """FRC closed form for a (P, trials, m) grid in one stacked counts
    matmul; bit-identical to per-point ``batched_frc_alpha`` (exact
    integer counts, thresholded)."""
    masks = np.asarray(masks, dtype=bool)
    if masks.ndim != 3 or masks.shape[2] != assignment.m:
        raise ValueError(f"masks must be (P, trials, {assignment.m}), "
                         f"got {masks.shape}")
    P, trials, m = masks.shape
    counts = (masks.reshape(P * trials, m).astype(np.float64)
              @ (assignment.A > 0).T)
    return (counts > 0).astype(np.float64).reshape(P, trials,
                                                   assignment.n)


def batched_alpha(assignment: Assignment, alive, *,
                  method: str = "optimal", p: float = 0.0,
                  backend: str = "auto", labels0=None,
                  return_labels: bool = False,
                  device=None) -> np.ndarray:
    """Batched mirror of ``decoding.decode`` returning alphas (trials, n).

    Dispatch matches the scalar path exactly: Def II.2 graph schemes use
    the batched component decoder, FRCs their closed form, everything
    else falls back to a per-trial pseudoinverse.

    ``labels0`` / ``return_labels`` expose the graph decoder's
    warm-start label protocol (see ``batched_optimal_alpha_graph``)
    through the dispatching entry point, so multi-scheme pipelines (the
    sweep campaign) can chain labels per scheme without special-casing
    graph schemes at every call site. Non-graph schemes have no label
    state: ``labels0`` must be None there, and ``return_labels=True``
    returns ``(alphas, None)``.
    """
    alive = _check_masks(alive, assignment.m)
    graph = method == "optimal" and is_graph_scheme(assignment)
    if not graph and labels0 is not None:
        raise ValueError("labels0 is only meaningful for optimal "
                         "decoding of graph schemes (no label state "
                         f"for {assignment.name!r}/{method!r})")
    if graph:
        return batched_optimal_alpha_graph(
            assignment.graph, alive, backend=backend, labels0=labels0,
            return_labels=return_labels, device=device)
    if method == "fixed":
        out = batched_fixed_alpha(assignment, alive, p)
    elif method != "optimal":
        raise ValueError(f"unknown method {method!r}")
    elif assignment.name.startswith("frc"):
        out = batched_frc_alpha(assignment, alive)
    else:
        from .decoding import optimal_decode_pinv  # lazy: import cycle

        if alive.shape[0] == 0:
            out = np.zeros((0, assignment.n), dtype=np.float64)
        else:
            out = np.stack(
                [optimal_decode_pinv(assignment, a).alpha for a in alive])
    return (out, None) if return_labels else out
