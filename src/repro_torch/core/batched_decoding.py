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
min-reduce over the degree axis, and take-along-axis jumps. This copy
of ``repro.core.batched_decoding`` carries the NumPy backend only; the
reference's jitted propagator and the sweep engine's warm-start labels
wait for the training and harness slices.

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
"""

from __future__ import annotations

import functools

import numpy as np

from .assignment import Assignment
from .graphs import Graph


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
    what makes the batched sweep SIMD-friendly. Padding slots point
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
    """int16 labels when every node id fits (2n < 32768, the
    reference's bound, kept so labels match it dtype for dtype); halves
    the gather traffic of the memory-bound relax step."""
    return np.int16 if 2 * n < 32768 else np.int32


def _propagate_numpy(graph: Graph, alive: np.ndarray) -> np.ndarray:
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
    labels = np.tile(np.arange(2 * n, dtype=_label_dtype(n)), (trials, 1))
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


def _check_masks(alive, m: int) -> np.ndarray:
    alive = np.asarray(alive, dtype=bool)
    if alive.ndim != 2:
        raise ValueError(f"alive must be (trials, m), got {alive.shape}")
    if alive.shape[1] != m:
        raise ValueError(f"alive has {alive.shape[1]} machines, wanted {m}")
    return alive


def batched_optimal_alpha_graph(graph: Graph, alive) -> np.ndarray:
    """alpha* (trials, n) for a (trials, m) batch of masks over one graph."""
    alive = _check_masks(alive, graph.m)
    trials = alive.shape[0]
    n = graph.n
    if trials == 0:
        return np.zeros((0, n), dtype=np.float64)
    # Chunk the batch so the (T, 2n, deg_max) gather stays in-cache-ish
    # and bounded in memory (~200 MB of int32 per intermediate).
    deg_max = _cover_dense(graph)[0].shape[1]
    chunk = max(1, int(5e7) // max(2 * n * deg_max, 1))
    out = np.empty((trials, n), dtype=np.float64)
    for lo in range(0, trials, chunk):
        labels = _propagate_numpy(graph, alive[lo:lo + chunk])
        out[lo:lo + chunk] = _alpha_from_labels(labels, n)
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


def batched_frc_alpha(assignment: Assignment, alive) -> np.ndarray:
    """FRC closed-form optimum for a batch: block survives (alpha = 1)
    iff any machine in its group survives."""
    alive = _check_masks(alive, assignment.m)
    counts = alive.astype(np.float64) @ (assignment.A > 0).T
    return (counts > 0).astype(np.float64)


def batched_alpha(assignment: Assignment, alive, *,
                  method: str = "optimal", p: float = 0.0) -> np.ndarray:
    """Batched mirror of ``decoding.decode`` returning alphas (trials, n).

    Dispatch matches the scalar path exactly: Def II.2 graph schemes use
    the batched component decoder, FRCs their closed form, everything
    else falls back to a per-trial pseudoinverse.
    """
    alive = _check_masks(alive, assignment.m)
    if method == "optimal" and is_graph_scheme(assignment):
        return batched_optimal_alpha_graph(assignment.graph, alive)
    if method == "fixed":
        return batched_fixed_alpha(assignment, alive, p)
    if method != "optimal":
        raise ValueError(f"unknown method {method!r}")
    if assignment.name.startswith("frc"):
        return batched_frc_alpha(assignment, alive)
    from .decoding import optimal_decode_pinv  # lazy: import cycle

    if alive.shape[0] == 0:
        return np.zeros((0, assignment.n), dtype=np.float64)
    return np.stack(
        [optimal_decode_pinv(assignment, a).alpha for a in alive])
