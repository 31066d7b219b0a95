"""Decoders: map a straggler mask to decoding coefficients w and alpha = A w.

The paper's central algorithmic contribution (Section III): for graph
assignment schemes, the *optimal* decoding coefficients

    w* = argmin_{w : w_j = 0 for stragglers} |A w - 1|_2

are computable in O(m) by analysing the connected components of the
sparsified graph G(p) (surviving machines = surviving edges):

  * non-bipartite component  -> alpha*_v = 1 everywhere;
  * bipartite component L|R (|L| >= |R|)
                             -> alpha*_v = 1 -/+ (|L|-|R|)/(|L|+|R|);
  * isolated vertex          -> alpha*_v = 0.

``w*`` itself is recovered by a spanning-tree back-substitution with one
symbolic unknown on an odd cycle (non-bipartite components only).

We also implement the general pseudoinverse decoder (Eq. 9) for
arbitrary assignment matrices, the fixed-coefficient decoder of
Section VIII, and the FRC closed-form optimal decoder.

Copy of ``repro.core.decoding``; the Monte-Carlo harness
(``monte_carlo_error``, ``debias_alpha``) waits for the harness slice.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .assignment import Assignment
from .batched_decoding import (counts_are_exact, fixed_scale, fixed_w,
                               is_graph_scheme)
from .graphs import Graph


@dataclasses.dataclass(frozen=True)
class DecodeResult:
    """w: (m,) decoding coefficients; alpha: (n,) effective block weights."""

    w: np.ndarray
    alpha: np.ndarray

    def error(self) -> float:
        """|alpha - 1|_2^2 (unnormalized decoding error)."""
        return float(np.sum((self.alpha - 1.0) ** 2))


# ---------------------------------------------------------------------------
# O(m) optimal decoder for graph schemes (Section III)
# ---------------------------------------------------------------------------


def _components_two_coloring(
    graph: Graph, alive: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, List[bool], List[List[int]],
           List[Optional[int]]]:
    """BFS over surviving edges.

    Returns (comp_id, color, comp_bipartite, comp_vertices, odd_edge):
      comp_id[v]        component index of vertex v
      color[v]          BFS 2-coloring in {0, 1}
      comp_bipartite[c] True if component c is bipartite
      comp_vertices[c]  vertices of component c
      odd_edge[c]       index of one same-color ("odd") surviving edge
                        in component c, or None if bipartite
    """
    n = graph.n
    inc = graph.incident_edges()
    edges = graph.edges
    comp_id = np.full(n, -1, dtype=np.int64)
    color = np.zeros(n, dtype=np.int64)
    comp_bipartite: List[bool] = []
    comp_vertices: List[List[int]] = []
    odd_edge: List[Optional[int]] = []

    for s in range(n):
        if comp_id[s] != -1:
            continue
        c = len(comp_bipartite)
        comp_id[s] = c
        color[s] = 0
        verts = [s]
        bip = True
        odd: Optional[int] = None
        queue = [s]
        while queue:
            u = queue.pop()
            for j in inc[u]:
                if not alive[j]:
                    continue
                a, b = edges[j]
                v = b if a == u else a
                if comp_id[v] == -1:
                    comp_id[v] = c
                    color[v] = 1 - color[u]
                    verts.append(v)
                    queue.append(v)
                elif color[v] == color[u]:
                    bip = False
                    if odd is None:
                        odd = j
        comp_bipartite.append(bip)
        comp_vertices.append(verts)
        odd_edge.append(odd)
    return comp_id, color, comp_bipartite, comp_vertices, odd_edge


def optimal_alpha_graph(graph: Graph, alive: np.ndarray) -> np.ndarray:
    """alpha* in O(n + m), straight from the Section III characterisation."""
    alive = np.asarray(alive, dtype=bool)
    comp_id, color, bip, verts, _ = _components_two_coloring(graph, alive)
    alpha = np.ones(graph.n, dtype=np.float64)
    for c, vs in enumerate(verts):
        if not bip[c]:
            continue  # alpha = 1 on non-bipartite components
        side0 = sum(1 for v in vs if color[v] == 0)
        side1 = len(vs) - side0
        if side0 + side1 == 1:
            alpha[vs[0]] = 0.0  # isolated vertex: no surviving machine
            continue
        # Larger side gets 1 - delta, smaller side gets 1 + delta.
        delta = abs(side0 - side1) / (side0 + side1)
        big_color = 0 if side0 >= side1 else 1
        for v in vs:
            alpha[v] = 1.0 - delta if color[v] == big_color else 1.0 + delta
    return alpha


def optimal_decode_graph(graph: Graph, alive: np.ndarray) -> DecodeResult:
    """Full O(m) decoder: alpha* plus an explicit w* with A w* = alpha*.

    Spanning-tree back-substitution. Tree edge weights are affine
    functions ``const + coeff * x`` of one unknown x placed on an odd
    cycle edge (non-bipartite components); x is fixed by the root
    equation. Bipartite components are consistent with x-free weights by
    construction of alpha*.
    """
    alive = np.asarray(alive, dtype=bool)
    n, edges = graph.n, graph.edges
    inc = graph.incident_edges()
    alpha = optimal_alpha_graph(graph, alive)
    comp_id, color, bip, verts, odd_edge = _components_two_coloring(
        graph, alive)

    w_const = np.zeros(graph.m, dtype=np.float64)
    w_coeff = np.zeros(graph.m, dtype=np.float64)

    for c, vs in enumerate(verts):
        if len(vs) == 1:
            continue
        root = vs[0]
        # BFS spanning tree of the surviving subgraph of this component.
        parent_edge: dict[int, int] = {}
        parity = {root: 0}
        order = [root]
        qi = 0
        while qi < len(order):
            u = order[qi]
            qi += 1
            for j in inc[u]:
                if not alive[j]:
                    continue
                a, b = edges[j]
                v = b if a == u else a
                if v not in parity:
                    parity[v] = parity[u] ^ 1
                    parent_edge[v] = j
                    order.append(v)
        # The symbolic unknown lives on an edge that is odd *with respect
        # to this tree's parity* (exists iff the component is
        # non-bipartite); being a non-tree edge, it closes an odd cycle.
        oe: Optional[int] = None
        if not bip[c]:
            tree_edges = set(parent_edge.values())
            for u in vs:
                for j in inc[u]:
                    if alive[j] and j not in tree_edges:
                        a, b = edges[j]
                        if parity[a] == parity[b]:
                            oe = j
                            break
                if oe is not None:
                    break
            if oe is None:
                raise RuntimeError("non-bipartite component lacks odd edge")
        if oe is not None:
            w_coeff[oe] = 1.0  # symbolic unknown x on the odd edge
        # Back-substitute leaves-first: each vertex's parent edge weight
        # absorbs the residual of its alpha equation.
        resid_const = {v: alpha[v] for v in vs}
        resid_coeff = {v: 0.0 for v in vs}
        if oe is not None:
            ea, eb = edges[oe]
            resid_coeff[ea] -= 1.0
            resid_coeff[eb] -= 1.0
        for v in reversed(order[1:]):
            j = parent_edge[v]
            w_const[j] = resid_const[v]
            w_coeff[j] += resid_coeff[v]
            a, b = edges[j]
            u = b if a == v else a
            resid_const[u] -= w_const[j]
            resid_coeff[u] -= w_coeff[j]
        # Root equation: resid tracked alpha - (assigned weights), so we
        # need resid_const[root] + resid_coeff[root] * x == 0.
        if oe is not None:
            rc, rk = resid_const[root], resid_coeff[root]
            if abs(rk) < 1e-12:
                raise RuntimeError("odd-cycle sensitivity vanished")
            x = -rc / rk
            w_const += w_coeff * x
            w_coeff[:] = 0.0  # coeffs are per-component; reset for the next
        else:
            if abs(resid_const[root]) > 1e-6 * max(len(vs), 1):
                raise RuntimeError(
                    f"bipartite component root residual {resid_const[root]}")
    w = w_const
    w[~alive] = 0.0
    return DecodeResult(w=w, alpha=alpha)


# ---------------------------------------------------------------------------
# General decoders
# ---------------------------------------------------------------------------


def optimal_decode_pinv(assignment: Assignment,
                        alive: np.ndarray) -> DecodeResult:
    """Eq. (9): alpha* = A(p) (A(p)^T A(p))^+ A(p)^T 1, any assignment."""
    alive = np.asarray(alive, dtype=bool)
    A = assignment.A
    m = A.shape[1]
    w = np.zeros(m, dtype=np.float64)
    if alive.any():
        As = A[:, alive]
        ws, *_ = np.linalg.lstsq(As, np.ones(A.shape[0]), rcond=None)
        w[alive] = ws
    return DecodeResult(w=w, alpha=A @ w)


def fixed_decode(assignment: Assignment, alive: np.ndarray,
                 p: float) -> DecodeResult:
    """Section VIII fixed decoding: w_j = 1/(d (1-p)) on survivors, which
    makes E[A w] = 1 for d-regular assignments.

    alpha is computed as ``(A @ alive) * c`` rather than ``A @ w``: for
    the 0/1 assignment matrices every partial sum of ``A @ alive`` is an
    exact small integer, so the result is independent of summation order
    and BLAS blocking -- which is what lets the sweep-campaign engine
    decode a whole (P * trials) grid through one stacked matmul while
    staying bit-identical to this per-mask oracle (the c-first order
    ``A @ w`` rounds once per addition and is *not* batching-stable).
    Non-integer assignment matrices keep the historical ``A @ w`` path.
    """
    alive = np.asarray(alive, dtype=bool)
    w = fixed_w(alive, assignment.replication_factor, p)
    if not counts_are_exact(assignment):
        return DecodeResult(w=w, alpha=assignment.A @ w)
    c = fixed_scale(assignment.replication_factor, p)
    counts = assignment.A @ alive.astype(np.float64)
    return DecodeResult(w=w, alpha=counts * c)


def optimal_decode_frc(assignment: Assignment,
                       alive: np.ndarray) -> DecodeResult:
    """Closed-form optimal decoding for the FRC: within each group of d
    machines holding the same block, give weight 1/(#survivors)."""
    alive = np.asarray(alive, dtype=bool)
    A = assignment.A
    n, m = A.shape
    w = np.zeros(m, dtype=np.float64)
    for i in range(n):
        js = np.nonzero(A[i])[0]
        live = js[alive[js]]
        if live.size:
            w[live] = 1.0 / live.size
    return DecodeResult(w=w, alpha=A @ w)


def decode(assignment: Assignment, alive: np.ndarray, *,
           method: str = "optimal", p: float = 0.0) -> DecodeResult:
    """Dispatch: 'optimal' uses the O(m) graph decoder when the assignment
    carries a graph, the FRC closed form for FRCs, else the pseudoinverse.
    'fixed' uses Section VIII's fixed coefficients."""
    if method == "fixed":
        return fixed_decode(assignment, alive, p)
    if method != "optimal":
        raise ValueError(f"unknown method {method!r}")
    if is_graph_scheme(assignment):
        # Def II.2 scheme (machines = edges): O(m) component decoder.
        return optimal_decode_graph(assignment.graph, alive)
    if assignment.name.startswith("frc"):
        return optimal_decode_frc(assignment, alive)
    return optimal_decode_pinv(assignment, alive)


# ---------------------------------------------------------------------------
# Error metrics (Definitions I.2 / I.3)
# ---------------------------------------------------------------------------


def normalized_error(alpha: np.ndarray) -> float:
    """(1/n) |alpha - 1|_2^2."""
    return float(np.mean((alpha - 1.0) ** 2))
