"""Exact Vietoris-Rips persistence by the boundary-matrix reduction
(Edelsbrunner-Letscher-Zomorodian), NumPy on the host: ripser's semantics
(inclusive threshold, H0 bars born at 0, essential bars, no zero-persistence
pairs).  A copy kept in the benchmark; the reference uses it for the rare
window whose creators overflow the plain reduction's arena, and the tests
hold the plain reduction to it."""

from __future__ import annotations

import numpy as np

__all__ = [
    "rips_persistence_dm",
    "rips_persistence_points",
    "h0_mst_deaths",
]


def _mst_kruskal(n: int, edges_ij: np.ndarray, order: np.ndarray):
    """Kruskal over pre-sorted edge order.  Returns (is_mst_edge mask, parent find fn)."""
    parent = np.arange(n)

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    is_tree = np.zeros(len(order), dtype=bool)
    for rank, eidx in enumerate(order):
        i, j = edges_ij[eidx]
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[ri] = rj
            is_tree[rank] = True
    return is_tree, find


def h0_mst_deaths(dm: np.ndarray, thresh: float) -> tuple[np.ndarray, int]:
    """H0 finite death values (MST merge weights <= thresh) and #components at thresh."""
    n = dm.shape[0]
    iu, ju = np.triu_indices(n, k=1)
    w = dm[iu, ju]
    keep = w <= thresh
    iu, ju, w = iu[keep], ju[keep], w[keep]
    order = np.argsort(w, kind="stable")
    edges_ij = np.stack([iu, ju], axis=1)
    is_tree, find = _mst_kruskal(n, edges_ij, order)
    deaths = w[order][is_tree]
    n_comp = len({find(v) for v in range(n)})
    return deaths, n_comp


def _enumerate_edges(dm: np.ndarray, thresh: float):
    n = dm.shape[0]
    iu, ju = np.triu_indices(n, k=1)
    w = dm[iu, ju]
    keep = w <= thresh
    iu, ju, w = iu[keep], ju[keep], w[keep]
    # Sort by (weight, i, j) — any refinement of the filtration order works.
    order = np.lexsort((ju, iu, w))
    return iu[order], ju[order], w[order]


def rips_persistence_dm(
    dm: np.ndarray, maxdim: int = 1, thresh: float = 2.0
) -> list[np.ndarray]:
    """Exact Rips persistence diagrams [H0, H1] from a distance matrix.

    Mirrors ``ripser(dm, maxdim=1, thresh=t, distance_matrix=True)["dgms"]``
    as a multiset of (birth, death) pairs per dimension.
    """
    dm = np.asarray(dm, dtype=np.float64)
    n = dm.shape[0]
    if n == 0:
        return [np.empty((0, 2))] * (maxdim + 1)

    # ---------- H0 ----------
    ei, ej, ew = _enumerate_edges(dm, thresh)
    m = len(ew)
    parent = np.arange(n)

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    h0_deaths = []
    edge_positive = np.zeros(m, dtype=bool)  # creator edges (form a cycle)
    for k in range(m):
        ri, rj = find(ei[k]), find(ej[k])
        if ri == rj:
            edge_positive[k] = True
        else:
            parent[ri] = rj
            h0_deaths.append(ew[k])
    n_comp = len({find(v) for v in range(n)})
    h0 = [(0.0, d) for d in h0_deaths if d > 0.0]
    h0 += [(0.0, np.inf)] * n_comp
    dgms = [np.array(h0, dtype=np.float64).reshape(-1, 2)]
    if maxdim < 1:
        return dgms

    # ---------- H1: reduce the ∂2 boundary matrix over GF(2) ----------
    # Edge rank: position in filtration order (rows of ∂2).
    edge_rank = {}
    for k in range(m):
        edge_rank[(int(ei[k]), int(ej[k]))] = k

    # Enumerate triangles with diameter <= thresh, sorted by (diam, tie).
    # Vectorized triangle enumeration: for each pair (i<j), all k>j.
    tris_i, tris_j, tris_k = [], [], []
    for a in range(n - 2):
        for b in range(a + 1, n - 1):
            cs = np.arange(b + 1, n)
            tris_i.append(np.full(len(cs), a))
            tris_j.append(np.full(len(cs), b))
            tris_k.append(cs)
    ti = np.concatenate(tris_i) if tris_i else np.empty(0, dtype=int)
    tj = np.concatenate(tris_j) if tris_j else np.empty(0, dtype=int)
    tk = np.concatenate(tris_k) if tris_k else np.empty(0, dtype=int)
    diam = np.maximum(np.maximum(dm[ti, tj], dm[ti, tk]), dm[tj, tk])
    keep = diam <= thresh
    ti, tj, tk, diam = ti[keep], tj[keep], tk[keep], diam[keep]
    t_order = np.argsort(diam, kind="stable")
    ti, tj, tk, diam = ti[t_order], tj[t_order], tk[t_order], diam[t_order]

    n_words = (m + 63) // 64
    pivot_col: dict[int, np.ndarray] = {}  # low edge-rank -> reduced column bitset
    pivot_death: dict[int, float] = {}
    h1 = []

    def bitset(ranks):
        col = np.zeros(n_words, dtype=np.uint64)
        for r in ranks:
            col[r >> 6] |= np.uint64(1) << np.uint64(r & 63)
        return col

    def low_of(col) -> int:
        for wi in range(n_words - 1, -1, -1):
            v = int(col[wi])
            if v:
                return (wi << 6) + (v.bit_length() - 1)
        return -1

    for t in range(len(diam)):
        a, b, c = int(ti[t]), int(tj[t]), int(tk[t])
        r1 = edge_rank[(a, b)]
        r2 = edge_rank[(a, c)]
        r3 = edge_rank[(b, c)]
        col = bitset((r1, r2, r3))
        lo = low_of(col)
        while lo >= 0 and lo in pivot_col:
            col ^= pivot_col[lo]
            lo = low_of(col)
        if lo >= 0:
            pivot_col[lo] = col
            pivot_death[lo] = float(diam[t])

    # Pairs: creator edge `lo` dies at pivot_death[lo]; unpaired creators are essential.
    for k in range(m):
        if not edge_positive[k]:
            continue
        birth = float(ew[k])
        if k in pivot_death:
            death = pivot_death[k]
            if death > birth:
                h1.append((birth, death))
        else:
            h1.append((birth, np.inf))
    dgms.append(np.array(h1, dtype=np.float64).reshape(-1, 2))
    return dgms


def rips_persistence_points(
    points: np.ndarray, maxdim: int = 1, thresh: float = 2.0
) -> list[np.ndarray]:
    """Rips persistence of a Euclidean point cloud (mirrors ripser point-cloud mode)."""
    pts = np.asarray(points, dtype=np.float64)
    diff = pts[:, None, :] - pts[None, :, :]
    dm = np.sqrt(np.maximum((diff * diff).sum(-1), 0.0))
    return rips_persistence_dm(dm, maxdim=maxdim, thresh=thresh)
