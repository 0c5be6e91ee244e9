"""Host oracle for diagram Wasserstein distance, persim-compatible.

The reference computes EEG↔audio diagram distances with persim's
`wasserstein` (reference scripts/utils.py:12,180-191).  persim is not
available in this environment; this is an independent reimplementation of its
documented algorithm: 1-Wasserstein matching with

  * L∞ ground metric between off-diagonal points,
  * diagonal projection cost (death − birth)/2 (own projection only),
  * non-own diagonal slots priced at max of the current cost matrix
    (persim's blocking convention),
  * zero cost in the diagonal↔diagonal block,

solved exactly with scipy's Hungarian algorithm.  `safe_wasserstein`
reproduces the reference's cleanup semantics (drop non-finite rows, empty →
[[0, 0]], exceptions → NaN; reference scripts/utils.py:180-191).

The port's copy of the reference package's ``oracle/wasserstein_ref.py``,
same code, so that the port imports nothing of that package.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

__all__ = ["wasserstein", "safe_wasserstein", "persim_cost_matrix"]


def persim_cost_matrix(S: np.ndarray, T: np.ndarray) -> np.ndarray:
    M, N = len(S), len(T)
    D1 = np.abs(S[:, 0][:, None] - T[:, 0][None, :])
    D2 = np.abs(S[:, 1][:, None] - T[:, 1][None, :])
    DUL = np.maximum(D1, D2)
    D = np.zeros((M + N, M + N))
    D[0:M, 0:N] = DUL
    UR = np.max(D) * np.ones((M, M))
    np.fill_diagonal(UR, 0.5 * (S[:, 1] - S[:, 0]))
    D[0:M, N:] = UR
    UL = np.max(D) * np.ones((N, N))
    np.fill_diagonal(UL, 0.5 * (T[:, 1] - T[:, 0]))
    D[M:, 0:N] = UL
    return D


def wasserstein(dgm1: np.ndarray, dgm2: np.ndarray) -> float:
    """Exact persim-style 1-Wasserstein matching distance."""
    S = np.asarray(dgm1, dtype=np.float64).reshape(-1, 2)
    T = np.asarray(dgm2, dtype=np.float64).reshape(-1, 2)
    S = S[np.isfinite(S).all(axis=1)]
    T = T[np.isfinite(T).all(axis=1)]
    if len(S) == 0:
        S = np.array([[0.0, 0.0]])
    if len(T) == 0:
        T = np.array([[0.0, 0.0]])
    D = persim_cost_matrix(S, T)
    ri, ci = linear_sum_assignment(D)
    return float(D[ri, ci].sum())


def safe_wasserstein(dgm1, dgm2) -> float:
    """Reference cleanup semantics (scripts/utils.py:180-191)."""
    def clean(d):
        d = np.asarray(d, dtype=np.float64)
        if d.ndim != 2 or d.shape[0] == 0:
            return np.array([[0.0, 0.0]])
        m = np.isfinite(d).all(axis=1)
        d = d[m]
        return d if len(d) > 0 else np.array([[0.0, 0.0]])
    try:
        return wasserstein(clean(dgm1), clean(dgm2))
    except Exception:
        return np.nan
