"""Runtime validation of distance matrices (the reference's
validate_distance_matrix), on a matrix or from its diagnostics vector
(sym_bad, max_asym, neg_bad, min_val, diag_bad, max_abs_diag, has_nan,
has_inf), which the features program computes on the device
(`models/programs._dm_diagnostics`) and `matrix_diagnostics` on the host."""

from __future__ import annotations

import numpy as np


def issues_from_diagnostics(d) -> list[str]:
    """Issue strings of one matrix's 8 diagnostics — the checks, tolerances
    and wording of the reference's validate_distance_matrix."""
    issues: list[str] = []
    if d[0]:
        issues.append(f"not symmetric: max asymmetry={float(d[1]):.6f}")
    if d[2]:
        issues.append(f"negative values present: min={float(d[3]):.6f}")
    if d[4]:
        issues.append(f"nonzero diagonal: max={float(d[5]):.6f}")
    if d[6]:
        issues.append("contains NaN values")
    if d[7]:
        issues.append("contains Inf values")
    return issues


def validate_distance_matrix(dm, name: str = ""):
    """Validate one distance matrix; returns (is_valid, issues).

    The reference's checks and tolerances
    (scripts/tda_eeg_classification_v2.py:110-140): 2-D, square, symmetric
    (rtol 1e-5), non-negative, zero diagonal, no NaN / Inf."""
    issues: list[str] = []
    dm = np.asarray(dm)
    if dm.ndim != 2:
        issues.append(f"not 2-D: shape={dm.shape}")
        return False, issues
    n, m = dm.shape
    if n != m:
        issues.append(f"not square: shape=({n}, {m})")
        return False, issues
    if not np.allclose(dm, dm.T, rtol=1e-5, atol=1e-8):
        max_diff = np.max(np.abs(dm - dm.T))
        issues.append(f"not symmetric: max asymmetry={max_diff:.6f}")
    if np.any(dm < -1e-10):
        issues.append(f"negative values present: min={np.min(dm):.6f}")
    diag = np.diagonal(dm)
    if not np.allclose(diag, 0, atol=1e-10):
        issues.append(f"nonzero diagonal: max={np.max(np.abs(diag)):.6f}")
    if np.any(np.isnan(dm)):
        issues.append("contains NaN values")
    if np.any(np.isinf(dm)):
        issues.append("contains Inf values")
    return len(issues) == 0, issues


def matrix_diagnostics(dm) -> np.ndarray:
    """(..., n, n) → (..., 8) diagnostics vector, the numpy twin of the
    features program's device computation (`programs._dm_diagnostics`): the
    staged features path reads its window-0 matrices back and feeds
    `issues_from_diagnostics` from here."""
    dm = np.asarray(dm, np.float32)
    dmt = np.swapaxes(dm, -1, -2)
    with np.errstate(invalid="ignore"):
        ad = np.abs(dm - dmt)
        # (dm == dmt) escape: np.allclose treats equal infs as close, while
        # inf − inf is NaN in the difference
        sym_ok = np.all((dm == dmt) | (ad <= 1e-8 + 1e-5 * np.abs(dmt)),
                        axis=(-1, -2))
        diag = np.diagonal(dm, axis1=-2, axis2=-1)
        diag_ok = np.all(np.abs(diag) <= 1e-10, axis=-1)
        min_val = np.min(dm, axis=(-1, -2))
        neg_bad = min_val < -1e-10
    return np.stack([
        (~sym_ok).astype(np.float32), np.max(ad, axis=(-1, -2)),
        neg_bad.astype(np.float32), min_val,
        (~diag_ok).astype(np.float32),
        np.max(np.abs(diag), axis=-1),
        np.any(np.isnan(dm), axis=(-1, -2)).astype(np.float32),
        np.any(np.isinf(dm), axis=(-1, -2)).astype(np.float32)], axis=-1)
