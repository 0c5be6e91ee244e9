"""Runtime validation of distance matrices, from their diagnostics vector
(`models/programs._dm_diagnostics`: sym_bad, max_asym, neg_bad, min_val,
diag_bad, max_abs_diag, has_nan, has_inf)."""

from __future__ import annotations


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
