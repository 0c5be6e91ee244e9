"""Feature-matrix layout of the classification stage.  Only the row layout
is here; the Random-Forest stage itself is not ported yet."""

from __future__ import annotations

import numpy as np

from ..config import BAND_NAMES, DIAGRAM_FEATURES


def feature_names_220() -> list[str]:
    """The 220 feature names, in row order."""
    return [f"{band}_{dim}_{feat}_{agg}" for band in BAND_NAMES
            for feat in DIAGRAM_FEATURES for dim in ("h0", "h1")
            for agg in ("mean", "std")]


def features_to_row(agg: np.ndarray) -> np.ndarray:
    """(5, 2, 11, 2) aggregate [band, h0/h1, feature, mean/std] → the
    220-vector in the reference's name order: feature-major within a band,
    h0/h1 interleaved, mean/std innermost."""
    return agg.transpose(0, 2, 1, 3).reshape(-1)
