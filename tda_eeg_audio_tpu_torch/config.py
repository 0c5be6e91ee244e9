"""Single typed configuration for the port (copy of the reference package's
`config.py`: same fields, same defaults, same derived shapes)."""

from __future__ import annotations

import dataclasses
from typing import Literal, Mapping

# ── Frequency bands (Hz) — reference scripts/utils.py:30-36 ──
FREQ_BANDS: Mapping[str, tuple[float, float]] = {
    "delta": (0.5, 4.0),
    "theta": (4.0, 8.0),
    "alpha": (8.0, 13.0),
    "beta": (13.0, 30.0),
    "gamma": (30.0, 50.0),
}
BAND_NAMES: tuple[str, ...] = tuple(FREQ_BANDS)

# ── Electrode selection — reference notebooks/1_preprocesamiento.ipynb cell 1 ──
GOOD_ELECTRODES_MATLAB: tuple[int, ...] = (
    2, 3, 4, 6, 7, 9, 11, 12, 13, 14, 15, 16, 18, 19, 20, 21, 22, 24, 25, 26,
    27, 28, 30, 31, 33, 34, 36, 38, 40, 41, 42, 44, 45, 46, 48, 49, 50, 51,
    52, 53, 54, 56, 57, 58, 59, 60, 65,
)
GOOD_ELECTRODES: tuple[int, ...] = tuple(x - 1 for x in GOOD_ELECTRODES_MATLAB)
N_ELECTRODES: int = len(GOOD_ELECTRODES)  # 47

# Feature names within a diagram, in reference emission order
# (reference scripts/utils.py:144-177).
DIAGRAM_FEATURES: tuple[str, ...] = (
    "n_features", "n_essential", "mean_birth", "std_birth", "mean_death",
    "std_death", "mean_persistence", "std_persistence", "max_persistence",
    "total_persistence", "persistence_entropy",
)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """All knobs of the study pipeline (defaults == reference values)."""

    fs_eeg: int = 250
    fs_audio: int = 44100

    window_sec: float = 1.0
    overlap: float = 0.75

    filter_order: int = 4
    # "fir": linear-phase FIR matched to the zero-phase Butterworth |H|²;
    # "iir_scan": exact Butterworth filtfilt (float64 recurrence; the CUDA
    # kernel csrc/sosfiltfilt.cu on the card), the parity path
    filter_impl: Literal["fir", "iir_scan"] = "fir"
    fir_numtaps: int = 1537

    max_dim: int = 1
    max_edge_length: float = 2.0
    takens_dim: int = 3
    takens_subsample: int = 2

    distance_method: Literal["euclidean", "abs", "standard", "sqrt"] = "euclidean"

    n_splits: int = 5
    n_permutations: int = 1000
    n_bootstrap: int = 1000
    random_state: int = 42
    equalize_windows: bool = True
    window_sampling: Literal["random", "first"] = "random"
    max_windows_per_band: int | str = "min"
    window_sample_seed: int = 42

    max_windows: int = 15
    alpha: float = 0.05

    homology_backend: Literal["auto", "device", "pallas", "host"] = "auto"
    wasserstein_backend: Literal["host_exact", "sinkhorn"] = "sinkhorn"
    compute_dtype: str = "float32"

    @property
    def win_samples(self) -> int:
        return int(self.window_sec * self.fs_eeg)  # 250

    @property
    def step_samples(self) -> int:
        return int(self.win_samples * (1.0 - self.overlap))  # 62

    @property
    def max_takens_points(self) -> int:
        n = self.win_samples - (self.takens_dim - 1) * 1
        return -(-n // self.takens_subsample)  # 124


DEFAULT_CONFIG = PipelineConfig()
