"""Faithful host reimplementation of the reference's scipy signal chain.

Each function reproduces the corresponding reference function call-for-call
(same scipy routines, same parameters) so the port's signal ops can be
parity-tested against the exact algorithms the reference ran:

  load/envelope/bandpass/resample/windows/tau/takens —
  reference scripts/utils.py:47-116;
  SOS multichannel band-pass — reference notebooks/1_preprocesamiento.ipynb cell 1;
  sliding windows — cell 2; correlation/distance — notebooks/2 cell 4.

The port's copy of the reference package's ``oracle/signal_ref.py``, same
code, so that the port imports nothing of that package.
"""

from __future__ import annotations

import numpy as np
from scipy import signal as sps


def compute_envelope(s: np.ndarray, fs: float) -> np.ndarray:
    analytic = sps.hilbert(s)
    env = np.abs(analytic)
    nyq = fs / 2
    cutoff = min(50, nyq * 0.9)
    b, a = sps.butter(4, cutoff / nyq, btype="low")
    return sps.filtfilt(b, a, env)


def bandpass_filter(s: np.ndarray, fs: float, low: float, high: float) -> np.ndarray:
    nyq = fs / 2
    lo = max(low / nyq, 0.001)
    hi = min(high / nyq, 0.999)
    if lo >= hi:
        return s
    b, a = sps.butter(4, [lo, hi], btype="band")
    return sps.filtfilt(b, a, s)


def apply_bandpass_filter_sos(data: np.ndarray, low: float, high: float,
                              fs: float, order: int = 4) -> np.ndarray:
    """Multichannel SOS zero-phase band-pass (EEG path, notebook 1 cell 1)."""
    nyq = 0.5 * fs
    sos = sps.butter(order, [low / nyq, high / nyq], btype="band", output="sos")
    out = np.zeros_like(data)
    for i in range(data.shape[0]):
        out[i, :] = sps.sosfiltfilt(sos, data[i, :])
    return out


def resample_audio(audio: np.ndarray, fs_audio: int = 44100, fs_target: int = 250) -> np.ndarray:
    return sps.resample_poly(audio, fs_target, fs_audio)


def create_windows(s: np.ndarray, win: int, step: int) -> np.ndarray:
    out = []
    start = 0
    while start + win <= len(s):
        out.append(s[start:start + win])
        start += step
    return np.array(out) if out else np.array([]).reshape(0, win)


def create_sliding_windows(data: np.ndarray, window_size: float, overlap: float, fs: float):
    """(channels, samples) → (n_windows, channels, win) — notebook 1 cell 2."""
    n_channels, n_samples = data.shape
    win = int(window_size * fs)
    step = int(win * (1 - overlap))
    n_windows = (n_samples - win) // step + 1
    if n_windows < 1:
        return np.array([]), np.array([])
    windows = np.zeros((n_windows, n_channels, win))
    times = np.zeros(n_windows)
    for i in range(n_windows):
        a = i * step
        windows[i] = data[:, a:a + win]
        times[i] = (a + win // 2) / fs
    return windows, times


def compute_tau(s: np.ndarray, max_lag: int | None = None) -> int:
    if max_lag is None:
        max_lag = len(s) // 4
    max_lag = min(max_lag, len(s) - 1)
    sc = s - np.mean(s)
    ac = np.correlate(sc, sc, mode="full")
    ac = ac[len(ac) // 2:]
    ac = ac / (ac[0] + 1e-10)
    for i in range(1, min(max_lag, len(ac))):
        if ac[i] <= 0:
            return max(i, 1)
    return max(max_lag // 10, 1)


def takens_embedding(s: np.ndarray, dim: int, tau: int, subsample: int = 1) -> np.ndarray:
    n = len(s) - (dim - 1) * tau
    if n <= 0:
        return np.array([]).reshape(0, dim)
    idx = np.arange(n)[:, None] + np.arange(dim)[None, :] * tau
    pc = s[idx]
    if subsample > 1:
        pc = pc[::subsample]
    return pc


def normalize_point_cloud(pc: np.ndarray) -> np.ndarray:
    """Per-axis min-max to [0,1]; zero range → 1 (reference utils.py:127-130)."""
    pc_min = pc.min(axis=0)
    pc_range = pc.max(axis=0) - pc_min
    pc_range[pc_range == 0] = 1
    return (pc - pc_min) / pc_range


def compute_correlation_matrix(window_data: np.ndarray) -> np.ndarray:
    corr = np.corrcoef(window_data)
    return np.nan_to_num(corr, nan=0.0)


def correlation_to_distance(corr: np.ndarray, method: str = "euclidean") -> np.ndarray:
    corr = np.clip(corr, -1, 1)
    if method == "euclidean":
        d = np.sqrt(2 * (1 - corr))
    elif method == "abs":
        d = 1 - np.abs(corr)
    elif method == "standard":
        d = 1 - corr
    elif method == "sqrt":
        d = np.sqrt(1 - corr ** 2)
    else:
        raise ValueError(method)
    d = np.maximum(d, 0)
    np.fill_diagonal(d, 0)
    return d
