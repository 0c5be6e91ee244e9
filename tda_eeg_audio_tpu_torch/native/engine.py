"""The port's exact host engine: `csrc/rips_host.cpp` (Rips H0 + H1
persistence) and `csrc/wasserstein_host.cpp` (persim's exact diagram
Wasserstein), compiled together with the host's C++ compiler at first use
and bound to `SIGNATURES` by `ops.cuda_build.load`.

Its roles: recompute, without any arena or step budget, the windows whose
reduction the CUDA kernel (or, for CPU tensors, the plain reduction) flagged
as overflowed (`models/homology_exec.run_tda` scatters its diagrams back);
compute every window's diagrams where the caller asks for the host backend
(`run_tda(backend="host")`); and the exact Wasserstein distance of the
`host_exact` backend (`wasserstein_batch`).  Both run on the host's CPU
cores, as in the reference package; neither is a kernel."""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import numpy as np

from ..ops import cuda_build

SRC = Path(__file__).resolve().parent.parent / "csrc" / "rips_host.cpp"
SRCS = (SRC, SRC.with_name("wasserstein_host.cpp"))
_fp, _ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
_I, _F = ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "rips_host_batch": ([_fp, _I, _I, _F, _I, _I, _fp, _fp, _ip, _ip, _fp, _ip, _ip], None),
    "wasserstein_host_batch": ([_fp, _fp, _ip, _I, _fp, _fp, _ip, _I, _I, _I, _fp], None)}


def library_path() -> Path:
    """Where the library of the current sources is (or will be) built."""
    return cuda_build.library_path(SRCS)


def build() -> Path:
    """Compile the engine once per source content; returns the .so."""
    return cuda_build.build(SRCS)


def rips_persistence_batch(dm, thresh: float = 2.0, max_bars: int = 256,
                           n_threads: int | None = None) -> dict:
    """Exact H0 + H1 persistence of (B, n, n) float32 distance matrices
    (padding points at distances beyond `thresh`).

    Returns numpy arrays in the device path's conventions: births, deaths
    (B, max_bars; +inf death for an essential class), mask, n_essential,
    h0_deaths (B, n − 1; +inf where unused), h0_mask, n_tree, and overflow
    (B,), True only where a window has more than max_bars visible bars.
    Bars come in descending birth rank, as the device path emits them."""
    dm = np.ascontiguousarray(dm, dtype=np.float32)
    if dm.ndim != 3 or dm.shape[1] != dm.shape[2] or dm.shape[1] < 2:
        raise ValueError(f"dm must be (B, n, n) with n >= 2, got {dm.shape}")
    if max_bars < 1:
        raise ValueError(f"max_bars={max_bars} < 1")
    B, n, _ = dm.shape
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    h1_b = np.zeros((B, max_bars), np.float32)
    h1_d = np.zeros((B, max_bars), np.float32)
    h0_d = np.zeros((B, n - 1), np.float32)
    counts = {k: np.zeros(B, np.int32) for k in ("h1", "ess", "h0", "tree")}
    if B:
        cuda_build.load(SRCS, SIGNATURES).rips_host_batch(
            dm.ctypes.data_as(_fp), B, n, thresh, max_bars, n_threads,
            h1_b.ctypes.data_as(_fp), h1_d.ctypes.data_as(_fp),
            counts["h1"].ctypes.data_as(_ip), counts["ess"].ctypes.data_as(_ip),
            h0_d.ctypes.data_as(_fp), counts["h0"].ctypes.data_as(_ip),
            counts["tree"].ctypes.data_as(_ip))
    mask = np.arange(max_bars)[None, :] < counts["h1"][:, None]
    h0_mask = np.arange(n - 1)[None, :] < counts["h0"][:, None]
    return dict(births=np.where(mask, h1_b, 0.0).astype(np.float32),
                deaths=np.where(mask, h1_d, 0.0).astype(np.float32), mask=mask,
                n_essential=counts["ess"],
                h0_deaths=np.where(h0_mask, h0_d, np.inf).astype(np.float32),
                h0_mask=h0_mask, n_tree=counts["tree"],
                overflow=counts["h1"] > max_bars)


def _compact(b, d, m):
    """Each row's valid bars moved to its front (stable), and their counts."""
    m = np.asarray(m, bool)
    order = np.argsort(~m, axis=1, kind="stable")
    take = lambda x: np.ascontiguousarray(  # noqa: E731
        np.take_along_axis(np.asarray(x, np.float32), order, 1))
    return take(b), take(d), np.ascontiguousarray(m.sum(1), dtype=np.int32)


def wasserstein_batch(b1, d1, m1, b2, d2, m2,
                      n_threads: int | None = None) -> np.ndarray:
    """Exact persim Wasserstein distance of each pair of padded diagrams:
    (N, K1) births/deaths/mask against (N, K2), float32 result (N,).

    The masks select the finite bars to match (any positions: they are
    compacted here); an empty diagram is the single point (0, 0), as the
    reference's cleanup makes it."""
    b1c, d1c, c1 = _compact(b1, d1, m1)
    b2c, d2c, c2 = _compact(b2, d2, m2)
    if b1c.ndim != 2 or b2c.ndim != 2 or len(b1c) != len(b2c):
        raise ValueError(f"diagram batches of shapes {b1c.shape} and {b2c.shape}")
    N = len(b1c)
    out = np.zeros(N, np.float32)
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    if N:
        cuda_build.load(SRCS, SIGNATURES).wasserstein_host_batch(
            b1c.ctypes.data_as(_fp), d1c.ctypes.data_as(_fp), c1.ctypes.data_as(_ip),
            b1c.shape[1], b2c.ctypes.data_as(_fp), d2c.ctypes.data_as(_fp),
            c2.ctypes.data_as(_ip), b2c.shape[1], N, n_threads,
            out.ctypes.data_as(_fp))
    return out
