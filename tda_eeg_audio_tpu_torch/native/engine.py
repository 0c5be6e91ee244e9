"""The port's exact host engine: ctypes binding of `csrc/rips_host.cpp`
(Rips H0 + H1 persistence) and `csrc/wasserstein_host.cpp` (persim's exact
diagram Wasserstein), compiled together with g++ at first use into the build
directory.

Its roles: recompute, without any arena or step budget, the windows whose
reduction the CUDA kernel (or, for CPU tensors, the plain reduction) flagged
as overflowed (`models/homology_exec.run_tda` scatters its diagrams back);
compute every window's diagrams where the caller asks for the host backend
(`run_tda(backend="host")`); and the exact Wasserstein distance of the
`host_exact` backend (`wasserstein_batch`).  Both run on the host's CPU
cores, as in the reference package; neither is a kernel."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent.parent / "csrc" / "rips_host.cpp"
SRCS = (SRC, SRC.with_name("wasserstein_host.cpp"))
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torch_native"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """Where the library of the current sources is (or will be) built."""
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    for src in SRCS:
        h.update(src.read_bytes())
    return BUILD_DIR / f"librips_host_{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the engine once per source content; returns the .so."""
    so = library_path()
    if so.exists():
        return so
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError(f"no C++ compiler found to build {SRCS}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), *map(str, SRCS)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{cxx} failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, so)
    return so


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
            lib.rips_host_batch.argtypes = [
                fp, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                ctypes.c_int, fp, fp, ip, ip, fp, ip, ip]
            lib.rips_host_batch.restype = None
            lib.wasserstein_host_batch.argtypes = [
                fp, fp, ip, ctypes.c_int, fp, fp, ip, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, fp]
            lib.wasserstein_host_batch.restype = None
            _lib = lib
        return _lib


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
    fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
    if B:
        _load().rips_host_batch(
            dm.ctypes.data_as(fp), B, n, thresh, max_bars, n_threads,
            h1_b.ctypes.data_as(fp), h1_d.ctypes.data_as(fp),
            counts["h1"].ctypes.data_as(ip), counts["ess"].ctypes.data_as(ip),
            h0_d.ctypes.data_as(fp), counts["h0"].ctypes.data_as(ip),
            counts["tree"].ctypes.data_as(ip))
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
    fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
    if N:
        _load().wasserstein_host_batch(
            b1c.ctypes.data_as(fp), d1c.ctypes.data_as(fp), c1.ctypes.data_as(ip),
            b1c.shape[1], b2c.ctypes.data_as(fp), d2c.ctypes.data_as(fp),
            c2.ctypes.data_as(ip), b2c.shape[1], N, n_threads,
            out.ctypes.data_as(fp))
    return out
