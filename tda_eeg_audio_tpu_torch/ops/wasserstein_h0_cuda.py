"""Hand-written CUDA kernel for the exact H0 Wasserstein of the comparison
stage, and its launcher.

Kernel: `csrc/wasserstein_h0.cu` (sm_90a).  It replaces no Pallas kernel:
the JAX package computes `wasserstein_h0_exact`
(`tda_eeg_audio_tpu/ops/wasserstein.py:190`) as two sorts and one
`lax.scan` over the rows of the alignment DP.  The port's plain version
(`ops/wasserstein.py::wasserstein_h0_exact_plain`) is a Python loop over
the K1 rows, ten small ops a row.  Here one warp computes one pair: each
side sorted in registers by a bitonic network of shuffles (SORT_KEYS keys a
lane), `cumw` summed in float64 and rounded once a prefix by a warp scan
where every partial sum is exact (`scan_is_exact`), else by one lane in
column order — torch's CPU cumsum either way, so the kernel equals the plain
version on the CPU bit for bit — the K1 rows in registers, five columns a
lane, the prefix min a warp scan.

What bounds it: the operations (the DP's cells and the sorts' compares,
~3.3 µs at 67 TFLOP/s) and the bytes (each death and mask read once, one
float written a pair: ~1.2 µs) at a comparison batch of 64 recordings, both
near a launch, so a call is one launch with nothing in front of it; rows are
read through their strides.

`ops.wasserstein.wasserstein_h0_exact` is the router: a CPU tensor takes
the plain loop, a CUDA tensor comes here and launches the kernel or raises —
there is no fallback.  `kernel_plan` is the host side's one decision; the
library reports its layout at load and the launcher raises unless it is the
plan's.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from . import cuda_build

__all__ = ["wasserstein_h0_cuda", "kernel_plan", "check_layout", "build", "SRC",
           "SIGNATURES", "MAX_K", "scan_is_exact"]

SRC = Path(__file__).resolve().parent.parent / "csrc" / "wasserstein_h0.cu"
WARPS = 4                 # pairs a block, one warp each
THREADS = 32 * WARPS
MAX_K = 128               # slots a side
COLS = 5                  # row columns a lane: 32 × 5 ≥ MAX_K + 1
SORT_KEYS = MAX_K // 32   # sort keys a lane
# static shared bytes a block: per warp both sorted sides (MAX_K float32
# each) and cumw (MAX_K + 1 floats)
SMEM_BYTES = WARPS * 4 * (2 * MAX_K + MAX_K + 1)
LAYOUT_FIELDS = ("threads", "pairs_per_block", "smem_bytes", "registers",
                 "local_bytes", "occupancy")
P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {"wasserstein_h0_launch": ([P, P, L, L, I, P, P, L, L, I, I, P, P], I),
              "wasserstein_h0_layout": ([P], I)}


def _network_steps(K: int) -> int:
    """Steps of the bitonic network over the next power of two ≥ K slots."""
    n = 1 << max(K - 1, 0).bit_length()
    return sum(range(1, n.bit_length()))


def kernel_plan(n_pairs: int, K1: int, K2: int) -> dict:
    """Launch plan of one call: one warp per pair, WARPS pairs a block, a
    grid of ceil(n_pairs / WARPS) blocks; each side's bitonic network (its
    steps: SORT_KEYS compares a lane each).  Raises for a pad width the
    kernel does not take (1 ≤ K ≤ MAX_K a side)."""
    if not (1 <= K1 <= MAX_K and 1 <= K2 <= MAX_K):
        raise ValueError(f"wasserstein_h0_cuda: pad widths ({K1}, {K2}) outside "
                         f"1..{MAX_K}")
    return dict(threads=THREADS, pairs_per_block=WARPS, smem_bytes=SMEM_BYTES,
                grid=-(-n_pairs // WARPS), columns_per_lane=COLS,
                sort_keys_per_lane=SORT_KEYS,
                sort_steps=(_network_steps(K1), _network_steps(K2)),
                dp_cells=K1 * (K2 + 1))


def scan_is_exact(halves) -> bool:
    """The kernel's test for taking cumw by a warp scan: the exponents of the
    nonzero finite float32 halves b / 2 (max(E, 1), E the biased exponent)
    span at most 29 − ceil(log2 K2), so every partial sum, in any order, is
    exact in float64 and the scan's prefixes are the sequential sum's."""
    import numpy as np

    h = np.asarray(halves, np.float32)
    fin = h[np.isfinite(h) & (h != 0)]
    if fin.size == 0:
        return True
    e = np.maximum((fin.view(np.uint32) >> 23) & 0xFF, 1).astype(int)
    K2 = h.size
    return int(e.max() - e.min()) <= 29 - (K2 - 1).bit_length()


def build() -> Path:
    """Compile the kernel (once per source content) and return the .so
    that `wasserstein_h0_cuda` loads."""
    return cuda_build.build(SRC)


@cuda_build.once_per_card
def check_layout(lib) -> dict:
    """The library's report (`LAYOUT_FIELDS`) against the plan: threads,
    pairs a block and shared bytes must be the plan's, within the card's
    limits (`cuda_build.check_layout`).  Raises on any disagreement."""
    return cuda_build.check_layout(lib, "wasserstein_h0_layout", LAYOUT_FIELDS,
                                   kernel_plan(1, 1, 1),
                                   ("threads", "pairs_per_block", "smem_bytes"), SRC)


def layout_report() -> dict:
    """`check_layout` of the library on the current card, once per card."""
    return check_layout(cuda_build.load(SRC, SIGNATURES), card=torch.cuda.current_device())


def _check(args):
    d1, m1, d2, m2 = args
    dev = d1.device
    if dev.type != "cuda" or any(x.device != dev for x in args):
        raise ValueError(f"wasserstein_h0_cuda: inputs must be on one CUDA "
                         f"device, not {[str(x.device) for x in args]}")
    if d1.dtype != torch.float32 or d2.dtype != torch.float32 or \
            m1.dtype != torch.bool or m2.dtype != torch.bool:
        raise ValueError("wasserstein_h0_cuda: deaths float32, masks bool")
    if any(x.dim() != 2 for x in args) or d1.shape != m1.shape or \
            d2.shape != m2.shape or d1.shape[0] != d2.shape[0]:
        raise ValueError("wasserstein_h0_cuda: (N, K1) and (N, K2) per side")
    if any(x.shape[1] > 1 and x.stride(1) != 1 for x in args):
        raise ValueError("wasserstein_h0_cuda: each row must be contiguous")


def wasserstein_h0_cuda(d1, m1, d2, m2) -> torch.Tensor:
    """Exact H0 Wasserstein of N diagram pairs: deaths (N, K) float32 and
    masks (N, K) bool per side on one CUDA device, each row contiguous (any
    row stride), 1 ≤ K ≤ MAX_K → (N,) float32.  One launch, no host
    synchronisation.  Raises for anything else."""
    args = (d1, m1, d2, m2)
    _check(args)
    N, K1 = d1.shape
    K2 = d2.shape[1]
    kernel_plan(N, K1, K2)
    dev = d1.device
    out = torch.empty(N, dtype=torch.float32, device=dev)
    if N == 0:
        return out
    with torch.cuda.device(dev):
        layout_report()
        rc = cuda_build.load(SRC, SIGNATURES).wasserstein_h0_launch(
            d1.data_ptr(), m1.data_ptr(), d1.stride(0), m1.stride(0), K1,
            d2.data_ptr(), m2.data_ptr(), d2.stride(0), m2.stride(0), K2, N,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wasserstein_h0_launch failed: cudaError {rc}")
    wasserstein_h0_cuda.launches += 1
    return out


wasserstein_h0_cuda.launches = 0
