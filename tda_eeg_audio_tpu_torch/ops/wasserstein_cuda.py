"""Hand-written CUDA kernel for the tiered H1 Sinkhorn of the comparison
stage, and its launcher.

Kernel: `csrc/sinkhorn_tiered.cu` (sm_90a).  It replaces no Pallas kernel:
the JAX package computes `_wass_sinkhorn_tiered`
(`tda_eeg_audio_tpu/models/programs.py:358`, over `ops/wasserstein.py`'s
`build_cost_matrix` and `sinkhorn_cost_stab`) as one XLA program per
128-pair chunk, pairs sorted by bar count, each chunk at the narrowest tier
width that holds it.  The port's plain version
(`models.programs.wass_sinkhorn_tiered_plain`) repeats that as a Python
loop of small ops with a host synchronisation per chunk.  On the H100 one
block computes one pair's whole ε ladder with the stabilised kernel matrix
in shared memory, at the pair's own tier width: pad rows and columns are
zero-cost pad↔pad matches whose entries in valid rows underflow to exactly
0, so the width changes nothing but the order of summation.

What bounds it: two S × S matvecs per iteration (240 iterations) and S²
`expf` per absorption (31 passes) per pair, at the card's FP32 and SFU
rates; the bars in and one float out per pair are far below.  Each
iteration is a dependent chain between two barriers, so the kernel is
latency-bound; blocks are sized per width class so that the narrow pairs
(most of a study batch) keep many blocks on an SM.

`models.programs._wass_sinkhorn_tiered` is the router: a CPU tensor takes
the plain version, a CUDA tensor comes here and launches the kernel or
raises — there is no fallback.  `kernel_plan` is the host side's one
decision, a pure function.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from . import cuda_build
from .wasserstein import ABSORB, EPS_HI, EPS_LO, ITERS, STEPS, W_TIERS

__all__ = ["sinkhorn_tiered_cuda", "kernel_plan", "pair_width", "build", "SRC",
           "WIDTHS"]

SRC = Path(__file__).resolve().parent.parent / "csrc" / "sinkhorn_tiered.cu"
MAX_WIDTH = 96               # the comparison's H1 pad width: the full tier
WIDTHS = W_TIERS + (MAX_WIDTH,)   # the kernel's width classes, bars per side
SMEM_LIMIT = 232_448         # dynamic shared memory a block may opt into

_libs = {}


def pair_width(count: int) -> int:
    """The class width of a pair whose larger side holds `count` bars: the
    smallest of WIDTHS that holds them."""
    for w in WIDTHS:
        if count <= w:
            return w
    raise ValueError(f"pair_width: {count} bars exceed {MAX_WIDTH}")


def class_shape(width: int) -> dict:
    """Block shape of one width class, as the source's `Layout<W>` sizes its
    launch: S = 2W rows, Kt at row stride S + 4, f of S doubles, u / v of S
    floats, four bar arrays of W, one float64 reduction slot per warp."""
    S = 2 * width
    threads = -(-S // 32) * 32
    floats = S * (S + 4) + 4 * S + 4 * width + 2 * (threads // 32)
    return dict(width=width, S=S, threads=threads, smem_bytes=floats * 4)


def kernel_plan(n_pairs: int, K: int) -> list:
    """Launch plan of one call over n_pairs pairs of (·, K)-padded diagrams:
    one launch per width class that a pair of ≤ K bars can take, each over
    all pairs (grid n_pairs, one block per pair)."""
    if not 1 <= K <= MAX_WIDTH:
        raise ValueError(f"kernel_plan: pad width {K} outside 1..{MAX_WIDTH}")
    plan = []
    for w in WIDTHS[:WIDTHS.index(pair_width(K)) + 1]:
        shape = class_shape(w)
        if shape["smem_bytes"] > SMEM_LIMIT:
            raise ValueError(f"kernel_plan: width {w} needs {shape['smem_bytes']} B")
        plan.append(dict(shape, grid=n_pairs))
    return plan


def eps_ladder() -> np.ndarray:
    """The relative ε of each rung, as `sinkhorn_cost_stab` computes it."""
    return np.array([EPS_HI * (EPS_LO / EPS_HI) ** (s / (STEPS - 1))
                     for s in range(STEPS)], np.float32)


def build(verbose: bool = False) -> Path:
    """Compile the kernel (once per source content) and return the .so."""
    return cuda_build.build_libraries([(SRC, ())], verbose)[0][0]


def _load():
    if "lib" not in _libs:
        lib = ctypes.CDLL(str(build()))
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sinkhorn_tiered_launch.argtypes = (
            [P, P, P, I, P, P, P, I, I, P, I, F, I, I, P, I, P])
        lib.sinkhorn_tiered_launch.restype = I
        _libs["lib"] = lib
    return _libs["lib"]


def sinkhorn_tiered_cuda(b1, d1, m1, b2, d2, m2) -> torch.Tensor:
    """The tiered Sinkhorn cost of N diagram pairs: b/d (N, K) float32 and
    m (N, K) bool per side, bars anywhere in the row, K ≤ 96, all
    contiguous on one CUDA device → (N,) float32 in input order.  One
    launch per width class (`kernel_plan`), no host synchronisation.
    Raises for anything else."""
    args = (b1, d1, m1, b2, d2, m2)
    dev = b1.device
    if dev.type != "cuda" or any(x.device != dev for x in args):
        raise ValueError(f"sinkhorn_tiered_cuda: inputs must be on one CUDA "
                         f"device, not {[str(x.device) for x in args]}")
    if any(x.dtype != torch.float32 for x in (b1, d1, b2, d2)) or \
            m1.dtype != torch.bool or m2.dtype != torch.bool:
        raise ValueError("sinkhorn_tiered_cuda: bars float32, masks bool")
    if any(x.dim() != 2 for x in args) or len({x.shape for x in args[:3]}) != 1 \
            or len({x.shape for x in args[3:]}) != 1 or b1.shape[0] != b2.shape[0]:
        raise ValueError("sinkhorn_tiered_cuda: (N, K1) and (N, K2) per side")
    if not all(x.is_contiguous() for x in args):
        raise ValueError("sinkhorn_tiered_cuda: inputs must be contiguous")
    N, K1 = b1.shape
    K2 = b2.shape[1]
    out = torch.empty(N, dtype=torch.float32, device=dev)
    if N == 0:
        return out
    plan = kernel_plan(N, max(K1, K2))
    ladder = eps_ladder()
    rel = ladder.ctypes.data_as(ctypes.c_void_p)
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for cls in plan:
            rc = lib.sinkhorn_tiered_launch(
                b1.data_ptr(), d1.data_ptr(), m1.data_ptr(), K1,
                b2.data_ptr(), d2.data_ptr(), m2.data_ptr(), K2, N,
                rel, STEPS, EPS_LO, ITERS, ABSORB,
                out.data_ptr(), cls["width"], stream)
            if rc != 0:
                raise RuntimeError(f"sinkhorn_tiered_launch (width {cls['width']}) "
                                   f"failed: cudaError {rc}")
            sinkhorn_tiered_cuda.launches += 1
    return out


sinkhorn_tiered_cuda.launches = 0
