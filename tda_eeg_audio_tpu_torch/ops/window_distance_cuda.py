"""Hand-written CUDA kernel for the EEG window → correlation-distance step,
and its launcher.

Kernel: `csrc/window_distance.cu` (sm_90a).  It replaces no Pallas kernel:
the JAX package, like the port's CPU path (`ops.geometry.window_distances_plain`,
the specification), writes every window of every band, gathers the
selected ones and runs generic reductions, elementwise passes and a batched
GEMM over them, ~11-12 GB of device memory a features batch of 64
recordings.  Here a block takes one selected window: its C × win samples
read once from the banded signal through the view's strides (the FIR bank's
strided slice of the `irfft` buffer or the IIR bank's contiguous output,
neither copied), the moments and the Gram matrix on chip (float32 FMAs over
a third of the window a thread in chunks of 32 steps, the chunks summed in
float64), the C × C distances written once.

What bounds it: FP32 FMAs and shared-memory bandwidth, about level (a 4 × 4
register tile a thread against two broadcast loads a step); the bytes (the
banded signal once, the distances once) are a smaller floor.

`ops.geometry.window_distances` is the router: a CPU tensor takes the plain
chain, a CUDA tensor comes here and launches the kernel or raises — there is
no fallback.  `kernel_plan` is the host side's one decision; the library
reports its layout at its first use on a card and the launcher raises unless
it is the plan's.  Counter `window_distance.windows`: the windows the kernel
computed.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..runtime import count
from . import cuda_build

__all__ = ["window_distances_cuda", "run", "kernel_plan", "check_layout", "build", "SRC",
           "SIGNATURES", "METHODS", "MAX_C"]

SRC = Path(__file__).resolve().parent.parent / "csrc" / "window_distance.cu"
THREADS = 256
MAX_C = 48                # channels a window holds
CP = 52                   # floats a staged sample row: MAX_C + 4 (13 float4s)
OCCUPANCY = 3             # blocks an SM the build must reach at the study's window
STUDY_WIN = 250           # the window length the layout is checked at
METHODS = ("euclidean", "abs", "standard", "sqrt")   # correlation_to_distance's
LAYOUT_FIELDS = ("threads", "max_c", "cp", "smem_bytes", "registers", "local_bytes",
                 "occupancy")
P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {"window_distance_launch": ([P, L, L, L, L, P, L, L, L, I, I, I, I, I, I, I,
                                          I, I, I, I, P, P], I),
              "window_distance_layout": ([I, P], I)}


def kernel_plan(B: int, NB: int, K: int, C: int, win: int) -> dict:
    """Launch plan of one call over B × NB × K windows of C channels and
    win samples: a block of THREADS a window; nt = ceil(C / 4) tile rows,
    the upper triangle's nt(nt + 1)/2 tiles of 4 × 4 channel pairs, each
    over THREADS // tiles slices of t (at most win); dynamic shared memory
    for the staged window (win × CP floats) or the Gram partials (16
    doubles a tile and slice) and the MAX_C × MAX_C distances, whichever is
    larger.  Raises for what the kernel does
    not take: C outside 1..MAX_C, win < 1, a window past a block's shared
    memory."""
    if not 1 <= C <= MAX_C:
        raise ValueError(f"window_distances_cuda: {C} channels outside 1..{MAX_C}")
    if win < 1:
        raise ValueError(f"window_distances_cuda: window of {win} samples")
    nt = -(-C // 4)
    tiles = nt * (nt + 1) // 2
    slices = min(THREADS // tiles, win)
    smem = max(4 * win * CP, 8 * 16 * tiles * slices + 4 * MAX_C * MAX_C)
    if smem > cuda_build.SMEM_LIMIT - 1024:
        raise ValueError(f"window_distances_cuda: a window of {win} samples needs {smem} "
                         "bytes of shared memory, past a block's")
    windows = B * NB * K
    if windows >= 2 ** 31:
        raise ValueError(f"window_distances_cuda: {windows} windows in one launch")
    return dict(threads=THREADS, max_c=MAX_C, cp=CP, nt=nt, tiles=tiles, slices=slices,
                smem_bytes=smem, grid=windows, windows=windows, occupancy=OCCUPANCY)


def build() -> Path:
    """Compile the kernel (once per source content) and return the .so
    that `window_distances_cuda` loads."""
    return cuda_build.build(SRC)


@cuda_build.once_per_card
def check_layout(lib) -> dict:
    """The library's report (`LAYOUT_FIELDS`, at the study's window length
    and MAX_C) against the plan: threads, MAX_C and CP must be the plan's,
    the shared bytes within a block's limit, OCCUPANCY blocks an SM
    (`cuda_build.check_layout`).  Raises on any disagreement."""
    plan = kernel_plan(1, 1, 1, MAX_C, STUDY_WIN)
    return cuda_build.check_layout(lib, "window_distance_layout", LAYOUT_FIELDS, plan,
                                   ("threads", "max_c", "cp"), SRC, STUDY_WIN)


def layout_report() -> dict:
    """`check_layout` of the library on the current card, once per card."""
    return check_layout(cuda_build.load(SRC, SIGNATURES), card=torch.cuda.current_device())


def _check(banded, use_idx, method):
    dev = banded.device
    if dev.type != "cuda" or use_idx.device != dev:
        raise ValueError(f"window_distances_cuda: banded and use_idx must be on one CUDA "
                         f"device, not {banded.device} / {use_idx.device}")
    if banded.dtype != torch.float32 or banded.dim() != 4:
        raise ValueError("window_distances_cuda: banded (B, C, bands, T) float32")
    if use_idx.dtype != torch.int64 or use_idx.dim() != 3 \
            or use_idx.shape[:2] != (banded.shape[0], banded.shape[2]):
        raise ValueError("window_distances_cuda: use_idx (B, bands, K) int64 over "
                         f"banded {tuple(banded.shape)}, not {tuple(use_idx.shape)} "
                         f"{use_idx.dtype}")
    if method not in METHODS:
        raise ValueError(f"Unknown method: {method}")


def run(lib, banded, use_idx, method, win, step, plan) -> torch.Tensor:
    """One launch of `lib` (this library or a saved design with the same C
    interface) over checked inputs at `kernel_plan`'s plan → out (B, bands,
    K, C, C)."""
    B, C, NB, T = banded.shape
    K = use_idx.shape[2]
    dev = banded.device
    out = torch.empty((B, NB, K, C, C), dtype=torch.float32, device=dev)
    if plan["windows"] == 0:
        return out
    with torch.cuda.device(dev):
        rc = lib.window_distance_launch(
            banded.data_ptr(), *banded.stride(), use_idx.data_ptr(), *use_idx.stride(),
            plan["windows"], C, NB, T, K, win, step, METHODS.index(method), plan["nt"],
            plan["tiles"], plan["slices"], out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"window_distance_launch failed: cudaError {rc}")
    return out


def window_distances_cuda(banded: torch.Tensor, use_idx: torch.Tensor, method: str,
                          win: int, step: int) -> torch.Tensor:
    """`correlation_to_distance(correlation_matrix(window), method)` of each
    window use_idx[b, band, k] (samples [use_idx · step, + win) of banded[b,
    :, band], NaN at or past T) → (B, bands, K, C, C) float32.  banded (B, C,
    bands, T) float32 and use_idx (B, bands, K) int64 on one CUDA device, any
    strides.  One launch, no host synchronisation.  Raises for anything
    else."""
    _check(banded, use_idx, method)
    B, C, NB, _ = banded.shape
    plan = kernel_plan(B, NB, use_idx.shape[2], C, win)
    with torch.cuda.device(banded.device):
        layout_report()
    out = run(cuda_build.load(SRC, SIGNATURES), banded, use_idx, method, win, step, plan)
    if plan["windows"]:
        window_distances_cuda.launches += 1
        count("window_distance.windows", plan["windows"])
    return out


window_distances_cuda.launches = 0
