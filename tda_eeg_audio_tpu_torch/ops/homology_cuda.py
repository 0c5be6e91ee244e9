"""Hand-written CUDA kernel for the H1 cohomology reduction, and its wrapper.

Kernel: `csrc/h1_reduce.cu` (sm_90a), the counterpart of the reference's
Pallas TPU kernel `tda_eeg_audio_tpu/ops/homology_pallas.py::_reduce_kernel`
(launched by `h1_diagrams_pallas`).  One thread block reduces one window:
the working column lives in shared memory, finished columns in a global
arena allocated here.

What bounds it on an H100: each reduction step is a dependent chain of
block-wide reductions (pivot min → claim lookup → XOR), so a window's time
is its step count times the step latency — not bytes, not arithmetic.  The
design answers with many independent windows in flight (one block per
window over the grid, up to 132 SMs busy) rather than interleaved chains
inside a window.

Phase 1 (edge ranks, forest/H0, apparent sieve, creator list) and bar
extraction stay in PyTorch (`homology_h1`).  The plain PyTorch reduction
`homology_h1.reduce_plain` is the same function: `h1_diagrams_cuda` takes it
for a tensor on the CPU, and launches the kernel (or raises) for a CUDA
tensor — there is no fallback.

The kernel is compiled by `nvcc` at first use from the source in the
checkout into `build/torch_kernels/` and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from .homology_h1 import (_extract_bars, _phase1, h1_diagrams_plain,
                          map_window_chunks, reduction_inputs)

__all__ = ["h1_diagrams_cuda", "h1_diagrams_plain", "reduce_cuda", "build",
           "window_chunk"]

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "h1_reduce.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
ARENA_BYTES = 1 << 31       # stored-column arena per launch
MAX_NA = 128

_lib = None
build_seconds = None        # wall time of the last nvcc build (None: cached)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernel is built from "
                           f"{_SRC} on a machine with the CUDA toolkit")
    return path


def build(verbose: bool = False) -> Path:
    """Compile the kernel (once per source content) and return the .so."""
    global build_seconds
    src = _SRC.read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    so = BUILD_DIR / f"libh1_reduce_{tag}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(_SRC)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, so)
    build_seconds = time.perf_counter() - t0
    if verbose:
        print(res.stderr.strip())
    return so


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.h1_reduce_launch.argtypes = [P] * 9 + [I] * 6 + [P]
        lib.h1_reduce_launch.restype = I
        _lib = lib
    return _lib


def reduce_cuda(rank_mat, iu_r, ju_r, app_v, na_list, m_cx, n: int,
                step_budget: int):
    """Launch the kernel on the reduction operands of `reduction_inputs`.

    Same contract as `homology_h1.reduce_plain`: returns (pair_key (B, na)
    int32, steps (B,) int32, overflow (B,) bool)."""
    ins = (rank_mat, iu_r, ju_r, app_v, na_list, m_cx)
    B, na = na_list.shape
    m = iu_r.shape[1]
    dev = na_list.device
    for t in ins:
        if not t.is_cuda or t.device != dev:
            raise ValueError("reduce_cuda: every operand must be on one CUDA device")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("reduce_cuda: operands must be contiguous int32")
    if (rank_mat.shape != (B, n, n) or iu_r.shape != (B, m)
            or ju_r.shape != (B, m) or app_v.shape != (B, m)
            or m_cx.shape != (B,) or m != n * (n - 1) // 2):
        raise ValueError("reduce_cuda: inconsistent operand shapes")
    if na > MAX_NA:
        raise ValueError(f"reduce_cuda: na={na} > {MAX_NA}")
    W = (m * n + 31) // 32
    pair = torch.empty((B, na), dtype=torch.int32, device=dev)
    stepinfo = torch.empty((B, 2), dtype=torch.int32, device=dev)
    if B == 0:
        return pair, stepinfo[:, 0], stepinfo[:, 1].bool()
    stored = torch.empty((B, na, W), dtype=torch.int32, device=dev)
    lib = _load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.h1_reduce_launch(*(t.data_ptr() for t in ins), stored.data_ptr(),
                              pair.data_ptr(), stepinfo.data_ptr(),
                              B, n, m, na, W, step_budget, stream)
    if rc != 0:
        raise RuntimeError(f"h1_reduce_launch failed: cudaError {rc}")
    h1_diagrams_cuda.launches += 1
    return pair, stepinfo[:, 0], stepinfo[:, 1].bool()


def window_chunk(n: int, na_max: int) -> int:
    """Windows per launch, so that the stored-column arena stays within
    ARENA_BYTES."""
    m = n * (n - 1) // 2
    W = (m * n + 31) // 32
    return max(1, ARENA_BYTES // (min(na_max, m) * W * 4))


def h1_diagrams_cuda(dm: torch.Tensor, n_pts=None, *, n: int, thresh: float,
                     na_max: int = 96, h1_max: int = 96, step_budget: int = 8192):
    """Batched exact H1 diagrams; the reduction runs in the CUDA kernel.

    Same arguments and return contract as `homology_h1.h1_diagrams_plain`.
    A CPU tensor takes the plain PyTorch reduction; a CUDA tensor launches
    the kernel, in window chunks that bound the stored-column arena."""
    if dm.device.type == "cpu":
        return h1_diagrams_plain(dm, n_pts, n=n, thresh=thresh, na_max=na_max,
                                 h1_max=h1_max, step_budget=step_budget)
    if not dm.is_cuda:
        raise ValueError(f"h1_diagrams_cuda: unsupported device {dm.device}")
    if dm.dim() != 3 or dm.shape[1:] != (n, n):
        raise ValueError(f"h1_diagrams_cuda: dm must be (B, {n}, {n})")
    if dm.dtype != torch.float32:
        raise ValueError("h1_diagrams_cuda: dm must be float32")
    if na_max > MAX_NA:
        raise ValueError(f"na_max={na_max} > {MAX_NA}")

    def run(dm_c, n_pts_c):
        ph = _phase1(dm_c.contiguous(), n, thresh, na_max, n_pts_c)
        pair, steps, ovf = reduce_cuda(*reduction_inputs(ph), n=n,
                                       step_budget=step_budget)
        return _extract_bars(pair, steps, ovf, ph, n, h1_max)

    return map_window_chunks(run, dm, n_pts, window_chunk(n, na_max))


h1_diagrams_cuda.launches = 0
