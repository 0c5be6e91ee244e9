"""Hand-written CUDA kernel for H1 phase 1 (edge ranks, spanning forest and
H0 deaths, apparent-pair sieve, creator list), and its launcher.

Kernel: `csrc/h1_phase1.cu` (sm_90a).  It replaces no Pallas kernel: the
JAX package computes `_phase1` (`tda_eeg_audio_tpu/ops/homology_h1.py:181`,
with `_boruvka_forest` at `:122`) as XLA ops in front of the Pallas body of
`h1_diagrams_pallas`.  The port's plain version is
`homology_h1._phase1`, whose apparent-pair sieve materialises (B, m, n)
gathers; the kernel keeps a window's rank matrix in shared memory as
uint16 and scans each edge's vertices until the first hit, one block per
window.  It returns `_phase1`'s dict bit for bit.

The stable edge sort stays in front of the kernel (`torch.sort`, as XLA's
sort is in front of the Pallas body).  `homology_cuda.h1_diagrams_cuda`
calls `phase1_cuda` for every CUDA tensor; a CPU tensor never reaches it
(the plain path runs `_phase1`), and a CUDA tensor launches the kernel or
raises — there is no fallback.  `kernel_plan` is the host side's one
decision, a pure function; the library reports its own layout at load.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from . import cuda_build
from .homology_h1 import static_tables

__all__ = ["phase1_cuda", "sort_edges", "kernel_plan", "sieve_compares",
           "build", "SRC"]

SRC = Path(__file__).resolve().parent.parent / "csrc" / "h1_phase1.cu"
SMEM_MAX = 232_448          # dynamic shared memory a block can have (sm_90)
MAX_N = 128                 # ranks fit uint16 and vertices uint8
MAX_NA = 128
MAX_WARPS = 32

_libs = {}


def _up16(x: int) -> int:
    return (x + 15) & ~15


def kernel_plan(n: int, na_max: int) -> dict:
    """Block shape for n-point windows: threads (at least one per vertex, a
    multiple of 32), the dynamic shared-memory bytes (the layout of
    `csrc/h1_phase1.cu::layout`: uint16 rank matrix, uint8 endpoints and
    edge flags by rank, three int arrays of the forest, the scan's
    scratch), the edge count m and the creator list's width na_eff =
    min(na_max, m), as `_phase1` slices it."""
    if not 2 <= n <= MAX_N:
        raise ValueError(f"kernel_plan: n={n} outside 2..{MAX_N}")
    if not 1 <= na_max <= MAX_NA:
        raise ValueError(f"kernel_plan: na_max={na_max} outside 1..{MAX_NA}")
    m = n * (n - 1) // 2
    threads = 128 if n <= 64 else 256
    smem = (_up16(2 * n * n) + 3 * _up16(m) + 3 * _up16(4 * n)
            + _up16(4 * (2 * MAX_WARPS + 4)))
    if smem > SMEM_MAX:
        raise ValueError(f"kernel_plan: n={n} needs {smem} B of shared memory")
    return dict(threads=threads, smem_bytes=smem, m=m, na_eff=min(na_max, m))


def sieve_compares(vstar_r: torch.Tensor, n: int) -> torch.Tensor:
    """The int32 compares the apparent-pair sieve needs per window: two per
    (edge, v) scanned, an edge scanning v = 0 .. vstar (its first hit) or
    all n vertices when it has none.  vstar_r (B, m) → (B,) int64."""
    v = vstar_r.long()
    return 2 * torch.where(v >= 0, v + 1, n).sum(dim=-1)


def build(verbose: bool = False) -> Path:
    """Compile the kernel (once per source content) and return the .so."""
    return cuda_build.build_libraries([(SRC, ())], verbose)[0][0]


def _load():
    if "lib" not in _libs:
        lib = ctypes.CDLL(str(build()))
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.h1_phase1_launch.argtypes = [P] * 4 + [I, I, F, I, I, I] + [P] * 12
        lib.h1_phase1_launch.restype = I
        lib.h1_phase1_smem_bytes.argtypes = [I]
        lib.h1_phase1_smem_bytes.restype = I
        lib.h1_phase1_blocks_per_sm.argtypes = [I, I]
        lib.h1_phase1_blocks_per_sm.restype = I
        _libs["lib"] = lib
    return _libs["lib"]


@functools.lru_cache(maxsize=None)
def blocks_per_sm(n: int) -> int:
    """Blocks of `kernel_plan(n, ·)`'s shape one SM holds, from the library;
    also checks that the kernel lays out the bytes the plan reckons."""
    lib, plan = _load(), kernel_plan(n, 1)
    if lib.h1_phase1_smem_bytes(n) != plan["smem_bytes"]:
        raise RuntimeError("kernel_plan and csrc/h1_phase1.cu disagree on the "
                           f"shared-memory layout at n={n}")
    nb = lib.h1_phase1_blocks_per_sm(n, plan["threads"])
    if nb < 1:
        raise RuntimeError(f"no block of {plan['threads']} threads, "
                           f"{plan['smem_bytes']} B fits an SM (n={n})")
    return nb


@functools.lru_cache(maxsize=None)
def _flat_ut(n: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(static_tables(n)["flat_ut"], device=device)


def sort_edges(dm: torch.Tensor, n: int):
    """The edge weights in static (i < j, row-major) order, stably sorted:
    (ew_r (B, m) float32, e_sort (B, m) int64), as `_phase1` sorts them."""
    B = dm.shape[0]
    w = dm.reshape(B, n * n)[:, _flat_ut(n, dm.device)]
    return torch.sort(w, dim=-1, stable=True)


def _check(dm, n: int, n_pts):
    if dm.dim() != 3 or tuple(dm.shape[1:]) != (n, n):
        raise ValueError(f"phase1_cuda: dm must be (B, {n}, {n}), not "
                         f"{tuple(dm.shape)}")
    if dm.dtype != torch.float32:
        raise ValueError(f"phase1_cuda: dm must be float32, not {dm.dtype}")
    if not dm.is_contiguous():
        raise ValueError("phase1_cuda: dm must be contiguous")
    if n_pts is not None and (n_pts.shape != (dm.shape[0],)
                              or n_pts.dtype.is_floating_point
                              or n_pts.dtype in (torch.bool, torch.complex64,
                                                 torch.complex128)):
        raise ValueError("phase1_cuda: n_pts must be (B,) integers")
    if dm.device.type != "cuda":
        raise ValueError(f"phase1_cuda: dm must be on a CUDA device, not {dm.device}")


def _launch(dm, ew_r, e_sort, n_pts, n: int, thresh: float, na_max: int) -> dict:
    """One launch of the kernel on the sorted edges; the dict of `_phase1`."""
    plan = kernel_plan(n, na_max)
    B, m, na_eff = dm.shape[0], plan["m"], plan["na_eff"]
    dev = dm.device

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = dict(m=m, m_cx=empty(B), ew_r=ew_r, rank_mat=empty(B, n, n),
               iu_r=empty(B, m), ju_r=empty(B, m), vstar_r=empty(B, m),
               apparent_r=empty(B, m, dtype=torch.bool), na_list=empty(B, na_eff),
               overflow_na=empty(B, dtype=torch.bool),
               h0_deaths=empty(B, n - 1, dtype=torch.float32),
               h0_mask=empty(B, n - 1, dtype=torch.bool), n_tree=empty(B))
    if B == 0:
        return out
    if n_pts is not None:       # i < n_pts decides validity: clamping keeps it
        n_pts = n_pts.to(dev).clamp(0, n).to(torch.int32).contiguous()
    with torch.cuda.device(dev):
        blocks_per_sm(n)
        rc = _load().h1_phase1_launch(
            dm.data_ptr(), ew_r.data_ptr(), e_sort.data_ptr(),
            None if n_pts is None else n_pts.data_ptr(), B, n, thresh, na_eff,
            na_max, plan["threads"],
            *(out[k].data_ptr() for k in ("rank_mat", "iu_r", "ju_r", "vstar_r",
                                          "apparent_r", "na_list", "overflow_na",
                                          "h0_deaths", "h0_mask", "n_tree", "m_cx")),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"h1_phase1_launch failed: cudaError {rc}")
    phase1_cuda.launches += 1
    return out


def phase1_cuda(dm: torch.Tensor, n: int, thresh: float, na_max: int,
                n_pts=None) -> dict:
    """`homology_h1._phase1` on the card: the stable edge sort, then one
    launch of the kernel (one block per window).

    dm: (B, n, n) float32, contiguous, on a CUDA device; n_pts: (B,)
    integer valid-point counts (moved to dm's device, as `_phase1` does), or
    None.  Returns the same
    dict as `_phase1` (keys, shapes, dtypes and bits).  Raises for anything
    else, a CPU tensor included."""
    _check(dm, n, n_pts)
    ew_r, e_sort = sort_edges(dm, n)
    return _launch(dm, ew_r, e_sort, n_pts, n, thresh, na_max)


phase1_cuda.launches = 0
