"""Hand-written CUDA kernel for H1 phase 1 (the stable edge sort, edge ranks,
spanning forest and H0 deaths, apparent-pair sieve, creator list), and its
launcher.

Kernel: `csrc/h1_phase1.cu` (sm_90a).  It replaces no Pallas kernel: the
JAX package computes `_phase1` (`tda_eeg_audio_tpu/ops/homology_h1.py:181`,
with its stable sort `_sort_with_payload` at `:64` and `_boruvka_forest` at
`:122`) as XLA ops in front of the Pallas body of `h1_diagrams_pallas`.
The port's plain version is `homology_h1._phase1`, whose apparent-pair
sieve materialises (B, m, n) gathers; the kernel reads dm once, sorts a
window's edges by the key (canonical weight bits, i << 7 | j) in shared
memory, keeps the rank matrix there as uint16 and scans each edge's
vertices until the first hit, one block per window.  It returns
`_phase1`'s dict bit for bit, in the edge order of the CPU's
`torch.sort(stable=True)` and of JAX's `lax.sort`.

`phase1_cuda` is one launch per call, with no PyTorch kernel in front of it.
`homology_cuda.h1_diagrams_cuda` calls it for every CUDA tensor; a CPU tensor
never reaches it (the plain path runs `_phase1`), and a CUDA tensor launches
the kernel or raises — there is no fallback.  `kernel_plan` is the host
side's one decision, a pure function; the library reports its own layout at
load (`check_layout`).  A second, instrumented build (`-DH1_PHASE1_PROFILE`,
a library of its own) serves `phase1_cuda_profiled` only.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from . import cuda_build

__all__ = ["phase1_cuda", "phase1_cuda_profiled", "kernel_plan", "sieve_compares",
           "build", "check_layout", "run", "SRC", "SIGNATURES", "PROFILE_FLAGS",
           "PROFILE_SLOTS"]

SRC = Path(__file__).resolve().parent.parent / "csrc" / "h1_phase1.cu"
PROFILE_FLAGS = ("-DH1_PHASE1_PROFILE",)
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {"h1_phase1_launch": ([P, P] + [I] * 3 + [F] + [I] * 3 + [P] * 15, I),
              "h1_phase1_layout": ([I, I, P], I)}
LAYOUT_FIELDS = ("threads", "smem_bytes", "registers", "local_bytes", "occupancy")
# the instrumented build's int64 slots per window: clock64 ticks of thread 0
# per part (each part closed by a barrier), the total, then counters
PROFILE_SLOTS = ("sort", "ranks", "radius", "write", "forest", "sieve", "h0",
                 "creators", "total", "forest_rounds")
PROFILE_TICKS = PROFILE_SLOTS[:8]
SMEM_MAX = 232_448          # dynamic shared memory a block can have (sm_90)
MAX_N = 128                 # ranks fit uint16 and vertices uint8
MAX_NA = 128
MAX_WARPS = 32
SEG = 16                    # sort keys a thread holds in registers


def _up16(x: int) -> int:
    return (x + 15) & ~15


def row_stride(n: int) -> int:
    """The shared rank matrix's row stride in ranks: a multiple of 8 (16
    bytes, the sieve's read) with an odd number of 16-byte words."""
    s = (n + 7) & ~7
    return s if s & 8 else s + 8


def kernel_plan(n: int, na_max: int) -> dict:
    """Block shape for n-point windows: threads (at least one per vertex
    and one per 16 edges, the sort's segments; a multiple of 32), the
    dynamic shared-memory bytes (the layout of `csrc/h1_phase1.cu::layout`:
    the uint64 sort keys, one spare per 16, overlaid once sorted by the
    uint16 rank matrix (rows `row_stride(n)` apart) and the uint8 edge
    flags; the uint16 (i << 7 | j) of each edge by rank; the forest's uint8
    roots and four int arrays of it and its tree edges; the scan's
    scratch), the edge count m
    and the creator list's width na_eff = min(na_max, m), as `_phase1`
    slices it."""
    if not 2 <= n <= MAX_N:
        raise ValueError(f"kernel_plan: n={n} outside 2..{MAX_N}")
    if not 1 <= na_max <= MAX_NA:
        raise ValueError(f"kernel_plan: na_max={na_max} outside 1..{MAX_NA}")
    m = n * (n - 1) // 2
    padded = m + m // 16
    threads = 128 if n <= 64 else 512
    rank_bytes = _up16(2 * n * row_stride(n))
    smem = (max(_up16(8 * padded), rank_bytes + _up16(m)) + _up16(2 * m)
            + _up16(row_stride(n)) + 4 * _up16(4 * n) + _up16(4 * (2 * MAX_WARPS + 4)))
    if smem > SMEM_MAX:
        raise ValueError(f"kernel_plan: n={n} needs {smem} B of shared memory")
    return dict(threads=threads, smem_bytes=smem, m=m, na_eff=min(na_max, m))


def sieve_compares(vstar_r: torch.Tensor, n: int) -> torch.Tensor:
    """The int32 compares the apparent-pair sieve needs per window: two per
    (edge, v) scanned, an edge scanning v = 0 .. vstar (its first hit) or
    all n vertices when it has none.  vstar_r (B, m) → (B,) int64."""
    v = vstar_r.long()
    return 2 * torch.where(v >= 0, v + 1, n).sum(dim=-1)


def build() -> Path:
    """Compile the kernel (once per source content) and return the .so
    that `phase1_cuda` loads."""
    return cuda_build.build(SRC)


@cuda_build.once_per_card
def check_layout(lib, n: int) -> dict:
    """What `lib` reports of the kernel for n-point windows against
    `kernel_plan(n, ·)`: threads and shared bytes must be the plan's and an
    SM must hold a block (`cuda_build.check_layout`).  Raises on any
    disagreement."""
    plan = kernel_plan(n, 1)
    return cuda_build.check_layout(lib, "h1_phase1_layout", LAYOUT_FIELDS, plan,
                                   ("threads", "smem_bytes"), SRC, n, plan["threads"])


def blocks_per_sm(n: int, lib=None) -> int:
    """Blocks of `kernel_plan(n, ·)`'s shape one SM of the current card
    holds: the occupancy `lib` (default: the main build) reports, checked
    once per card."""
    lib = lib or cuda_build.load(SRC, SIGNATURES)
    return check_layout(lib, n, card=torch.cuda.current_device())["occupancy"]


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


def run(lib, dm, n_pts, n: int, thresh: float, na_max: int,
        profile: bool = False) -> dict:
    """One launch of `lib`'s kernel on checked inputs; the dict of
    `_phase1` (with profile=True, for an instrumented build, also `prof`
    (B, len(PROFILE_SLOTS)) and `stamps` (B, 3) int64: each window's start
    and end (globaltimer, ns) and SM)."""
    plan = kernel_plan(n, na_max)
    B, m, na_eff = dm.shape[0], plan["m"], plan["na_eff"]
    dev = dm.device

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = dict(m=m, m_cx=empty(B), ew_r=empty(B, m, dtype=torch.float32),
               rank_mat=empty(B, n, n), iu_r=empty(B, m), ju_r=empty(B, m),
               vstar_r=empty(B, m), apparent_r=empty(B, m, dtype=torch.bool),
               na_list=empty(B, na_eff), overflow_na=empty(B, dtype=torch.bool),
               h0_deaths=empty(B, n - 1, dtype=torch.float32),
               h0_mask=empty(B, n - 1, dtype=torch.bool), n_tree=empty(B))
    if profile:
        out["prof"] = torch.zeros((B, len(PROFILE_SLOTS)), dtype=torch.int64, device=dev)
        out["stamps"] = torch.zeros((B, 3), dtype=torch.int64, device=dev)
    if B == 0:
        return out
    # the kernel reads int32 or int64 counts and clamps them to 0..n itself
    if n_pts is not None and (n_pts.device != dev or not n_pts.is_contiguous()
                              or n_pts.dtype not in (torch.int32, torch.int64)):
        n_pts = n_pts.to(device=dev, dtype=torch.int64).contiguous()
    with torch.cuda.device(dev):
        blocks_per_sm(n, lib)
        rc = lib.h1_phase1_launch(
            dm.data_ptr(), None if n_pts is None else n_pts.data_ptr(),
            int(n_pts is not None and n_pts.dtype == torch.int64), B, n, thresh,
            na_eff, na_max, plan["threads"],
            *(out[k].data_ptr() for k in ("ew_r", "rank_mat", "iu_r", "ju_r",
                                          "vstar_r", "apparent_r", "na_list",
                                          "overflow_na", "h0_deaths", "h0_mask",
                                          "n_tree", "m_cx")),
            *((out["prof"].data_ptr(), out["stamps"].data_ptr()) if profile
              else (None, None)),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"h1_phase1_launch failed: cudaError {rc}")
    return out


def phase1_cuda(dm: torch.Tensor, n: int, thresh: float, na_max: int,
                n_pts=None) -> dict:
    """`homology_h1._phase1` on the card: one launch of the kernel (one
    block per window), nothing in front of it.

    dm: (B, n, n) float32, contiguous, on a CUDA device; n_pts: (B,)
    integer valid-point counts (int32 or int64 on dm's device are read as
    they are; others are moved there first), or None.  Returns the same
    dict as `_phase1` (keys, shapes, dtypes and bits).  Raises for anything
    else, a CPU tensor included."""
    _check(dm, n, n_pts)
    out = run(cuda_build.load(SRC, SIGNATURES), dm, n_pts, n, thresh, na_max)
    if dm.shape[0]:
        phase1_cuda.launches += 1
    return out


def phase1_cuda_profiled(dm: torch.Tensor, n: int, thresh: float, na_max: int,
                         n_pts=None) -> dict:
    """`phase1_cuda` through the instrumented build: the same dict plus
    `prof` and `stamps` (see `run`).  For measurement scripts; counts no
    launch."""
    _check(dm, n, n_pts)
    return run(cuda_build.load(SRC, SIGNATURES, PROFILE_FLAGS), dm, n_pts, n, thresh,
               na_max, profile=True)


phase1_cuda.launches = 0
