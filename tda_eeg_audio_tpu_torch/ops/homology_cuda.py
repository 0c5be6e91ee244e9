"""Hand-written CUDA kernel for the H1 cohomology reduction, and its wrapper.

Kernel: `csrc/h1_reduce.cu` (sm_90a), the counterpart of the reference's
Pallas TPU kernel `tda_eeg_audio_tpu/ops/homology_pallas.py::_reduce_kernel`
(launched by `h1_diagrams_pallas`).  One launch reduces all windows of a
call: persistent blocks take windows from a device counter, each block
keeping one window's operands, working column and column summary in shared
memory and its finished columns as compact (word index, word) lists in its
slot of a global arena allocated here.

What bounds it on an H100: each reduction step is a dependent chain (pivot
→ apparent/claim lookup → XOR), so a window's time is its step count times
the step latency — not bytes, not arithmetic.  The design answers with many
independent windows in flight and a step whose every link is a
shared-memory access; the source's header has the details.

Every host-side decision is a pure function that runs without CUDA:
`kernel_shape`, `kernel_plan`, `phase1_chunk`.

Phase 1 (edge ranks, forest/H0, apparent sieve, creator list) is a kernel
of its own, `csrc/h1_phase1.cu` via `phase1_cuda`; bar extraction stays in
PyTorch (`homology_h1`).  The plain PyTorch phase 1 and reduction
(`homology_h1._phase1`, `homology_h1.reduce_plain`) are the same functions:
`h1_diagrams_cuda` takes them for a tensor on the CPU, and launches both
kernels (or raises) for a CUDA tensor — there is no fallback.

The kernel is compiled by `nvcc` at first use from the source in the
checkout and bound to `SIGNATURES` by `cuda_build.load`.  A second,
instrumented build of the same source (`-DH1_PROFILE`, a library of its
own) serves `reduce_cuda_profiled` only; no entry point of the port loads
it.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from . import cuda_build
from .homology_h1 import (_extract_bars, h1_diagrams_plain, map_window_chunks,
                          reduction_inputs)
from .phase1_cuda import phase1_cuda

__all__ = ["h1_diagrams_cuda", "h1_diagrams_plain", "reduce_cuda",
           "reduce_cuda_profiled", "build", "kernel_shape", "check_layout",
           "kernel_plan", "phase1_chunk", "PROFILE_SLOTS"]

SRC = Path(__file__).resolve().parent.parent / "csrc" / "h1_reduce.cu"
PROFILE_FLAGS = ("-DH1_PROFILE",)
P, I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"h1_reduce_launch": ([P] * 12 + [I] * 8 + [P], I),
              "h1_reduce_layout": ([I, I, I, P], I)}
LAYOUT_FIELDS = ("threads", "smem_bytes", "registers", "local_bytes", "occupancy")
ARENA_BYTES = 1 << 32       # stored-column arena of one launch, at most
PHASE1_BYTES = 1 << 34      # phase 1's transient tensors of one chunk, at most
SMEM_MAX = 232_448          # dynamic shared memory a block can have (sm_90)
MAX_NA = 128
MAX_N = 128
# the instrumented build's int64 slots per window: clock64 ticks of thread 0
# per part of the step, then counters
PROFILE_SLOTS = ("setup", "pivot", "pivot_barrier", "claim", "cobd_xor",
                 "stored_xor", "finish", "step_barrier", "total", "steps_app",
                 "steps_stored", "steps_finish", "xor_words", "store_words",
                 "extent_words", "nnz_words", "prepare", "finish_scan",
                 "finish_move", "finish_barrier")
PROFILE_TICKS = PROFILE_SLOTS[:8] + PROFILE_SLOTS[16:]


def _up16(x: int) -> int:
    return (x + 15) & ~15


def kernel_shape(n: int) -> dict:
    """Block shape for n-point windows: threads per window (one window per
    block at a time), the column's padded word count W (a multiple of 32, so
    that every summary word covers whole column words) and the dynamic
    shared-memory bytes (the layout of `csrc/h1_reduce.cu::layout`).

    n ≤ 64 takes 64-thread blocks, so that an SM holds a dozen windows;
    larger clouds fill most of an SM's shared memory with one column and
    take 256 threads for the per-window operand load."""
    if not 2 <= n <= MAX_N:
        raise ValueError(f"kernel_shape: n={n} outside 2..{MAX_N}")
    threads = 64 if n <= 64 else 256
    m = n * (n - 1) // 2
    W = -(-(m * n) // 1024) * 32
    smem = (W * 4 + _up16(W // 32 * 4) + 128 + _up16(n * n * 2) + 3 * _up16(m)
            + 4 * MAX_NA * 4 + 16)
    if smem > SMEM_MAX:
        raise ValueError(f"kernel_shape: n={n} needs {smem} B of shared memory")
    return dict(threads=threads, W=W, smem_bytes=smem)


def kernel_plan(n: int, na: int, n_windows: int, resident_blocks: int,
                n_sms: int = 132) -> dict:
    """Launch plan of one call: `kernel_shape` plus the grid and the arena.

    resident_blocks: blocks of this shape one SM holds (the occupancy the
    kernel's library reports).  The grid is the number of blocks resident at
    once, capped by the windows and by the arena's bound; each block owns a
    slot of na × W (index, word) entries, the most its columns can hold."""
    if not 1 <= na <= MAX_NA:
        raise ValueError(f"kernel_plan: na={na} outside 1..{MAX_NA}")
    plan = kernel_shape(n)
    slot_bytes = na * plan["W"] * 8
    grid = max(1, min(n_windows, resident_blocks * n_sms,
                      ARENA_BYTES // slot_bytes))
    plan.update(grid=grid, slot_bytes=slot_bytes, arena_bytes=grid * slot_bytes)
    return plan


def phase1_chunk(n: int) -> int:
    """Windows per phase-1 call: the plain `_phase1`'s largest transients
    are the apparent sieve's (B, m, n) tensors (an int32 gather, bool
    comparisons, the int32 first-vertex select): 8 bytes per (edge, vertex)
    reckoned, 6.5 measured at n = 124 (`tools/h1_kernel_profile.py`).  The
    kernel's transients are far smaller; the chunk still holds a whole
    study batch, one launch of each kernel per stage."""
    m = n * (n - 1) // 2
    return max(1, PHASE1_BYTES // (8 * m * n))


def build() -> Path:
    """Compile the kernel (once per source content) and return the .so
    that `reduce_cuda` loads."""
    return cuda_build.build(SRC)


@cuda_build.once_per_card
def check_layout(lib, n: int) -> dict:
    """What `lib` reports of the kernel for n-point windows against
    `kernel_shape(n)`: threads and shared bytes must be the plan's and an
    SM must hold a block (`cuda_build.check_layout`).  Raises on any
    disagreement."""
    shape = kernel_shape(n)
    return cuda_build.check_layout(lib, "h1_reduce_layout", LAYOUT_FIELDS, shape,
                                   ("threads", "smem_bytes"), SRC, n, shape["W"],
                                   shape["threads"])


def blocks_per_sm(n: int, lib=None) -> int:
    """Blocks of `kernel_shape(n)` one SM of the current card holds: the
    occupancy `lib` (default: the main build) reports, checked once per
    card."""
    lib = lib or cuda_build.load(SRC, SIGNATURES)
    return check_layout(lib, n, card=torch.cuda.current_device())["occupancy"]


def _reduce(ins, n: int, step_budget: int, flags=()):
    rank_mat, iu_r, ju_r, app_v, na_list, m_cx = ins
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
    pair = torch.empty((B, na), dtype=torch.int32, device=dev)
    stepinfo = torch.empty((B, 2), dtype=torch.int32, device=dev)
    profile = bool(flags)
    prof = stamps = None
    if profile:
        prof = torch.zeros((B, len(PROFILE_SLOTS)), dtype=torch.int64, device=dev)
        stamps = torch.zeros((B, 3), dtype=torch.int64, device=dev)
    if B > 0:
        lib = cuda_build.load(SRC, SIGNATURES, flags)
        with torch.cuda.device(dev):
            plan = kernel_plan(
                n, na, B, blocks_per_sm(n, lib),
                torch.cuda.get_device_properties(dev).multi_processor_count)
            counter = torch.zeros(1, dtype=torch.int32, device=dev)
            arena = torch.empty(plan["arena_bytes"] // 8, dtype=torch.int64,
                                device=dev)
            rc = lib.h1_reduce_launch(
                *(t.data_ptr() for t in ins), counter.data_ptr(), arena.data_ptr(), pair.data_ptr(),
                stepinfo.data_ptr(), prof.data_ptr() if profile else None,
                stamps.data_ptr() if profile else None, B, n, m, na, plan["W"],
                step_budget, plan["threads"], plan["grid"],
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"h1_reduce_launch failed: cudaError {rc}")
        if not profile:
            h1_diagrams_cuda.launches += 1
    return pair, stepinfo[:, 0], stepinfo[:, 1].bool(), prof, stamps


def reduce_cuda(rank_mat, iu_r, ju_r, app_v, na_list, m_cx, n: int,
                step_budget: int):
    """One launch of the kernel on the reduction operands of
    `reduction_inputs`.

    Same contract as `homology_h1.reduce_plain`: returns (pair_key (B, na)
    int32, steps (B,) int32, overflow (B,) bool)."""
    return _reduce((rank_mat, iu_r, ju_r, app_v, na_list, m_cx), n, step_budget)[:3]


def reduce_cuda_profiled(rank_mat, iu_r, ju_r, app_v, na_list, m_cx, n: int,
                         step_budget: int):
    """`reduce_cuda` through the instrumented build: also returns prof
    (B, len(PROFILE_SLOTS)) int64 and stamps (B, 3) int64 = each window's
    start and end (globaltimer, ns) and the SM it ran on.  For measurement
    scripts; counts no launch."""
    return _reduce((rank_mat, iu_r, ju_r, app_v, na_list, m_cx), n, step_budget,
                   PROFILE_FLAGS)


def h1_diagrams_cuda(dm: torch.Tensor, n_pts=None, *, n: int, thresh: float,
                     na_max: int = 96, h1_max: int = 96, step_budget: int = 8192):
    """Batched exact H1 diagrams; phase 1 and the reduction run in CUDA
    kernels.

    Same arguments and return contract as `homology_h1.h1_diagrams_plain`.
    A CPU tensor takes the plain PyTorch phase 1 and reduction; a CUDA
    tensor launches the phase-1 kernel and the reduction kernel once each
    per `phase1_chunk(n)` windows (`diagrams_on_card`)."""
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

    run = functools.partial(diagrams_on_card, n=n, thresh=thresh, na_max=na_max,
                            h1_max=h1_max, step_budget=step_budget)
    return map_window_chunks(run, dm, n_pts, phase1_chunk(n))


def diagrams_on_card(dm, n_pts, *, n: int, thresh: float, na_max: int,
                     h1_max: int, step_budget: int):
    """One chunk of `h1_diagrams_cuda` on the card: the phase-1 kernel, the
    reduction kernel, the bar extraction."""
    ph = phase1_cuda(dm.contiguous(), n, thresh, na_max, n_pts)
    pair, steps, ovf = reduce_cuda(*reduction_inputs(ph), n=n,
                                   step_budget=step_budget)
    return _extract_bars(pair, steps, ovf, ph, n, h1_max)


h1_diagrams_cuda.launches = 0
