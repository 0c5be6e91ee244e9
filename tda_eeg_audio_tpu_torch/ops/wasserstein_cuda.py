"""Hand-written CUDA kernel for the tiered H1 Sinkhorn of the comparison
stage, and its launcher.

Kernel: `csrc/sinkhorn_tiered.cu` (sm_90a).  It replaces no Pallas kernel:
the JAX package computes `_wass_sinkhorn_tiered`
(`tda_eeg_audio_tpu/models/programs.py:358`, over `ops/wasserstein.py`'s
`build_cost_matrix` and `sinkhorn_cost_stab`) as one XLA program per
128-pair chunk, pairs sorted by bar count, each chunk at the narrowest tier
width that holds it.  The port's plain version
(`models.programs.wass_sinkhorn_tiered_plain`) repeats that as a Python
loop of small ops with a host synchronisation per chunk.  On the H100 each
pair runs at its own tier width: pad rows and columns are zero-cost
pad↔pad matches whose entries in valid rows underflow to exactly 0, so the
width changes nothing but the order of summation.  A call is one bucketing
launch (each pair to its width class's list) and one persistent launch per
width class; a group of warps holds a pair's stabilised kernel matrix in
registers, tiled over its threads (`class_shape`).

What bounds it: two S × S matvecs per iteration (240 iterations) and S²
`expf` per absorption (31 passes) per pair, at the card's FP32 rate; the
bars in and one float out per pair are far below.

`models.programs._wass_sinkhorn_tiered` is the router: a CPU tensor takes
the plain version, a CUDA tensor comes here and launches the kernel or
raises — there is no fallback.  `kernel_plan` is the host side's one
decision, a pure function; the library reports its own layout at load and
the launcher raises unless it is the plan's (`check_layout`).  A second,
instrumented build (`-DSINKHORN_PROFILE`, a library of its own) serves
`sinkhorn_tiered_cuda_profiled` only.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from . import cuda_build
from .wasserstein import ABSORB, EPS_HI, EPS_LO, ITERS, STEPS, W_TIERS

__all__ = ["sinkhorn_tiered_cuda", "sinkhorn_tiered_cuda_profiled", "kernel_plan",
           "class_shape", "pair_width", "build", "check_layout", "run", "SRC",
           "SIGNATURES", "WIDTHS", "PROFILE_FLAGS", "PROFILE_SLOTS"]

SRC = Path(__file__).resolve().parent.parent / "csrc" / "sinkhorn_tiered.cu"
PROFILE_FLAGS = ("-DSINKHORN_PROFILE",)
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {"sinkhorn_tiered_launch": (
                  [P, P, P, I, P, P, P, I, I, P, I, F, I, I, P, P, I, I, P, P, P], I),
              "sinkhorn_tiered_layout": ([I, P], I)}
# the instrumented build's int64 slots per pair: clock64 ticks of the pair
# group's thread 0 per part (each part closed by a group barrier), the total
PROFILE_SLOTS = ("setup", "dm", "rebuild", "row", "col", "final", "total")
PROFILE_TICKS = PROFILE_SLOTS[:6]
MAX_WIDTH = 96               # the comparison's H1 pad width: the full tier
WIDTHS = W_TIERS + (MAX_WIDTH,)   # the kernel's width classes, bars per side
SMEM_LIMIT = 232_448         # dynamic shared memory a block may opt into
SMEM_PER_SM = 233_472        # shared memory of an SM, 1,024 B reserved a block
REGS_PER_SM = 65_536
THREADS_PER_SM = 2048
BLOCKS_PER_SM = 32
LAYOUT_FIELDS = ("threads", "smem_bytes", "blocks_per_sm", "registers",
                 "local_bytes", "occupancy")

# per class: rows × columns of Kt a thread holds, lanes along a tile row,
# warps a pair, pairs a block, blocks an SM, bytes of a Dm entry in shared
# memory (the kernel's `Shape`s; float64 where it fits, float32 at S = 192)
_TILES = {16: (8, 4, 8, 1, 2, 8, 8), 40: (8, 5, 16, 5, 1, 4, 8),
          80: (8, 10, 16, 10, 1, 1, 8), 96: (8, 12, 16, 12, 1, 1, 4)}


def pair_width(count: int) -> int:
    """The class width of a pair whose larger side holds `count` bars: the
    smallest of WIDTHS that holds them."""
    for w in WIDTHS:
        if count <= w:
            return w
    raise ValueError(f"pair_width: {count} bars exceed {MAX_WIDTH}")


def class_shape(width: int) -> dict:
    """The block of one width class, as the source's `Shape` sizes it.  S =
    2W.  Lane l of warp w of a pair's group holds the rows × cols tile of Kt
    at rows (w·A + l // lanes)·rows + [0, rows) and columns (l % lanes)·cols
    + [0, cols), A = 32 // lanes.  Shared bytes a group: f and g (S doubles
    each), Dm (S² entries of dm_bytes), the bars (4W floats), and with more
    than one warp v (S floats), the warps' column partial sums (warps × S
    floats), a 16-byte reduction slot a warp and 16 bytes for the pair
    slot.  The register cap is what `__launch_bounds__(threads,
    blocks_per_sm)` leaves a thread: each of the SM's four 16,384-register
    quarters holds a quarter of the resident warps, rounded up (a multiple
    of 8, at most 255)."""
    rows, cols, lanes, warps, pairs, bps, dm_bytes = _TILES[width]
    S = 2 * width
    group = 16 * S + dm_bytes * S * S + 16 * width + (
        4 * S + 4 * warps * S + 16 * warps + 16 if warps > 1 else 0)
    threads = 32 * warps * pairs
    warps_per_quarter = -(-threads * bps // 128)
    reg_cap = min(255, REGS_PER_SM // 4 // (32 * warps_per_quarter) // 8 * 8)
    return dict(width=width, S=S, rows=rows, cols=cols, lanes=lanes,
                tile_rows_per_warp=32 // lanes, warps_per_pair=warps,
                pairs_per_block=pairs, threads=threads, smem_bytes=pairs * group,
                blocks_per_sm=bps, reg_cap=reg_cap, dm_bytes=dm_bytes)


def kernel_plan(K: int, n_sms: int = 132) -> list:
    """Launch plan of one call over (·, K)-padded diagram pairs on a card of
    n_sms SMs: after one bucketing launch, one launch per width class that a
    pair of ≤ K bars can take, each a persistent grid of blocks_per_sm ×
    n_sms blocks, whatever the number of pairs.  Raises for a class the card
    cannot hold."""
    if not 1 <= K <= MAX_WIDTH:
        raise ValueError(f"kernel_plan: pad width {K} outside 1..{MAX_WIDTH}")
    plan = []
    for w in WIDTHS[:WIDTHS.index(pair_width(K)) + 1]:
        c = class_shape(w)
        if not (c["smem_bytes"] <= SMEM_LIMIT and c["threads"] <= 1024
                and c["blocks_per_sm"] * (c["smem_bytes"] + 1024) <= SMEM_PER_SM
                and c["blocks_per_sm"] * c["threads"] <= THREADS_PER_SM
                and c["blocks_per_sm"] <= BLOCKS_PER_SM):
            raise ValueError(f"kernel_plan: width {w} does not fit an SM: {c}")
        plan.append(dict(c, grid=c["blocks_per_sm"] * n_sms))
    return plan


def launches_per_call(K: int) -> int:
    """Kernel launches of one call at pad width K: bucketing + classes."""
    return 1 + len(kernel_plan(K))


def scratch_ints(n_pairs: int) -> int:
    """int32 scratch of a call: 4 class counts, 4 work counters, 4 lists."""
    return 8 + 4 * n_pairs


def eps_ladder() -> np.ndarray:
    """The relative ε of each rung, as `sinkhorn_cost_stab` computes it."""
    return np.array([EPS_HI * (EPS_LO / EPS_HI) ** (s / (STEPS - 1))
                     for s in range(STEPS)], np.float32)


def build() -> Path:
    """Compile the kernel (once per source content) and return the .so
    that `sinkhorn_tiered_cuda` loads."""
    return cuda_build.build(SRC)


@cuda_build.once_per_card
def check_layout(lib) -> dict:
    """The library's report of every width class against `class_shape`:
    threads, shared bytes and blocks an SM must be the plan's, the card's
    occupancy calculator must hold the plan's blocks an SM (so the
    persistent grid is resident at once), and the registers must keep
    within the plan's cap (`cuda_build.check_layout`).  Raises on any
    disagreement; returns the reports by width."""
    reports = {}
    for w in WIDTHS:
        c = class_shape(w)
        reports[w] = cuda_build.check_layout(
            lib, "sinkhorn_tiered_layout", LAYOUT_FIELDS,
            dict(c, occupancy=c["blocks_per_sm"]), ("threads", "smem_bytes", "blocks_per_sm"),
            SRC, w)
    return reports


def layout_report() -> dict:
    """`check_layout` of the library on the current card, once per card."""
    return check_layout(cuda_build.load(SRC, SIGNATURES), card=torch.cuda.current_device())


def _check(args):
    b1, d1, m1, b2, d2, m2 = args
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
    if not (1 <= b1.shape[1] <= MAX_WIDTH and 1 <= b2.shape[1] <= MAX_WIDTH):
        raise ValueError(f"sinkhorn_tiered_cuda: pad widths outside 1..{MAX_WIDTH}")


def run(lib, args, prof=None, stamps=None) -> torch.Tensor:
    """One call of `lib`'s `sinkhorn_tiered_launch` on checked inputs:
    allocates the output and scratch, launches on the current stream.
    Returns the (N,) output; raises on a launch error."""
    b1, d1, m1, b2, d2, m2 = args
    N, K1 = b1.shape
    K2 = b2.shape[1]
    dev = b1.device
    out = torch.empty(N, dtype=torch.float32, device=dev)
    if N == 0:
        return out
    scratch = torch.empty(scratch_ints(N), dtype=torch.int32, device=dev)
    ladder = eps_ladder()
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.cuda.device(dev):
        rc = lib.sinkhorn_tiered_launch(
            b1.data_ptr(), d1.data_ptr(), m1.data_ptr(), K1,
            b2.data_ptr(), d2.data_ptr(), m2.data_ptr(), K2, N,
            ladder.ctypes.data_as(ctypes.c_void_p), STEPS, EPS_LO, ITERS, ABSORB,
            out.data_ptr(), scratch.data_ptr(), pair_width(max(K1, K2)), n_sms,
            None if prof is None else prof.data_ptr(),
            None if stamps is None else stamps.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sinkhorn_tiered_launch failed: cudaError {rc}")
    return out


def sinkhorn_tiered_cuda(b1, d1, m1, b2, d2, m2) -> torch.Tensor:
    """The tiered Sinkhorn cost of N diagram pairs: b/d (N, K) float32 and
    m (N, K) bool per side, bars anywhere in the row, K ≤ 96, all
    contiguous on one CUDA device → (N,) float32 in input order.  One
    bucketing launch and one launch per width class (`kernel_plan`), no
    host synchronisation.  Raises for anything else."""
    args = (b1, d1, m1, b2, d2, m2)
    _check(args)
    if b1.shape[0] == 0:
        return torch.empty(0, dtype=torch.float32, device=b1.device)
    with torch.cuda.device(b1.device):
        layout_report()
    out = run(cuda_build.load(SRC, SIGNATURES), args)
    sinkhorn_tiered_cuda.launches += launches_per_call(max(b1.shape[1], b2.shape[1]))
    return out


def sinkhorn_tiered_cuda_profiled(b1, d1, m1, b2, d2, m2):
    """`sinkhorn_tiered_cuda` through the instrumented build: (out, prof
    (N, len(PROFILE_SLOTS)) int64, stamps (N, 3) int64: each pair's start
    and end (globaltimer, ns) and SM).  For measurement scripts; counts no
    launch."""
    args = (b1, d1, m1, b2, d2, m2)
    _check(args)
    N, dev = b1.shape[0], b1.device
    prof = torch.zeros((N, len(PROFILE_SLOTS)), dtype=torch.int64, device=dev)
    stamps = torch.zeros((N, 3), dtype=torch.int64, device=dev)
    if N == 0:
        return torch.empty(0, dtype=torch.float32, device=dev), prof, stamps
    lib = cuda_build.load(SRC, SIGNATURES, PROFILE_FLAGS)
    with torch.cuda.device(dev):
        check_layout(lib, card=torch.cuda.current_device())
    return run(lib, args, prof, stamps), prof, stamps


sinkhorn_tiered_cuda.launches = 0
