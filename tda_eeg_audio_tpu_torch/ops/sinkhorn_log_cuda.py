"""Hand-written CUDA kernel for the un-tiered log-domain H1 Sinkhorn of the
staged path and the control's exact redo, and its launcher.

Kernel: `csrc/sinkhorn_log.cu` (sm_90a).  It replaces no Pallas kernel: the
JAX package computes `sinkhorn_cost` (`tda_eeg_audio_tpu/ops/wasserstein.py:93`)
over `build_cost_matrix` as one jitted XLA program a 512-pair chunk
(`tda_eeg_audio_tpu/models/study.py::_wass_chunks`).  The port's plain
version (`ops/wasserstein.py::sinkhorn_cost_pairs` on a CPU tensor) runs 480
logsumexp half-steps, each over a materialised (chunk, S, S) tensor.  Here
one block of THREADS threads computes one pair at its own width S = n1 + n2
(its valid bars; pad rows and columns are zero-cost pad↔pad matches whose
entries in real rows underflow to exactly 0).  Each row (column) of the cost
matrix is split over `lanes(S)` lanes, each with its own online logsumexp,
merged by shuffles; the bar × bar block of the cost matrix is read from a
table in dynamic shared memory when it fits (TABLE_DOUBLES), else computed
from the bars; the duals are float64 in units of the rung's ε.

What bounds it: 481 × S² `expf` a pair at the SMs' special-function rate;
bytes are negligible.

`ops.wasserstein.sinkhorn_cost_pairs` is the router: a CPU tensor takes the
plain version, a CUDA tensor comes here and launches the kernel or raises —
there is no fallback.  `kernel_plan` is the host side's one decision; the
library reports its layout at load and the launcher raises unless it is the
plan's.
"""

from __future__ import annotations

import ctypes
import inspect
from pathlib import Path

import numpy as np
import torch

from . import cuda_build
from .wasserstein import sinkhorn_cost

__all__ = ["sinkhorn_log_cuda", "kernel_plan", "check_layout", "eps_ladder",
           "build", "SRC", "SIGNATURES", "MAX_K", "HALF_STEPS", "lanes", "table_pitch"]

SRC = Path(__file__).resolve().parent.parent / "csrc" / "sinkhorn_log.cu"
THREADS = 256             # a block a pair: L lanes a row, then a column
MAX_K = 128               # slots a side (the staged path's K_H1)
CHUNK = 8                 # a lane's entries a step of the online logsumexp
# lanes a line (row or column) at a pair's own width S: (largest S, L), the
# largest power of two with S × L ≤ THREADS
LANE_BOUNDS = ((32, 8), (64, 4), (128, 2), (2 * MAX_K, 1))
# doubles of the bar × bar cost table in dynamic shared memory; a pair whose
# n1 × P (P: the table's row stride) exceeds it computes the costs from the
# bars (csrc's TABLE)
TABLE_DOUBLES = 5632
# the ladder of `sinkhorn_cost`'s defaults, which the kernel repeats
_LADDER = {k: v.default for k, v in inspect.signature(sinkhorn_cost).parameters.items()
           if k != "D"}
EPS_HI, EPS_LO = _LADDER["eps_hi"], _LADDER["eps_lo"]
STEPS, ITERS = _LADDER["steps"], _LADDER["iters"]
HALF_STEPS = 2 * STEPS * ITERS    # logsumexp passes over the S × S entries a pair
# shared bytes a block: f and g (2 × 2·MAX_K doubles), the bars (6 × MAX_K
# doubles), 3 constant cells, a reduction slot a warp (doubles) and the two
# bar counts, static, rounded up to 16 bytes where the table, dynamic, starts
SMEM_BYTES = -(-(8 * (4 * MAX_K + 6 * MAX_K + 3 + THREADS // 32) + 8) // 16) * 16 \
    + 8 * TABLE_DOUBLES
LAYOUT_FIELDS = ("threads", "smem_bytes", "registers", "local_bytes", "occupancy")
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {"sinkhorn_log_launch": ([P, P, P, I, P, P, P, I, I, P, I, F, I, P, P], I),
              "sinkhorn_log_layout": ([P], I)}


def eps_ladder() -> np.ndarray:
    """The relative ε of each rung, as `sinkhorn_cost` computes it, rounded
    to float32 (the plain version multiplies it into a float32 scale)."""
    return np.array([EPS_HI * (EPS_LO / EPS_HI) ** (s / (STEPS - 1))
                     for s in range(STEPS)], np.float32)


def lanes(S: int) -> int:
    """L, the lanes a row (column) of a pair of own width S is split over."""
    for top, L in LANE_BOUNDS:
        if S <= top:
            return L
    raise ValueError(f"sinkhorn_log_cuda: width {S} above {2 * MAX_K}")


def table_pitch(n2: int, L: int) -> int:
    """The table's row stride at L lanes: the least P ≥ n2 whose residue mod
    16 keeps the row and the column pass free of bank conflicts (odd at L =
    1, 2 mod 4 at L = 2, 4 mod 8 at L = 4 and 8)."""
    mask, want = {1: (1, 1), 2: (3, 2)}.get(L, (7, 4))
    p = n2
    while p & mask != want:
        p += 1
    return p


def kernel_plan(n_pairs: int, K1: int, K2: int) -> dict:
    """Launch plan of one call: one block of THREADS per pair, the lanes a
    line by each pair's own width S (`lane_bounds`: S ≤ 32 → 8, ≤ 64 → 4,
    ≤ 128 → 2, else 1; chosen in the kernel), the entries a lane walks at
    the widest pair the pads allow.  Raises for a pad width the kernel does
    not take (1 ≤ K ≤ MAX_K a side)."""
    if not (1 <= K1 <= MAX_K and 1 <= K2 <= MAX_K):
        raise ValueError(f"sinkhorn_log_cuda: pad widths ({K1}, {K2}) outside 1..{MAX_K}")
    S = K1 + K2
    return dict(threads=THREADS, smem_bytes=SMEM_BYTES, grid=n_pairs,
                max_rows_per_thread=-(-S // THREADS), chunk=CHUNK,
                lane_bounds=LANE_BOUNDS, table_doubles=TABLE_DOUBLES,
                max_entries_per_lane=-(-S // lanes(S)))


def build() -> Path:
    """Compile the kernel (once per source content) and return the .so
    that `sinkhorn_log_cuda` loads."""
    return cuda_build.build(SRC)


@cuda_build.once_per_card
def check_layout(lib) -> dict:
    """The library's report (`LAYOUT_FIELDS`) against the plan: threads and
    shared bytes must be the plan's, within the card's limits
    (`cuda_build.check_layout`).  Raises on any disagreement."""
    return cuda_build.check_layout(lib, "sinkhorn_log_layout", LAYOUT_FIELDS,
                                   kernel_plan(1, 1, 1), ("threads", "smem_bytes"), SRC)


def layout_report() -> dict:
    """`check_layout` of the library on the current card, once per card."""
    return check_layout(cuda_build.load(SRC, SIGNATURES), card=torch.cuda.current_device())


def _check(args):
    b1, d1, m1, b2, d2, m2 = args
    dev = b1.device
    if dev.type != "cuda" or any(x.device != dev for x in args):
        raise ValueError(f"sinkhorn_log_cuda: inputs must be on one CUDA "
                         f"device, not {[str(x.device) for x in args]}")
    if any(x.dtype != torch.float32 for x in (b1, d1, b2, d2)) or \
            m1.dtype != torch.bool or m2.dtype != torch.bool:
        raise ValueError("sinkhorn_log_cuda: bars float32, masks bool")
    if any(x.dim() != 2 for x in args) or len({x.shape for x in args[:3]}) != 1 \
            or len({x.shape for x in args[3:]}) != 1 or b1.shape[0] != b2.shape[0]:
        raise ValueError("sinkhorn_log_cuda: (N, K1) and (N, K2) per side")
    if not all(x.is_contiguous() for x in args):
        raise ValueError("sinkhorn_log_cuda: inputs must be contiguous")


def sinkhorn_log_cuda(b1, d1, m1, b2, d2, m2) -> torch.Tensor:
    """`sinkhorn_cost(build_cost_matrix(...))` of N diagram pairs: b/d (N, K)
    float32 and m (N, K) bool per side, bars anywhere in the row, 1 ≤ K ≤
    MAX_K, all contiguous on one CUDA device → (N,) float32.  One launch, a
    block a pair, no host synchronisation.  Raises for anything else."""
    args = (b1, d1, m1, b2, d2, m2)
    _check(args)
    N, K1 = b1.shape
    K2 = b2.shape[1]
    kernel_plan(N, K1, K2)
    dev = b1.device
    out = torch.empty(N, dtype=torch.float32, device=dev)
    if N == 0:
        return out
    ladder = eps_ladder()
    with torch.cuda.device(dev):
        layout_report()
        rc = cuda_build.load(SRC, SIGNATURES).sinkhorn_log_launch(
            b1.data_ptr(), d1.data_ptr(), m1.data_ptr(), K1,
            b2.data_ptr(), d2.data_ptr(), m2.data_ptr(), K2, N,
            ladder.ctypes.data_as(ctypes.c_void_p), STEPS, EPS_LO, ITERS,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sinkhorn_log_launch failed: cudaError {rc}")
    sinkhorn_log_cuda.launches += 1
    return out


sinkhorn_log_cuda.launches = 0
