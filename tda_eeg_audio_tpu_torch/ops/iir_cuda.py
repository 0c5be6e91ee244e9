"""Hand-written CUDA kernel for the exact Butterworth filtfilt bank, and its
launcher.

Kernel: `csrc/sosfiltfilt.cu` (sm_90a).  It replaces no Pallas kernel: the
JAX package computes `bandpass_bank_iir_scan` (`filter_impl="iir_scan"`) as
XLA associative scans over one 2×2 affine pair a sample
(`tda_eeg_audio_tpu/ops/signal.py::_biquad_scan` under
`sosfiltfilt_scan` / `sosfiltfilt_scan_masked`), log-depth because a
sequential recurrence is hostile to a TPU.  The kernel takes that algebra at
the grain of a chunk: one block per (series, band) chain holds the chain's
odd extension (built from x and n in the kernel) in shared memory as
float64, each thread owns a chunk of C samples, and for each section in
turn, forward and then backward: (a) every thread runs its chunk from zero
state, (b) the block carries the true states across the chunks with the
powers A^(C·m) of the section's state matrix (a scan in each warp, then
across warps), (c) every thread reruns its chunk from its true start,
writes the output over the input and feeds it straight into (a) of the
next section.  Only x is read and the bands written, in `bandpass_bank`'s
layout (..., nb, T), zero beyond n.

Accuracy: float64 state keeps the port within ~1e-7 of scipy's float64
`sosfiltfilt` (relative to the band's largest value), where the JAX
package's float32 scan is off by up to ~5e-3 in the delta band; the port
and the JAX package therefore differ by about the JAX package's own error.
The carry reassociates the recurrence's sums, ~4e-13 of the band's range
(`tests/test_torch_iir.py` models it on the CPU).

What bounds it on an H100: the FP64 rate and shared memory, nearly alike.
The function needs 9 FP64 operations per section and sample; the
zero-state run and the rerun issue 10 instructions, and the in-place rerun
loads and stores each sample once a section.  The earlier design
(d702a88), one thread per chain with a float64 scratch in device memory,
ran a batch at about one chain's latency (two dependent FP64 FMAs a sample
over ~11,700 samples); here a chain has a block of threads and 4 blocks
share an SM at T_pad 5800.
A chain too long for a block's shared memory keeps its buffer in device
memory (`staging` "device"), the same kernel.

`signal.bandpass_bank_iir_scan` is the router: a CPU tensor takes the plain
recurrence (`signal.bandpass_bank_iir_plain`, the specification), a CUDA
tensor comes here and launches the kernel or raises — there is no fallback.
`kernel_plan` and `chunk_operators` are the host side's decisions, pure
functions; the library reports what it makes of a plan, checked once per
card and plan (`check_layout`).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from . import cuda_build

__all__ = ["sosfiltfilt_bank_cuda", "kernel_plan", "chunk_operators",
           "check_layout", "build", "SRC", "SIGNATURES"]

SRC = Path(__file__).resolve().parent.parent / "csrc" / "sosfiltfilt.cu"
P, I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"sosfiltfilt_launch": ([P] * 7 + [I] * 9 + [P], I),
              "sosfiltfilt_layout": ([I, I, I, I, P], I)}
# what the library makes of a plan: blocks an SM (occupancy calculator),
# registers and spill bytes a thread, static shared bytes, the kernel's
# thread limit
LAYOUT_FIELDS = ("occupancy", "registers", "local_bytes", "static_smem_bytes",
                 "max_threads")
THREADS = 256       # chunks (threads) a chain: C ≈ 23 samples at T_pad 5800
THREAD_CHOICES = (32, 64, 128, 256, 512, 1024)
MAX_SECTIONS = 8    # the kernel's instantiations: S = 1 … 8 sections
POW_M = 32          # A^(C·m), m = 1 … 32, per band and section
# an H100's shared memory: 227 KB a block, 228 KB an SM, 1 KB of it reserved
# per resident block; the kernel's static part is its carry's double buffer
SMEM_BLOCK = 232_448
SMEM_SM = 233_472
SMEM_RESERVED = 1_024
STATIC_SMEM = 2 * 32 * 2 * 8
MAX_THREADS_SM = 2_048
MAX_BLOCKS_SM = 32

_consts = {}


def kernel_plan(n_series: int, n_bands: int, T: int, edge: int,
                n_sections: int, threads: int = THREADS) -> dict:
    """Launch plan of one call: one block of `threads` per (series, band)
    chain; chunks of C samples, one a thread, C odd (a warp's 8-byte
    shared-memory accesses at stride C hit distinct bank pairs) and
    C·threads ≥ the longest extension text = T + 2·edge; the chain's
    float64 buffer in dynamic shared memory when it fits a block's beside
    the carry's static part, else in device memory (`staging` "device",
    scratch of text doubles a chain).  blocks_per_sm is what shared memory
    and threads allow (the library reports the occupancy calculator's,
    registers included)."""
    if not 1 <= n_sections <= MAX_SECTIONS:
        raise ValueError(f"kernel_plan: {n_sections} sections outside "
                         f"1..{MAX_SECTIONS}")
    if edge < 1 or T < 0:
        raise ValueError(f"kernel_plan: edge={edge}, T={T}")
    if threads not in THREAD_CHOICES:
        raise ValueError(f"kernel_plan: threads {threads} not in {THREAD_CHOICES}")
    chains = n_series * n_bands
    text = T + 2 * edge
    chunk = -(-text // threads) | 1
    staged = text * 8 + STATIC_SMEM > SMEM_BLOCK
    shared = 0 if staged else text * 8
    blocks = min(MAX_THREADS_SM // threads, MAX_BLOCKS_SM,
                 SMEM_SM // (shared + STATIC_SMEM + SMEM_RESERVED))
    return dict(threads=threads, chunk=chunk, chunks=-(-text // chunk),
                chains=chains, grid=chains, text=text, shared_bytes=shared,
                blocks_per_sm=blocks, staging="device" if staged else "shared",
                scratch_bytes=text * chains * 8 if staged else 0)


def chunk_operators(sos_bank, chunk: int) -> np.ndarray:
    """The carry's operators: (nb, S, POW_M, 2, 2) float64, entry m − 1 the
    power A^(chunk·m) of each section's state matrix A = [[−a1, 1], [−a2, 0]]
    (z' = A z + B u for the state (z1, z2) of direct form II transposed).
    Each power is taken by repeated squaring in extended precision
    (np.longdouble) and rounded once: float64 squarings would put the
    delta band's carry ~1e-11 of its range off the recurrence, against
    ~4e-13 so (`tests/test_torch_iir.py`)."""
    if chunk < 1:
        raise ValueError(f"chunk_operators: chunk {chunk}")
    sos = np.asarray(sos_bank, np.float64).astype(np.longdouble)
    A = np.zeros((*sos.shape[:-1], 2, 2), np.longdouble)
    A[..., 0, 0] = -sos[..., 4]
    A[..., 0, 1] = 1.0
    A[..., 1, 0] = -sos[..., 5]

    def power(k):
        out = np.broadcast_to(np.eye(2, dtype=np.longdouble), A.shape).copy()
        sq = A.copy()
        while k:
            if k & 1:
                out = out @ sq
            sq = sq @ sq
            k >>= 1
        return out

    return np.stack([power(chunk * m) for m in range(1, POW_M + 1)],
                    axis=-3).astype(np.float64)


def build() -> Path:
    """Compile the kernel (once per source content) and return the .so
    that `sosfiltfilt_bank_cuda` loads."""
    return cuda_build.build(SRC)


def _constants(sos: np.ndarray, zi: np.ndarray, chunk: int, dev) -> tuple:
    """The coefficients, initial conditions and carry operators on the card,
    kept per (bank, chunk, device): a host-to-device copy would wait for
    the stream's earlier work at every call."""
    key = (sos.tobytes(), zi.tobytes(), chunk, str(dev))
    if key not in _consts:
        _consts[key] = tuple(torch.as_tensor(a, device=dev) for a in
                             (sos, zi, chunk_operators(sos, chunk)))
    return _consts[key]


@cuda_build.once_per_card
def check_layout(lib, n_sections: int, threads: int, shared_bytes: int,
                 staged: bool) -> dict:
    """What `lib` makes of a plan's block (`kernel_plan`'s threads,
    shared_bytes and staging "device") at n_sections sections
    (`LAYOUT_FIELDS`): an SM must hold a block within its registers
    (`cuda_build.check_layout`).  Raises otherwise; returns the report."""
    return cuda_build.check_layout(lib, "sosfiltfilt_layout", LAYOUT_FIELDS,
                                   dict(threads=threads), (), SRC, n_sections, threads,
                                   shared_bytes, int(staged))


def sosfiltfilt_bank_cuda(x: torch.Tensor, n, sos_bank, zi_bank,
                          edge: int, threads: int = THREADS,
                          lib=None) -> torch.Tensor:
    """One launch of the kernel: x (..., T) float32 on a CUDA device, valid
    to n (broadcastable to x.shape[:-1], clamped to [0, T] by the kernel) →
    (..., nb, T) float32, band b filtered by sos_bank[b] (nb, S, 6) with
    initial conditions zi_bank[b] (nb, S, 2), odd extension of `edge`
    samples (`signal.sos_edge`).  `threads` picks the plan's chunk length
    (`kernel_plan`); `lib` another build of the same interface.  Raises for
    anything but a CUDA tensor."""
    if not x.is_cuda:
        raise ValueError(f"sosfiltfilt_bank_cuda: x must be on a CUDA device, "
                         f"not {x.device}")
    if x.dtype != torch.float32:
        raise ValueError("sosfiltfilt_bank_cuda: x must be float32")
    sos = np.asarray(sos_bank, np.float64)
    zi = np.asarray(zi_bank, np.float64)
    if sos.ndim != 3 or sos.shape[2] != 6 or zi.shape != (*sos.shape[:2], 2):
        raise ValueError("sosfiltfilt_bank_cuda: sos_bank (nb, S, 6) and "
                         "zi_bank (nb, S, 2)")
    dev = x.device
    x = x.contiguous()
    lead, T = x.shape[:-1], x.shape[-1]
    n_series = int(np.prod(lead))
    nb, S = sos.shape[:2]
    plan = kernel_plan(n_series, nb, T, edge, S, threads)
    nlen = torch.as_tensor(n, device=dev).to(torch.int32).expand(lead).contiguous()
    out = torch.empty((*lead, nb, T), dtype=torch.float32, device=dev)
    if plan["chains"] == 0 or T == 0:
        return out
    sos_t, zi_t, pw = _constants(sos, zi, plan["chunk"], dev)
    scratch = (torch.empty(plan["scratch_bytes"] // 8, dtype=torch.float64, device=dev)
               if plan["scratch_bytes"] else None)
    lib = lib or cuda_build.load(SRC, SIGNATURES)
    with torch.cuda.device(dev):
        check_layout(lib, S, plan["threads"], plan["shared_bytes"],
                     plan["staging"] == "device", card=torch.cuda.current_device())
        rc = lib.sosfiltfilt_launch(
            x.data_ptr(), nlen.data_ptr(), sos_t.data_ptr(), zi_t.data_ptr(),
            pw.data_ptr(), scratch.data_ptr() if scratch is not None else None,
            out.data_ptr(), n_series, nb, S, T, edge, plan["chunk"],
            plan["threads"], plan["shared_bytes"], int(plan["staging"] == "device"),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sosfiltfilt_launch failed: cudaError {rc}")
    sosfiltfilt_bank_cuda.launches += 1
    return out


sosfiltfilt_bank_cuda.launches = 0
