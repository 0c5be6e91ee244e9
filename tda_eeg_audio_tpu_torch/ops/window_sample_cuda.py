"""Hand-written CUDA kernel for the features stage's md5-seeded window
sample, and its launcher.

Kernel: `csrc/window_sample.cu` (sm_90a).  It replaces no Pallas kernel:
the JAX package draws the sample on the host
(`tda_eeg_audio_tpu/models/classify.py:48` `window_sample_indices`), one
NumPy generator a (recording, band) lane, as the port's CPU path does
(`io/synthetic.window_sample_indices`, the specification).  Seeding 7,200
generators is ~0.3 s of host time a study while the card waits.  Here one
thread draws one lane, the whole chain in registers: MD5 of the lane's
message, NumPy's SeedSequence, PCG64, the buffered 32-bit halves, Lemire's
bounded draws, Floyd's algorithm over a bitmap of nw bits in shared memory
and the Fisher-Yates shuffle, bit for bit `default_rng(seed).choice(nw,
min(K, nw), replace=False)`; the bank's paired comparison columns in the
host's float32 arithmetic beside them.

What bounds it: the latency of a lane's ~80 dependent PCG64 steps and one
or two MD5 blocks (its bytes and operations are each under a microsecond),
so a batch is one launch with nothing in front of it: the stems, window
counts and paired counts are tables uploaded once a stage
(`ops.window_sample.SampleTables`) and read at a row offset.

`ops.window_sample.window_sample` is the router: the CPU takes NumPy's
generator, a CUDA device comes here and launches the kernel or raises —
there is no fallback.  `kernel_plan` is the host side's one decision; the
library reports its layout at load and the launcher raises unless it is the
plan's.  At the first launch on a card the launcher also draws `GUARD_*`'s
lanes both ways, through the kernel and through the installed NumPy, and
raises on any difference: a NumPy whose `choice` draws otherwise than the
kernel encodes is caught before its first sample.  Counter
`window_sample.lanes`: the lanes drawn on the card.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..runtime import count
from . import cuda_build

__all__ = ["window_sample_cuda", "kernel_plan", "check_layout", "build", "SRC", "SIGNATURES",
           "MAX_NW", "N_BANDS"]

SRC = Path(__file__).resolve().parent.parent / "csrc" / "window_sample.cu"
THREADS = 64              # lanes a block, one thread each
N_BANDS = 5
# windows a recording: bits of a lane's bitmap.  NumPy's tail-shuffle branch
# of `choice` starts above 10,000 windows, so every launch stays in Floyd's.
MAX_NW = 4096
# static shared bytes a block: each lane's bitmap of MAX_NW bits
SMEM_BYTES = MAX_NW // 32 * THREADS * 4
LAYOUT_FIELDS = ("threads", "max_nw", "smem_bytes", "registers", "local_bytes",
                 "occupancy")
# the load-time guard's lanes: 13 recordings × 5 bands at K = 39 with 15
# paired columns: nw ≤ K, nw = K, nw = 1, the study's 77-90, MAX_NW, and
# messages of one, two and three MD5 blocks (stem + "-{band}-42", 8 or 9
# bytes of suffix: 54-56 bytes at the first edge, 75, 119-120)
GUARD_STEMS = ("bb00_ut01", "bb07_ut13", "bb44_ut39", "x" * 46, "y" * 47,
               "rec-" + "z" * 62, "w" * 111, "bb30_ut20", "a", "bb01_ut01",
               "bb02_ut02", "bb03_ut03", "bb04_ut04")
GUARD_NW = (77, 90, 39, 5, 1, 200, MAX_NW, 84, 2, 40, 38, 88, 81)
GUARD_N_PAIR = (0, 1, 14, 15, 90, 77, 60, 5, 2, 16, 3, 40, 38)
GUARD_K, GUARD_KX = 39, 54
P, I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"window_sample_launch": ([P, P, I, I, I, I, I, I, I, P, P, P], I),
              "window_sample_layout": ([P], I)}


def kernel_plan(B: int, K: int, Kx: int, nw_max: int) -> dict:
    """Launch plan of one call over B recordings: one thread a (recording,
    band) lane, THREADS lanes a block, a grid of ceil(5·B / THREADS)
    blocks, each lane's bitmap of ceil(nw / 32) words.  Raises for what the
    kernel does not take: K < 1, Kx < K, one paired column (its float32
    step divides by zero), nw outside 0..MAX_NW."""
    if K < 1 or Kx < K or Kx - K == 1:
        raise ValueError(f"window_sample_cuda: K {K}, Kx {Kx}: 1 ≤ K ≤ Kx, "
                         "Kx − K ≠ 1")
    if not 0 <= nw_max <= MAX_NW:
        raise ValueError(f"window_sample_cuda: {nw_max} windows outside 0..{MAX_NW}")
    lanes = N_BANDS * B
    return dict(threads=THREADS, max_nw=MAX_NW, smem_bytes=SMEM_BYTES,
                grid=-(-lanes // THREADS), lanes=lanes,
                bitmap_words=-(-nw_max // 32))


def build() -> Path:
    """Compile the kernel (once per source content) and return the .so
    that `window_sample_cuda` loads."""
    return cuda_build.build(SRC)


@cuda_build.once_per_card
def check_layout(lib) -> dict:
    """The library's report (`LAYOUT_FIELDS`) against the plan: threads,
    MAX_NW and shared bytes must be the plan's, within the card's limits
    (`cuda_build.check_layout`).  Raises on any disagreement."""
    return cuda_build.check_layout(lib, "window_sample_layout", LAYOUT_FIELDS,
                                   kernel_plan(1, 1, 1, 0),
                                   ("threads", "max_nw", "smem_bytes"), SRC)


def layout_report() -> dict:
    """`check_layout` of the library and the NumPy guard on the current
    card, once per card and process."""
    card = torch.cuda.current_device()
    rep = check_layout(cuda_build.load(SRC, SIGNATURES), card=card)
    _guard(card)
    return rep


@functools.lru_cache(maxsize=None)
def _guard(card: int) -> None:
    """GUARD_*'s lanes through the kernel and through the installed NumPy
    (the router's CPU path) on a card, once; raises on any difference."""
    import numpy as np

    from .window_sample import SampleTables, window_sample_plain

    dev = torch.device("cuda", card)
    tab = SampleTables(GUARD_STEMS, GUARD_NW, GUARD_N_PAIR)
    B = len(GUARD_STEMS)
    idx, mask = _launch(*tab.on(dev), 0, B, GUARD_K, GUARD_KX, False, tab.nw_max)
    ref_idx, ref_mask = window_sample_plain(tab, 0, B, GUARD_K, GUARD_KX)
    if not (np.array_equal(idx.cpu().numpy(), ref_idx)
            and np.array_equal(mask.cpu().numpy(), ref_mask)):
        raise RuntimeError(
            "window_sample_cuda: the kernel's draw differs from NumPy "
            f"{np.__version__}'s default_rng(seed).choice on the guard's lanes: "
            "this NumPy samples otherwise than csrc/window_sample.cu encodes")


def _check(text, ints, row0, B):
    dev = text.device
    if dev.type != "cuda" or ints.device != dev:
        raise ValueError(f"window_sample_cuda: tables must be on one CUDA device, "
                         f"not {text.device} / {ints.device}")
    if text.dtype != torch.uint8 or ints.dtype != torch.int32 or text.dim() != 2 \
            or ints.shape != (text.shape[0], 3) or text.shape[0] <= N_BANDS:
        raise ValueError("window_sample_cuda: text (n + 5, width) uint8 and ints "
                         "(n + 5, 3) int32: n recordings, then the band suffixes")
    if not (text.is_contiguous() and ints.is_contiguous()):
        raise ValueError("window_sample_cuda: tables must be contiguous")
    if row0 < 0 or B < 0 or row0 + B > text.shape[0] - N_BANDS:
        raise ValueError(f"window_sample_cuda: rows [{row0}, {row0 + B}) outside "
                         f"the table's {text.shape[0] - N_BANDS}")


def _launch(text, ints, row0, B, K, Kx, first, nw_max):
    _check(text, ints, row0, B)
    kernel_plan(B, K, Kx, nw_max)
    dev = text.device
    idx = torch.empty((B, N_BANDS, Kx), dtype=torch.int64, device=dev)
    mask = torch.empty((B, N_BANDS, Kx), dtype=torch.bool, device=dev)
    if B == 0:
        return idx, mask
    with torch.cuda.device(dev):
        rc = cuda_build.load(SRC, SIGNATURES).window_sample_launch(
            text.data_ptr(), ints.data_ptr(), text.shape[1], text.shape[0] - N_BANDS,
            row0, B, K, Kx, int(first), idx.data_ptr(), mask.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"window_sample_launch failed: cudaError {rc}")
    return idx, mask


def window_sample_cuda(text, ints, row0: int, B: int, K: int, Kx: int,
                       first: bool, nw_max: int):
    """The window sample of rows [row0, row0 + B) of a stage's tables (text:
    (n + 5, width) uint8, the stems then the five band suffixes; ints: (n +
    5, 3) int32, byte length, nw, n_pair), every nw ≤ nw_max ≤ MAX_NW, on
    one CUDA device → (use_idx (B, 5, Kx) int64, use_mask (B, 5, Kx) bool)
    on it.  One launch, no host synchronisation.  Raises for anything
    else."""
    if text.device.type == "cuda":
        with torch.cuda.device(text.device):
            layout_report()
    idx, mask = _launch(text, ints, row0, B, K, Kx, first, nw_max)
    if B:
        window_sample_cuda.launches += 1
        count("window_sample.lanes", N_BANDS * B)
    return idx, mask


window_sample_cuda.launches = 0
