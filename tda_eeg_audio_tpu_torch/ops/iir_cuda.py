"""Hand-written CUDA kernel for the exact Butterworth filtfilt bank, and its
launcher.

Kernel: `csrc/sosfiltfilt.cu` (sm_90a).  It replaces no Pallas kernel: the
JAX package computes `bandpass_bank_iir_scan` (`filter_impl="iir_scan"`) as
XLA associative scans over 2×2 affine pairs
(`tda_eeg_audio_tpu/ops/signal.py::_biquad_scan`), log-depth because a
sequential recurrence is hostile to a TPU.  On the H100 one thread runs one
(series, band) recurrence with float64 state in registers: the forward
cascade over the series' odd extension (built on the fly from x and n, so
nothing is padded on the host) into a float64 scratch row, then the
backward cascade over that row in reverse, writing float32 output in
`bandpass_bank`'s layout (..., nb, T), zero beyond n.

Accuracy: float64 state keeps the port within ~1e-7 of scipy's float64
`sosfiltfilt` (relative to the band's largest value), where the JAX
package's float32 scan is off by up to ~5e-3 in the delta band; the port
and the JAX package therefore differ by about the JAX package's own error.

What bounds it on an H100: the loop-carried chain y → z1 → y, two
dependent FP64 FMAs per sample and pass, so a thread's time is about
2·(L + n + edge) FMA latencies; x read once and the bands written once, and
the FP64 operations, are below that at a batch's few thousand chains.  The
kernel keeps the chain in registers and loads the next 16 samples while the
current 16 are filtered; a chunked scan over the time axis is the redesign
left for later.

`signal.bandpass_bank_iir_scan` is the router: a CPU tensor takes the plain
recurrence (`signal.bandpass_bank_iir_plain`, the specification), a CUDA
tensor comes here and launches the kernel or raises — there is no fallback.
`kernel_plan` is the host side's one decision, a pure function.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from . import cuda_build

__all__ = ["sosfiltfilt_bank_cuda", "kernel_plan", "build", "SRC"]

SRC = Path(__file__).resolve().parent.parent / "csrc" / "sosfiltfilt.cu"
THREADS = 32        # one warp per block: a batch's chains spread over the SMs
MAX_SECTIONS = 8    # the kernel's instantiations: S = 1 … 8 sections

_libs = {}


def kernel_plan(n_series: int, n_bands: int, T: int, edge: int,
                n_sections: int) -> dict:
    """Launch plan of one call: one thread per (series, band) chain in
    blocks of THREADS, and the float64 scratch of (T + 2·edge) rows × chains
    (column-major: a warp's stores at one sample coalesce)."""
    if not 1 <= n_sections <= MAX_SECTIONS:
        raise ValueError(f"kernel_plan: {n_sections} sections outside "
                         f"1..{MAX_SECTIONS}")
    if edge < 1 or T < 0:
        raise ValueError(f"kernel_plan: edge={edge}, T={T}")
    chains = n_series * n_bands
    text = T + 2 * edge
    return dict(threads=THREADS, grid=-(-chains // THREADS), chains=chains,
                text=text, scratch_bytes=text * chains * 8)


def build(verbose: bool = False) -> Path:
    """Compile the kernel (once per source content) and return the .so."""
    return cuda_build.build_libraries([(SRC, ())], verbose)[0][0]


def _load():
    if "lib" not in _libs:
        lib = ctypes.CDLL(str(build()))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.sosfiltfilt_launch.argtypes = [P] * 6 + [I] * 6 + [P]
        lib.sosfiltfilt_launch.restype = I
        _libs["lib"] = lib
    return _libs["lib"]


def sosfiltfilt_bank_cuda(x: torch.Tensor, n, sos_bank, zi_bank,
                          edge: int) -> torch.Tensor:
    """One launch of the kernel: x (..., T) float32 on a CUDA device, valid
    to n (broadcastable to x.shape[:-1], clamped to [0, T] by the kernel) →
    (..., nb, T) float32, band b filtered by sos_bank[b] (nb, S, 6) with
    initial conditions zi_bank[b] (nb, S, 2), odd extension of `edge`
    samples (`signal.sos_edge`).  Raises for anything but a CUDA tensor."""
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
    plan = kernel_plan(n_series, nb, T, edge, S)
    nlen = torch.as_tensor(n, device=dev).to(torch.int32).expand(lead).contiguous()
    out = torch.empty((*lead, nb, T), dtype=torch.float32, device=dev)
    if plan["chains"] == 0 or T == 0:
        return out
    sos_t = torch.as_tensor(sos, device=dev)
    zi_t = torch.as_tensor(zi, device=dev)
    scratch = torch.empty(plan["scratch_bytes"] // 8, dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        rc = _load().sosfiltfilt_launch(
            x.data_ptr(), nlen.data_ptr(), sos_t.data_ptr(), zi_t.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), n_series, nb, S, T, edge,
            plan["threads"], torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sosfiltfilt_launch failed: cudaError {rc}")
    sosfiltfilt_bank_cuda.launches += 1
    return out


sosfiltfilt_bank_cuda.launches = 0
