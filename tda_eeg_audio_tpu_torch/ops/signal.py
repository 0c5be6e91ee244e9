"""Signal-processing ops of the study slice (counterpart of the reference's
`ops/signal.py`): host-side numpy/scipy filter design, and batched tensor
ops — FFT FIR bank, sliding windows, FIR Hilbert envelope, block-Toeplitz
polyphase resample, autocorrelation τ, Takens embedding, and the Welch
power spectrum of the EDA stage.

The exact IIR-scan filters are not ported yet.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..config import FREQ_BANDS

# ─────────────────────────────────────────────────────────────────────────────
# Host-side filter design (numpy/scipy; identical arrays to the reference)
# ─────────────────────────────────────────────────────────────────────────────


@functools.lru_cache(maxsize=None)
def _design_zero_phase_fir(low: float, high: float, fs: int, order: int,
                           numtaps: int, btype: str = "band") -> np.ndarray:
    """Linear-phase FIR matching the zero-phase Butterworth magnitude |H|²."""
    from scipy import signal as sps

    nyq = fs / 2.0
    if btype == "band":
        lo = max(low / nyq, 0.001)
        hi = min(high / nyq, 0.999)
        if lo >= hi:  # pass-through edge case (reference utils.py:71-72)
            h = np.zeros(numtaps)
            h[numtaps // 2] = 1.0
            return h
        b, a = sps.butter(order, [lo, hi], btype="band")
    else:
        b, a = sps.butter(order, low / nyq, btype="low")
    grid = 4096
    w, resp = sps.freqz(b, a, worN=grid + 1)
    target = np.abs(resp) ** 2
    freq = w / np.pi
    freq[0], freq[-1] = 0.0, 1.0
    h = sps.firwin2(numtaps, freq, target, window="hamming")
    return h.astype(np.float64)


@functools.lru_cache(maxsize=None)
def design_band_fir_bank(fs: int = 250, order: int = 4, numtaps: int = 1537) -> np.ndarray:
    """(5, numtaps) FIR bank for the study's five bands."""
    bank = [_design_zero_phase_fir(lo, hi, fs, order, numtaps)
            for lo, hi in FREQ_BANDS.values()]
    return np.stack(bank).astype(np.float32)


@functools.lru_cache(maxsize=None)
def design_envelope_lowpass(fs: int = 250, order: int = 4, numtaps: int = 801) -> np.ndarray:
    """FIR matching |H|² of the reference's 4th-order 50 Hz Butterworth LP."""
    from scipy import signal as sps

    nyq = fs / 2.0
    cutoff = min(50.0, nyq * 0.9)
    b, a = sps.butter(order, cutoff / nyq, btype="low")
    w, resp = sps.freqz(b, a, worN=4097)
    target = np.abs(resp) ** 2
    freq = w / np.pi
    freq[0], freq[-1] = 0.0, 1.0
    h = sps.firwin2(numtaps, freq, target, window="hamming")
    return h.astype(np.float32)


@functools.lru_cache(maxsize=None)
def design_hilbert_fir(numtaps: int = 401) -> np.ndarray:
    """Type-III FIR Hilbert transformer (odd taps, antisymmetric), Kaiser."""
    assert numtaps % 2 == 1
    n = np.arange(numtaps) - numtaps // 2
    h = np.zeros(numtaps)
    odd = n % 2 != 0
    h[odd] = 2.0 / (np.pi * n[odd])
    h *= np.kaiser(numtaps, 8.0)
    return h.astype(np.float32)


@functools.lru_cache(maxsize=None)
def design_resample_poly_filter(up: int = 250, down: int = 44100) -> tuple[np.ndarray, int, int]:
    """Exact scipy.signal.resample_poly Kaiser FIR (reference utils.py:77-79)."""
    from math import gcd

    from scipy import signal as sps

    g = gcd(up, down)
    up //= g
    down //= g
    max_rate = max(up, down)
    f_c = 1.0 / max_rate
    half_len = 10 * max_rate
    h = sps.firwin(2 * half_len + 1, f_c, window=("kaiser", 5.0))
    return (h * up).astype(np.float64), up, down


def resample_n_out(n_in, fs_out: int = 250, fs_in: int = 44100):
    """Output length of `resample_poly_device` for a true input length n_in:
    ceil(n_in·up/down), as scipy's resample_poly.  Host arithmetic on ints
    or numpy arrays."""
    from math import gcd

    g = gcd(fs_out, fs_in)
    up, down = fs_out // g, fs_in // g
    return (np.asarray(n_in) * up + down - 1) // down


# ─────────────────────────────────────────────────────────────────────────────
# Tensor ops
# ─────────────────────────────────────────────────────────────────────────────


def _fft_len(n: int) -> int:
    """Next power of two ≥ n (the reference's FFT size; same linear conv)."""
    return 1 << (n - 1).bit_length()


def _odd_ext(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Odd (antisymmetric) extension along the last axis.  A signal shorter
    than pad + 1 is extended by T − 1 samples each side (the reference's
    slice semantics), so the filtered output is then shorter than T."""
    e = min(pad, x.shape[-1] - 1)
    left = 2 * x[..., :1] - x[..., 1:e + 1].flip(-1)
    right = 2 * x[..., -1:] - x[..., x.shape[-1] - 1 - e:-1].flip(-1)
    return torch.cat([left, x, right], dim=-1)


def fir_zero_phase(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Zero-phase FIR along the last axis (symmetric taps, odd extension),
    as an FFT convolution."""
    numtaps = taps.shape[0]
    pad = numtaps // 2
    xe = _odd_ext(x, pad)
    L = xe.shape[-1]
    T = L - numtaps + 1
    N = _fft_len(L + numtaps - 1)
    X = torch.fft.rfft(xe, n=N, dim=-1)
    H = torch.fft.rfft(taps.to(x.dtype), n=N)
    y = torch.fft.irfft(X * H, n=N, dim=-1)
    return y[..., numtaps - 1: numtaps - 1 + T].to(x.dtype)


def bandpass_bank(x: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """Apply the 5-band zero-phase FIR bank: x (..., T) → (..., 5, T)."""
    n_bands, numtaps = bank.shape
    pad = numtaps // 2
    xe = _odd_ext(x, pad)
    L = xe.shape[-1]
    T = L - numtaps + 1
    N = _fft_len(L + numtaps - 1)
    X = torch.fft.rfft(xe, n=N, dim=-1)
    H = torch.fft.rfft(bank.to(x.dtype), n=N, dim=-1)
    y = torch.fft.irfft(X[..., None, :] * H, n=N, dim=-1)
    return y[..., numtaps - 1: numtaps - 1 + T].to(x.dtype)


def sliding_windows(x: torch.Tensor, n_windows: int, win: int, step: int) -> torch.Tensor:
    """(..., T) → (..., n_windows, win); window i starts at i·step.  Samples
    beyond T read as NaN (the reference's fill-mode gather); callers mask
    windows past each recording's length."""
    T = x.shape[-1]
    starts = torch.arange(n_windows, device=x.device) * step
    idx = starts[:, None] + torch.arange(win, device=x.device)[None, :]
    out = x[..., idx.clamp(max=T - 1)]
    if n_windows and (n_windows - 1) * step + win > T:
        out = torch.where(idx < T, out, torch.nan)
    return out


def fir_zero_phase_antisym(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Centered FIR with antisymmetric taps (Hilbert); zero edge extension."""
    numtaps = taps.shape[0]
    pad = numtaps // 2
    xe = F.pad(x, (pad, pad))
    lhs = xe.reshape(-1, 1, xe.shape[-1])
    rhs = taps.flip(0).reshape(1, 1, numtaps).to(x.dtype)
    out = F.conv1d(lhs, rhs)
    return out.reshape(*x.shape[:-1], out.shape[-1])


def hilbert_envelope(x: torch.Tensor, lp_taps: torch.Tensor, hilb_taps: torch.Tensor,
                     mask: torch.Tensor | None = None) -> torch.Tensor:
    """|analytic signal| via the FIR Hilbert transformer, then 50 Hz LP."""
    if mask is not None:
        x = x * mask
    xi = fir_zero_phase_antisym(x, hilb_taps)
    env = torch.sqrt(x * x + xi * xi)
    return fir_zero_phase(env, lp_taps)


def resample_poly_device(x: torch.Tensor, n_in: torch.Tensor, n_out_max: int,
                         h: np.ndarray, up: int, down: int):
    """Polyphase rational resampling, scipy.resample_poly-compatible, as the
    reference's block-Toeplitz product: the input cut into blocks of `down`
    samples, every output block j is Σ_e W[:, e, :] @ x_blocks[j + e].

    x: (B, T_pad) zero-padded, n_in: (B,).  Returns (y (B, n_out_max),
    n_out (B,))."""
    L_h = len(h)
    half = (L_h - 1) // 2
    B, T_pad = x.shape
    e_min = int(np.floor(-(half / up) / down))
    e_max = int(np.floor(((up - 1) * down + half) / up / down))
    es = np.arange(e_min, e_max + 1)
    p_i, e_i, f_i = np.meshgrid(np.arange(up), es, np.arange(down), indexing="ij")
    t_i = p_i * down + half - up * (down * e_i + f_i)
    W = np.where((t_i >= 0) & (t_i < L_h),
                 np.asarray(h)[np.clip(t_i, 0, L_h - 1)], 0.0)
    W = torch.as_tensor(W, dtype=x.dtype, device=x.device)   # (up, K_e, down)

    n_j = -(-n_out_max // up)
    n_b = -(-T_pad // down)
    xb = F.pad(x, (0, n_b * down - T_pad)).reshape(B, n_b, down)
    pad_lo = max(-e_min, 0)
    pad_hi = max(n_j + e_max - n_b, 0)
    xbp = F.pad(xb, (0, 0, pad_lo, pad_hi))
    y = torch.zeros((B, n_j, up), dtype=torch.float32, device=x.device)
    for k, e in enumerate(es):
        xs = xbp[:, pad_lo + e: pad_lo + e + n_j]
        y = y + torch.matmul(xs, W[:, k].transpose(0, 1))
    y = y.reshape(B, n_j * up)[:, :n_out_max].to(x.dtype)
    n_out = (n_in * up + down - 1) // down
    m_ids = torch.arange(n_out_max, device=x.device)[None, :]
    y = torch.where(m_ids < n_out[:, None], y, torch.zeros_like(y))
    return y, n_out


def autocorr_tau(windows: torch.Tensor, max_lag: int) -> torch.Tensor:
    """Per-window delay τ (reference scripts/utils.py:92-104): the first lag
    i ≥ 1 with normalized autocorrelation ≤ 0, else max(max_lag//10, 1)."""
    W = windows.shape[-1]
    ml = min(max_lag, W - 1)
    xc = windows - windows.mean(dim=-1, keepdim=True)
    n_fft = 2 * W
    Fx = torch.fft.rfft(xc, n=n_fft, dim=-1)
    ac = torch.fft.irfft(Fx * torch.conj(Fx), n=n_fft, dim=-1)[..., :W]
    ac = ac / (ac[..., :1] + 1e-10)
    lags = torch.arange(W, device=windows.device)
    cand = (ac <= 0) & (lags >= 1) & (lags < ml)
    first = torch.where(cand, lags, W).amin(dim=-1)          # first True
    fallback = max(ml // 10, 1)
    tau = torch.where(first < W, torch.clamp(first, min=1),
                      torch.full_like(first, fallback))
    return tau


def takens_embed(windows: torch.Tensor, tau: torch.Tensor, dim: int, subsample: int,
                 max_points: int):
    """Batched Takens delay embedding (reference scripts/utils.py:107-116).

    windows (..., W), tau (...,) → points (..., max_points, dim), mask."""
    W = windows.shape[-1]
    dev = windows.device
    p_ids = torch.arange(max_points, device=dev) * subsample
    d_ids = torch.arange(dim, device=dev)
    t = tau.reshape(-1, 1, 1).to(torch.int64)
    idx = (p_ids[None, :, None] + d_ids[None, None, :] * t).clamp(0, W - 1)
    flat_w = windows.reshape(-1, W)
    pts = torch.gather(flat_w[:, None, :].expand(-1, max_points, W), 2, idx)
    n_valid = W - (dim - 1) * tau.reshape(-1, 1)
    mask = p_ids[None, :] < torch.clamp(n_valid, min=0)
    lead = windows.shape[:-1]
    return pts.reshape(*lead, max_points, dim), mask.reshape(*lead, max_points)


def minmax_normalize_points(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-axis min-max to [0,1] over valid points; zero range → divide by 1."""
    big = torch.finfo(points.dtype).max
    m = mask[..., None]
    pmin = torch.where(m, points, torch.full_like(points, big)).amin(dim=-2, keepdim=True)
    pmax = torch.where(m, points, torch.full_like(points, -big)).amax(dim=-2, keepdim=True)
    rng = pmax - pmin
    rng = torch.where(rng == 0, torch.ones_like(rng), rng)
    out = (points - pmin) / rng
    return torch.where(m, out, torch.zeros_like(out))


def welch_psd(x: torch.Tensor, fs: float = 250.0, nperseg: int = 256,
              noverlap: int | None = None, n=None):
    """Welch power spectral density along the last axis on x's device (scipy
    semantics: Hann window, per-segment constant detrend, density scaling,
    one-sided): x (..., T) → (freqs (F,), Pxx (..., F)), F = nperseg//2 + 1.

    n: optional true lengths, broadcastable to x.shape[:-1].  Only segments
    that end inside [0, n) are averaged (the first segment where none does):
    the zero-padded tail would otherwise attenuate each recording's power by
    its padding fraction.  Needs T ≥ nperseg."""
    if noverlap is None:
        noverlap = nperseg // 2
    step = nperseg - noverlap
    T = x.shape[-1]
    if T < nperseg:
        raise ValueError(f"signal of {T} samples is shorter than nperseg={nperseg}")
    dev = x.device
    n_seg = (T - nperseg) // step + 1
    idx = (torch.arange(n_seg, device=dev)[:, None] * step
           + torch.arange(nperseg, device=dev)[None, :])
    segs = x[..., idx]                                   # (..., n_seg, nperseg)
    segs = segs - segs.mean(dim=-1, keepdim=True)
    k = torch.arange(nperseg, device=dev, dtype=torch.float32)
    win = (0.5 - 0.5 * torch.cos(2 * np.pi * k / nperseg)).to(x.dtype)
    X = torch.fft.rfft(segs * win, dim=-1)
    Pxx = (X.real ** 2 + X.imag ** 2) / (fs * (win ** 2).sum())
    # one-sided doubling, except DC and (for even nperseg) Nyquist
    dbl = torch.full((Pxx.shape[-1],), 2.0, dtype=Pxx.dtype, device=dev)
    dbl[0] = 1.0
    if nperseg % 2 == 0:
        dbl[-1] = 1.0
    Pxx = Pxx * dbl
    freqs = torch.fft.rfftfreq(nperseg, 1.0 / fs, device=dev)
    if n is None:
        return freqs, Pxx.mean(dim=-2)
    ends = torch.arange(n_seg, device=dev) * step + nperseg
    n_b = torch.as_tensor(n, device=dev).expand(x.shape[:-1])[..., None]
    smask = ends <= n_b                                  # (..., n_seg)
    smask[..., 0] |= ~smask.any(dim=-1)
    w = smask[..., None].to(Pxx.dtype)
    return freqs, (Pxx * w).sum(dim=-2) / w.sum(dim=-2).clamp(min=1.0)
