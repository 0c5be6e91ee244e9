"""Signal chain of the reference, plain PyTorch in the caller's dtype.

Frozen copies of the study's signal arithmetic as the reference scripts
define it and the port runs it: the zero-phase FIR bank matched to the
4th-order Butterworth |H|^2 (1,537 taps, odd extension), 1 s windows at
75 % overlap, Pearson correlation with the NaN -> 0 rule and d = sqrt(2(1 -
r)); for the audio, scipy's `resample_poly` filter as a block product, the
FIR Hilbert envelope with its 50 Hz low-pass, tau from the first window's
autocorrelation, the Takens embedding and min-max normalisation.  Filter
design uses scipy on the host, as the reference does.  Imports nothing of
the program.
"""

from __future__ import annotations

import functools
from math import gcd

import numpy as np
import torch
import torch.nn.functional as F

BANDS = {"delta": (0.5, 4.0), "theta": (4.0, 8.0), "alpha": (8.0, 13.0),
         "beta": (13.0, 30.0), "gamma": (30.0, 50.0)}


@functools.lru_cache(maxsize=None)
def zero_phase_fir(low: float, high: float, fs: int, order: int, numtaps: int,
                   btype: str = "band") -> np.ndarray:
    """Linear-phase FIR whose response is the Butterworth |H|^2."""
    from scipy import signal as sps

    nyq = fs / 2.0
    if btype == "band":
        lo, hi = max(low / nyq, 0.001), min(high / nyq, 0.999)
        if lo >= hi:
            h = np.zeros(numtaps)
            h[numtaps // 2] = 1.0
            return h
        b, a = sps.butter(order, [lo, hi], btype="band")
    else:
        b, a = sps.butter(order, low / nyq, btype="low")
    w, resp = sps.freqz(b, a, worN=4097)
    freq = w / np.pi
    freq[0], freq[-1] = 0.0, 1.0
    return sps.firwin2(numtaps, freq, np.abs(resp) ** 2, window="hamming")


@functools.lru_cache(maxsize=None)
def band_bank(fs: int, order: int, numtaps: int) -> np.ndarray:
    """(5, numtaps) float32 taps, the bands in study order (the program's
    taps are float32 too; the reference applies them in its own dtype)."""
    return np.stack([zero_phase_fir(lo, hi, fs, order, numtaps)
                     for lo, hi in BANDS.values()]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def envelope_lowpass(fs: int = 250, order: int = 4, numtaps: int = 801):
    cutoff = min(50.0, fs / 2.0 * 0.9)
    return zero_phase_fir(cutoff, 0.0, fs, order, numtaps, "low").astype(np.float32)


@functools.lru_cache(maxsize=None)
def hilbert_fir(numtaps: int = 401) -> np.ndarray:
    n = np.arange(numtaps) - numtaps // 2
    h = np.zeros(numtaps)
    odd = n % 2 != 0
    h[odd] = 2.0 / (np.pi * n[odd])
    return (h * np.kaiser(numtaps, 8.0)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def resample_filter(up: int, down: int):
    """scipy.signal.resample_poly's Kaiser FIR, and the reduced up / down."""
    from scipy import signal as sps

    g = gcd(up, down)
    up, down = up // g, down // g
    half_len = 10 * max(up, down)
    h = sps.firwin(2 * half_len + 1, 1.0 / max(up, down), window=("kaiser", 5.0))
    return h * up, up, down


def _odd_ext(x, pad: int):
    e = min(pad, x.shape[-1] - 1)
    left = 2 * x[..., :1] - x[..., 1:e + 1].flip(-1)
    right = 2 * x[..., -1:] - x[..., x.shape[-1] - 1 - e:-1].flip(-1)
    return torch.cat([left, x, right], dim=-1)


def fir_bank(x, taps):
    """Zero-phase FIR of x (..., T) by each row of taps (F, numtaps), odd
    extension, an FFT convolution: (..., F, T)."""
    numtaps = taps.shape[-1]
    xe = _odd_ext(x, numtaps // 2)
    L = xe.shape[-1]
    T = L - numtaps + 1
    N = 1 << (L + numtaps - 2).bit_length()
    X = torch.fft.rfft(xe, n=N, dim=-1)
    H = torch.fft.rfft(torch.as_tensor(taps, device=x.device).to(x.dtype), n=N, dim=-1)
    y = torch.fft.irfft(X[..., None, :] * H, n=N, dim=-1)
    return y[..., numtaps - 1:numtaps - 1 + T]


def windows(x, n_windows: int, win: int, step: int):
    """(..., T) → (..., n_windows, win), window i from sample i·step."""
    idx = (torch.arange(n_windows, device=x.device)[:, None] * step
           + torch.arange(win, device=x.device)[None, :])
    return x[..., idx]


def correlation_distance(w):
    """(..., C, T) windows → (..., C, C) distances sqrt(2(1 − r)), r the
    Pearson correlation, 0 for a constant channel, a zero diagonal."""
    x = w - w.mean(dim=-1, keepdim=True)
    norm = torch.sqrt((x * x).sum(dim=-1, keepdim=True))
    const = (w.amax(dim=-1) == w.amin(dim=-1)) | (norm[..., 0] == 0)
    z = x / torch.where(norm == 0, torch.ones_like(norm), norm)
    r = (z @ z.transpose(-1, -2)).clamp(-1.0, 1.0)
    r = torch.where(const[..., :, None] | const[..., None, :], 0.0, r)
    d = torch.sqrt(torch.clamp(2.0 * (1.0 - r), min=0.0))
    eye = torch.eye(d.shape[-1], dtype=torch.bool, device=d.device)
    return torch.where(eye, 0.0, d)


def resample_poly(x, n_in: int, up: int, down: int, h):
    """scipy.signal.resample_poly(x[:n_in], up, down) of a 1-D tensor, by
    the polyphase sum written out: y[m] = Σ_k x[k] h[m·down − k·up + half]."""
    L = len(h)
    half = (L - 1) // 2
    n_out = (n_in * up + down - 1) // down
    hx = torch.as_tensor(h, dtype=x.dtype, device=x.device)
    # output m reads inputs k with 0 <= m·down + half − k·up < L
    m = torch.arange(n_out, device=x.device)
    k_lo = torch.div(m * down + half - (L - 1) + up - 1, up, rounding_mode="floor")
    span = (L + up - 1) // up + 1
    k = k_lo[:, None] + torch.arange(span, device=x.device)[None, :]
    t = m[:, None] * down + half - k * up
    ok = (t >= 0) & (t < L) & (k >= 0) & (k < n_in)
    xv = torch.where(ok, x[k.clamp(0, n_in - 1)], 0.0)
    return (xv * torch.where(ok, hx[t.clamp(0, L - 1)], 0.0)).sum(dim=-1)


def hilbert_envelope(x, lp_taps, hb_taps):
    """|x + i·H{x}| with the FIR Hilbert transformer (zero edges), then the
    zero-phase 50 Hz low-pass."""
    pad = len(hb_taps) // 2
    xi = F.conv1d(F.pad(x, (pad, pad))[None, None],
                  torch.as_tensor(hb_taps, device=x.device).flip(0).to(x.dtype)[None, None])[0, 0]
    env = torch.sqrt(x * x + xi * xi)
    return fir_bank(env, np.asarray(lp_taps)[None])[0]


def autocorr_tau(w, max_lag: int):
    """First lag ≥ 1 (and < max_lag) where the normalised autocorrelation
    of each window (..., W) is ≤ 0, else max(max_lag // 10, 1)."""
    W = w.shape[-1]
    ml = min(max_lag, W - 1)
    xc = w - w.mean(dim=-1, keepdim=True)
    Fx = torch.fft.rfft(xc, n=2 * W, dim=-1)
    ac = torch.fft.irfft(Fx * torch.conj(Fx), n=2 * W, dim=-1)[..., :W]
    ac = ac / (ac[..., :1] + 1e-10)
    lags = torch.arange(W, device=w.device)
    cand = (ac <= 0) & (lags >= 1) & (lags < ml)
    first = torch.where(cand, lags, W).amin(dim=-1)
    return torch.where(first < W, first.clamp(min=1),
                       torch.full_like(first, max(ml // 10, 1)))


def takens_cloud(w, tau: int, dim: int, subsample: int):
    """One window (W,) → its min-max normalised Takens cloud (n, dim)."""
    W = w.shape[-1]
    n_valid = W - (dim - 1) * tau
    if n_valid <= 0:
        return w.new_zeros((0, dim))
    starts = torch.arange(0, n_valid, subsample, device=w.device)
    pts = torch.stack([w[starts + d * tau] for d in range(dim)], dim=-1)
    lo, hi = pts.amin(dim=0), pts.amax(dim=0)
    rng = torch.where(hi - lo == 0, torch.ones_like(hi), hi - lo)
    return (pts - lo) / rng


def cloud_distances(pts):
    diff = pts[:, None, :] - pts[None, :, :]
    return torch.sqrt((diff * diff).sum(dim=-1))
