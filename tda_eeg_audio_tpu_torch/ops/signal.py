"""Signal-processing ops of the study slice (counterpart of the reference's
`ops/signal.py`): host-side numpy/scipy filter design, and batched tensor
ops — FFT FIR bank, sliding windows, FIR Hilbert envelope, block-Toeplitz
polyphase resample, autocorrelation τ, Takens embedding, the Welch power
spectrum of the EDA stage, and the exact Butterworth `sosfiltfilt` of
`filter_impl="iir_scan"` (a float64 recurrence: a Python loop over time
here, the CUDA kernel of `iir_cuda` for CUDA tensors).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..config import FREQ_BANDS
from . import iir_cuda

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


def _poly_blocks(L_h: int, up: int, down: int) -> np.ndarray:
    """The block offsets e of `resample_poly_device`'s product."""
    half = (L_h - 1) // 2
    e_min = int(np.floor(-(half / up) / down))
    e_max = int(np.floor(((up - 1) * down + half) / up / down))
    return np.arange(e_min, e_max + 1)


def _poly_matrix(h: np.ndarray, up: int, down: int) -> np.ndarray:
    """The (up, K_e, down) block-Toeplitz taps W of `resample_poly_device`."""
    L_h = len(h)
    half = (L_h - 1) // 2
    es = _poly_blocks(L_h, up, down)
    p_i, e_i, f_i = np.meshgrid(np.arange(up), es, np.arange(down), indexing="ij")
    t_i = p_i * down + half - up * (down * e_i + f_i)
    return np.where((t_i >= 0) & (t_i < L_h),
                    np.asarray(h)[np.clip(t_i, 0, L_h - 1)], 0.0)


@functools.lru_cache(maxsize=None)
def resample_poly_matrix(up: int = 250, down: int = 44100) -> np.ndarray:
    """W of `design_resample_poly_filter(up, down)`'s filter, for
    `resample_poly_device(..., W=...)`."""
    return _poly_matrix(*design_resample_poly_filter(up, down))


def resample_poly_device(x: torch.Tensor, n_in: torch.Tensor, n_out_max: int,
                         h: np.ndarray, up: int, down: int, W=None):
    """Polyphase rational resampling, scipy.resample_poly-compatible, as the
    reference's block-Toeplitz product: the input cut into blocks of `down`
    samples, every output block j is Σ_e W[:, e, :] @ x_blocks[j + e].

    x: (B, T_pad) zero-padded, n_in: (B,); W: the taps as an x.dtype tensor
    on x's device (`resample_poly_matrix`), built here when None.  Returns
    (y (B, n_out_max), n_out (B,))."""
    B, T_pad = x.shape
    es = _poly_blocks(len(h), up, down)
    e_min, e_max = int(es[0]), int(es[-1])
    if W is None:
        W = torch.as_tensor(_poly_matrix(h, up, down), dtype=x.dtype, device=x.device)

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


# ─────────────────────────────────────────────────────────────────────────────
# Exact zero-phase IIR path (config.filter_impl == "iir_scan")
# ─────────────────────────────────────────────────────────────────────────────
#
# The reference's Butterworth filtfilt, with the JAX package's names and its
# padded-batch semantics.  The JAX package runs every biquad as a log-depth
# associative scan over 2×2 affine pairs in float32; the port runs the
# recurrence with float64 state (scipy's direct form II transposed): closer
# to scipy.  On the card one block per series and band cuts the time axis
# into chunks carried by the same affine algebra (`csrc/sosfiltfilt.cu`).
# The plain version below is the recurrence as a Python loop over time,
# vectorised over every series; it is the specification, serves CPU tensors,
# and is what the kernel is held to.


@functools.lru_cache(maxsize=None)
def design_butter_sos(low: float, high: float, fs: int, order: int = 4,
                      btype: str = "band"):
    """Butterworth SOS (S, 6) + per-section initial conditions (S, 2), float64
    (scipy semantics: notebooks/1_preprocesamiento.ipynb cell 1
    design_bandpass_filter; scripts/utils.py:56-74)."""
    from scipy import signal as sps

    nyq = fs / 2.0
    if btype == "band":
        lo = max(low / nyq, 0.001)
        hi = min(high / nyq, 0.999)
        sos = sps.butter(order, [lo, hi], btype="band", output="sos")
    else:
        sos = sps.butter(order, low / nyq, btype="low", output="sos")
    zi = sps.sosfilt_zi(sos)
    return sos.astype(np.float64), zi.astype(np.float64)


@functools.lru_cache(maxsize=None)
def design_butter_band_bank(fs: int, order: int = 4):
    """Stacked Butterworth SOS bank of the 5 study bands → (5, S, 6), (5, S, 2)."""
    soss, zis = [], []
    for lo, hi in FREQ_BANDS.values():
        sos, zi = design_butter_sos(lo, hi, fs, order, "band")
        soss.append(sos)
        zis.append(zi)
    return np.stack(soss), np.stack(zis)


def sos_edge(sos) -> int:
    """scipy's default odd-extension length of `sosfiltfilt`: 3·ntaps, with
    ntaps = 2·S + 1 less the smaller of the counts of sections whose b2 or
    a2 is 0; computed on the host from the design values.  sos: (S, 6), or
    a bank (nb, S, 6) whose bands must share one edge."""
    sos = np.asarray(sos).reshape(-1, *np.shape(sos)[-2:])
    edges = set()
    for band in sos:
        ntaps = 2 * band.shape[0] + 1
        ntaps -= min(int((band[:, 2] == 0).sum()), int((band[:, 5] == 0).sum()))
        edges.add(3 * ntaps)
    if len(edges) != 1:
        raise ValueError(f"the bank's bands need different edges {sorted(edges)}")
    return edges.pop()


def _cascade(sig: torch.Tensor, sos: torch.Tensor, zi: torch.Tensor) -> torch.Tensor:
    """Forward SOS cascade along the last axis in float64, sample after
    sample: scipy's direct form II transposed per section, with z1's sum
    taken as (b1·u + z2) − a1·y, the order of the kernel.  sig (..., L)
    float64; sos (..., S, 6) and zi (..., S, 2), broadcastable against sig's
    leading axes.  Every section starts from zi[s] · sig[..., 0], the first
    sample of the cascade's INPUT (scipy's sosfiltfilt scales all sections
    by it; it is not updated per section)."""
    x0 = sig[..., 0]
    S = sos.shape[-2]
    coef = [tuple(sos[..., s, k] for k in (0, 1, 2, 4, 5)) for s in range(S)]
    z1 = [zi[..., s, 0] * x0 for s in range(S)]
    z2 = [zi[..., s, 1] * x0 for s in range(S)]
    out = torch.empty(torch.broadcast_shapes(sig.shape, sos.shape[:-2] + (1,)),
                      dtype=torch.float64, device=sig.device)
    for j in range(sig.shape[-1]):
        u = sig[..., j]
        for s, (b0, b1, b2, a1, a2) in enumerate(coef):
            y = b0 * u + z1[s]
            z1[s] = (b1 * u + z2[s]) - a1 * y
            z2[s] = b2 * u - a2 * y
            u = y
        out[..., j] = u
    return out


def _sos_tensors(sos, zi, device):
    return (torch.as_tensor(np.asarray(sos), dtype=torch.float64, device=device),
            torch.as_tensor(np.asarray(zi), dtype=torch.float64, device=device))


def sosfiltfilt_scan(x: torch.Tensor, sos, zi) -> torch.Tensor:
    """scipy.signal.sosfiltfilt over the whole last axis (odd extension of
    sos_edge(sos) samples, zi scaling), the unmasked form; float64 inside,
    x's dtype out."""
    edge = sos_edge(sos)
    sos_t, zi_t = _sos_tensors(sos, zi, x.device)
    y = _cascade(_odd_ext(x.to(torch.float64), edge), sos_t, zi_t).flip(-1)
    y = _cascade(y, sos_t, zi_t).flip(-1)
    return y[..., edge:-edge].to(x.dtype)


def bandpass_iir_scan(x: torch.Tensor, fs: int, low: float, high: float,
                      order: int = 4) -> torch.Tensor:
    """Exact reference band-pass: Butterworth sosfiltfilt.  Pass-through when
    the clamped band is empty (reference utils.py:71-72)."""
    nyq = fs / 2.0
    if max(low / nyq, 0.001) >= min(high / nyq, 0.999):
        return x
    sos, zi = design_butter_sos(low, high, fs, order, "band")
    return sosfiltfilt_scan(x, sos, zi)


def _filtfilt_masked(x: torch.Tensor, n, sos_t: torch.Tensor, zi_t: torch.Tensor,
                     edge: int) -> torch.Tensor:
    """The length-aware filtfilt of `sosfiltfilt_scan_masked`, on coefficient
    tensors broadcastable against x's leading axes."""
    T = x.shape[-1]
    Text = T + 2 * edge
    dev = x.device
    xd = x.to(torch.float64)
    n = torch.as_tensor(n, device=dev).long().expand(x.shape[:-1]).clamp(0, T)[..., None]
    j = torch.arange(Text, device=dev)
    x_last = xd.gather(-1, (n - 1).clamp(min=0))
    x_first = xd[..., :1]
    in_left = j < edge
    in_mid = (j >= edge) & (j < edge + n)
    src = torch.where(in_left, edge - j,
                      torch.where(in_mid, j - edge, n - 2 - (j - edge - n)))
    vals = xd.gather(-1, src.clamp(0, T - 1))
    ext = torch.where(in_mid, vals,
                      torch.where(in_left, 2.0 * x_first - vals, 2.0 * x_last - vals))
    L = n + 2 * edge                                   # valid extension length
    ext = torch.where(j < L, ext, 0.0)
    y1 = _cascade(ext, sos_t, zi_t)
    # length-aware reversal: rev[j] = y1[L-1-j] for j < L, else 0
    rev = torch.where(j < L, y1.gather(-1, (L - 1 - j).clamp(0, Text - 1)
                                       .expand(y1.shape)), 0.0)
    y2 = _cascade(rev, sos_t, zi_t)
    # y2 is reversed: out[t] = y2[n + edge - 1 - t] for t < n
    t = torch.arange(T, device=dev)
    out = y2.gather(-1, (n + edge - 1 - t).clamp(0, Text - 1).expand(
        *y2.shape[:-1], T))
    return torch.where(t < n, out, 0.0).to(x.dtype)


def sosfiltfilt_scan_masked(x: torch.Tensor, n, sos, zi) -> torch.Tensor:
    """Exact `scipy.signal.sosfiltfilt` on length-padded batches.

    x: (..., T) with valid data in [0, n) per leading element (n
    broadcastable to x.shape[:-1], clamped to [0, T]).  Returns the filtered
    signal, exact on [0, n) and zero beyond.  The odd extension (its source
    index clipped to [0, T − 1], as the JAX package does, which matters when
    n ≤ edge), the reversal and the final crop follow each series' own
    length, so the padded tail never reaches the backward pass.  Plain
    PyTorch on any device (float64 recurrence, a Python loop over time)."""
    sos_t, zi_t = _sos_tensors(sos, zi, x.device)
    return _filtfilt_masked(x, n, sos_t, zi_t, sos_edge(sos))


def bandpass_bank_iir_plain(x: torch.Tensor, n, sos_bank, zi_bank) -> torch.Tensor:
    """The plain version of the bank: x (..., T) valid to n → (..., nb, T),
    band b filtered by sos_bank[b] (nb, S, 6) / zi_bank[b] (nb, S, 2); all
    bands in one vectorised recurrence."""
    sos_t, zi_t = _sos_tensors(sos_bank, zi_bank, x.device)
    nb = sos_t.shape[0]
    n = torch.as_tensor(n, device=x.device).expand(x.shape[:-1])[..., None]
    xb = x[..., None, :].expand(*x.shape[:-1], nb, x.shape[-1])
    return _filtfilt_masked(xb, n, sos_t, zi_t, sos_edge(sos_bank))


def bandpass_bank_iir_scan(x: torch.Tensor, n, fs: int, order: int = 4) -> torch.Tensor:
    """Exact 5-band Butterworth filtfilt bank on padded batches: x (..., T)
    valid to n samples → (..., 5, T), zero beyond n.  The exact counterpart
    of `bandpass_bank` (reference notebooks cell 1 `apply_bandpass_filter`
    per band); `filter_impl="iir_scan"` selects it.  A CPU tensor takes the
    plain recurrence; a CUDA tensor launches the kernel (`iir_cuda`) or
    raises — there is no fallback."""
    sos_bank, zi_bank = design_butter_band_bank(fs, order)
    if x.device.type == "cpu":
        return bandpass_bank_iir_plain(x, n, sos_bank, zi_bank)
    return iir_cuda.sosfiltfilt_bank_cuda(x, n, sos_bank, zi_bank,
                                          sos_edge(sos_bank))
