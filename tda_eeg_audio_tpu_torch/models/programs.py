"""The study's device programs in PyTorch (counterpart of the reference's
`models/programs.py`): features stage (with the per-window diagram bank),
mismatch-audio diagrams, and the EEG↔audio comparison with the EEG side
computed in the call or gathered from the bank.

Entry points (`eeg_feature_program`, `audio_h1_program`,
`comparison_program`, `comparison_from_bank`, `audio_takens_program`) take
numpy arrays or tensors and a ``device`` (None = CUDA; ``"cpu"`` runs the
plain PyTorch path).  Every H1 computation goes through
`h1_diagrams_routed`, which sends CUDA tensors to the hand-written kernel
and CPU tensors to the plain reduction; the comparison's H1 Wasserstein
goes through `_wass_sinkhorn_tiered`, which sends CUDA tensors to the tiered
Sinkhorn kernel and CPU tensors to its plain version, and its H0
Wasserstein through `ops.wasserstein.wasserstein_h0_exact`, likewise the
exact-DP kernel or the plain loop.  Overflow is flagged
here; the runner (`models/study.py`) redoes flagged recordings exactly
through `models/homology_exec.run_tda`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import PipelineConfig, DEFAULT_CONFIG, FREQ_BANDS
from ..ops import geometry as tgeo
from ..ops import signal as tsig
from ..ops import stats as tstats
from ..ops.features import aggregate_mean_std, diagram_features
from ..ops.homology_cuda import h1_diagrams_cuda
from ..ops.wasserstein import (ITERS, STEPS, W_TIERS, build_cost_matrix,
                               sinkhorn_cost_stab, wasserstein_h0_exact)
from ..ops.wasserstein_cuda import sinkhorn_tiered_cuda
from ..runtime import count, counting, device_constant, resolve_device, span

N_BANDS = len(FREQ_BANDS)

# The reference clamps the stored-column arena at the audio shape (n = 124,
# its per-window kernel's route from n ≥ 65 on) and floors the per-window
# step budget at 8192; both are kept so overflow flags mean the same thing.
PALLAS_NA_MAX = 96
PALLAS_MIN_N = 65
STEP_BUDGET_FLOOR = 8192


# ─────────────────────────────────────────────────────────────────────────────
# H1 routing
# ─────────────────────────────────────────────────────────────────────────────


def h1_diagrams_routed(dm, n_pts=None, *, n: int, thresh: float, na_max: int,
                       h1_max: int, step_budget: int):
    """The routing point for every H1 call: a CUDA tensor goes to the CUDA
    kernel (EEG n = 47 windows and n = 124 Takens clouds alike), a CPU
    tensor to the plain reduction — inside `h1_diagrams_cuda`."""
    if n >= PALLAS_MIN_N:
        na_max = min(na_max, PALLAS_NA_MAX)
    return h1_diagrams_cuda(dm, n_pts, n=n, thresh=thresh, na_max=na_max,
                            h1_max=h1_max,
                            step_budget=max(step_budget, STEP_BUDGET_FLOOR))


# ─────────────────────────────────────────────────────────────────────────────
# EEG branch
# ─────────────────────────────────────────────────────────────────────────────


def _band_bank(eeg, n_samples, cfg):
    """Filter bank: (B, C, T) → banded (B, C, 5, T) (the FIR bank's output is
    a strided slice of its `irfft` buffer, the IIR bank's contiguous)."""
    if cfg.filter_impl == "iir_scan":
        # exact Butterworth sosfiltfilt (length-aware; the CUDA recurrence
        # kernel for CUDA tensors)
        return tsig.bandpass_bank_iir_scan(eeg, n_samples[:, None], cfg.fs_eeg,
                                           cfg.filter_order)
    return tsig.bandpass_bank(eeg, _fir_bank(cfg, eeg.device))


def _banded_windows(eeg, n_samples, cfg, n_win_max):
    """Filter bank → 1 s / 75 % sliding windows.
    Returns (wins (B, 5, W, C, win), wmask (B, W))."""
    banded = _band_bank(eeg, n_samples, cfg)                      # (B, C, 5, T)
    win, step = cfg.win_samples, cfg.step_samples
    wins = tsig.sliding_windows(banded, n_win_max, win, step)    # (B, C, 5, W, win)
    wins = wins.permute(0, 2, 3, 1, 4)                           # (B, 5, W, C, win)
    starts = torch.arange(n_win_max, device=eeg.device) * step
    wmask = (starts + win)[None, :] <= n_samples[:, None]
    return wins, wmask


def _window_distances(banded, use_idx, cfg):
    """The configuration's distances of the (B, 5, K) windows use_idx of a
    banded signal (`ops.geometry.window_distances`: the kernel on a card)."""
    return tgeo.window_distances(banded, use_idx, cfg.distance_method,
                                 cfg.win_samples, cfg.step_samples)


def _fir_bank(cfg: PipelineConfig, dev: torch.device) -> torch.Tensor:
    """The five-band FIR bank on `dev`, uploaded once a device."""
    return device_constant(tsig.design_band_fir_bank, dev, torch.float32,
                           cfg.fs_eeg, cfg.filter_order, cfg.fir_numtaps)


def eeg_window_program(eeg, n_samples, cfg: PipelineConfig = DEFAULT_CONFIG,
                       n_win_max: int = 89, device=None):
    """(B, 47, T_pad) padded EEG → banded windows (B, 5, W, 47, win) and the
    window mask (B, W): the preprocessed/ stage (reference
    notebooks/1_preprocesamiento.ipynb cell 3)."""
    dev = resolve_device(device)
    return _banded_windows(torch.as_tensor(eeg, device=dev, dtype=torch.float32),
                           torch.as_tensor(n_samples, device=dev).long(), cfg,
                           n_win_max)


def eeg_distance_program(eeg, n_samples, cfg: PipelineConfig = DEFAULT_CONFIG,
                         n_win_max: int = 89, device=None):
    """(B, 47, T_pad) padded EEG → per-band correlation distances of every
    window: (dist (B, 5, W, 47, 47), corr, wmask (B, W)); windows beyond a
    recording's true length are masked (the graphs/ stage, reference
    notebooks/2_graph_construction.ipynb cell 8, and the staged features
    path, which selects its windows afterwards)."""
    wins, wmask = eeg_window_program(eeg, n_samples, cfg, n_win_max, device)
    corr = tgeo.correlation_matrix(wins)
    return tgeo.correlation_to_distance(corr, cfg.distance_method), corr, wmask


def window_tda_features(dm, thresh: float = 2.0, na_max: int = 128,
                        h1_max: int = 128, step_budget: int = 4096):
    """(B, 47, 47) distance matrices → (B, 2, 11) H0/H1 features + diagrams
    (reference scripts/tda_eeg_classification_v2.py:407-419)."""
    n = dm.shape[-1]
    out = h1_diagrams_routed(dm, n=n, thresh=thresh, na_max=na_max,
                             h1_max=h1_max, step_budget=step_budget)
    n_comp = (n - out["n_tree"]).to(torch.int32)
    f_h0 = diagram_features(torch.zeros_like(out["h0_deaths"]), out["h0_deaths"],
                            out["h0_mask"], n_comp)
    fin = out["mask"] & torch.isfinite(out["deaths"])
    f_h1 = diagram_features(out["births"], torch.where(fin, out["deaths"], 0.0),
                            fin, out["n_essential"])
    return torch.stack([f_h0, f_h1], dim=1), out


def eeg_window_distances(eeg, n_samples, use_idx, cfg):
    """Filter bank → the (B, 5, K) selected windows' correlation distances,
    read in place from the banded signal (the span `eeg_window_distances`).
    eeg (B, 47, T_pad), n_samples (B,), use_idx (B, 5, K) tensors on one
    device.  Returns dist (B, 5, K, n, n)."""
    banded = _band_bank(eeg, n_samples, cfg)
    with span("eeg_window_distances", eeg.device):
        return _window_distances(banded, use_idx, cfg)


def eeg_feature_program(eeg, n_samples, use_idx, use_mask,
                        cfg: PipelineConfig = DEFAULT_CONFIG,
                        K: int = 39, na_max: int = 128, step_budget: int = 4096,
                        return_dm0: bool = False, return_bank: bool = False,
                        device=None):
    """Features stage: padded EEG (B, 47, T_pad) → (B, 5, 2, 11, 2)
    aggregate of the 11 H0/H1 features over the K sampled windows per band
    (filter → window-select → corr → dist → exact H0/H1 → features →
    mean/std).  use_idx/use_mask: (B, 5, K) window sample.  Returns
    (agg, ovf (B,)) — ovf flags recordings with an overflowed used window —
    and, with return_dm0, the window-0 distance diagnostics (B, 5, 8)
    between them (window 0 rides as one more index column of the same
    launch).  The H1 wrapper chunks windows to bound its memory.

    return_bank appends a dict of per-window diagrams of EVERY column
    (mask=False columns included), packed as the comparison consumes them:
    h1_b/h1_d/h1_m (B, 5·K, na_max) finite bars only, h0_d/h0_m
    (B, 5·K, n−1), feats (B, 5·K, 2, 11), and ovf (B,), which flags a
    truncated diagram on any column — such a row must not serve
    `comparison_from_bank`.  The call is the span `eeg_feature_program`."""
    dev = resolve_device(device)
    with span("eeg_feature_program", dev):
        return _eeg_feature_program(eeg, n_samples, use_idx, use_mask, cfg, K, na_max,
                                    step_budget, return_dm0, return_bank, dev)


def _eeg_feature_program(eeg, n_samples, use_idx, use_mask, cfg, K, na_max,
                         step_budget, return_dm0, return_bank, dev):
    eeg = torch.as_tensor(eeg, device=dev, dtype=torch.float32)
    n_samples = torch.as_tensor(n_samples, device=dev).long()
    use_idx = torch.as_tensor(use_idx, device=dev).long()
    use_mask = torch.as_tensor(use_mask, device=dev, dtype=torch.bool)
    B = eeg.shape[0]
    if return_dm0:
        use_idx = torch.cat([use_idx, use_idx.new_zeros((B, N_BANDS, 1))], dim=2)
    dist = eeg_window_distances(eeg, n_samples, use_idx, cfg)
    n = dist.shape[-1]
    feats, out = window_tda_features(dist[:, :, :K].reshape(B * N_BANDS * K, n, n),
                                     thresh=cfg.max_edge_length, na_max=na_max,
                                     h1_max=na_max, step_budget=step_budget)
    feats = feats.reshape(B, N_BANDS, K, 22)
    ovf_cols = out["overflow"].reshape(B, N_BANDS, K)
    ovf = (ovf_cols & use_mask).any(dim=2).any(dim=1)
    agg = aggregate_mean_std(feats, use_mask).reshape(B, N_BANDS, 2, 11, 2)
    tail = ()
    if return_bank:
        M = N_BANDS * K
        fin = out["mask"] & torch.isfinite(out["deaths"])
        h0d = torch.where(torch.isfinite(out["h0_deaths"]), out["h0_deaths"], 0.0)
        tail = (dict(h1_b=out["births"].reshape(B, M, -1),
                     h1_d=torch.where(fin, out["deaths"], 0.0).reshape(B, M, -1),
                     h1_m=fin.reshape(B, M, -1),
                     h0_d=h0d.reshape(B, M, -1),
                     h0_m=out["h0_mask"].reshape(B, M, -1),
                     feats=feats.reshape(B, M, 2, 11),
                     ovf=ovf_cols.any(dim=2).any(dim=1)),)
    if not return_dm0:
        return (agg, ovf) + tail
    return (agg, _dm_diagnostics(dist[:, :, K]), ovf) + tail


def _dm_diagnostics(dm):
    """(..., n, n) → (..., 8) [sym_bad, max_asym, neg_bad, min_val,
    diag_bad, max_abs_diag, has_nan, has_inf] (same tolerances as the
    reference's validate_distance_matrix)."""
    dmt = dm.transpose(-1, -2)
    ad = (dm - dmt).abs()
    sym_ok = ((dm == dmt) | (ad <= 1e-8 + 1e-5 * dmt.abs())).all(dim=-1).all(dim=-1)
    diag = torch.diagonal(dm, dim1=-2, dim2=-1)
    diag_ok = (diag.abs() <= 1e-10).all(dim=-1)
    min_val = dm.amin(dim=(-1, -2))
    f = lambda b: b.to(torch.float32)  # noqa: E731
    return torch.stack([
        f(~sym_ok), ad.amax(dim=(-1, -2)), f(min_val < -1e-10),
        min_val, f(~diag_ok), diag.abs().amax(dim=-1),
        f(torch.isnan(dm).any(dim=-1).any(dim=-1)),
        f(torch.isinf(dm).any(dim=-1).any(dim=-1))], dim=-1)


# ─────────────────────────────────────────────────────────────────────────────
# Comparison helpers
# ─────────────────────────────────────────────────────────────────────────────

def _compact_rows(b, d, m):
    """Move each diagram's valid bars to the front of its row (stable)."""
    ci = torch.argsort((~m).to(torch.uint8), dim=1, stable=True)
    return b.gather(1, ci), d.gather(1, ci), m.gather(1, ci)


def _wass_chunk_tiered(bb1, dd1, mm1, bb2, dd2, mm2):
    """Sinkhorn chunk at the narrowest tier width that holds every bar of
    the chunk (pad slots are zero-cost pad↔pad matches, so the result is
    width-invariant up to rounding); full width otherwise."""
    width = max(mm1.shape[1], mm2.shape[1])
    for w in W_TIERS:
        if w >= width:
            continue
        if not bool(mm1[:, w:].any() | mm2[:, w:].any()):
            return sinkhorn_cost_stab(build_cost_matrix(
                bb1[:, :w], dd1[:, :w], mm1[:, :w],
                bb2[:, :w], dd2[:, :w], mm2[:, :w]))
    return sinkhorn_cost_stab(build_cost_matrix(bb1, dd1, mm1, bb2, dd2, mm2))


def _wass_sinkhorn_tiered(b1, d1, m1, b2, d2, m2):
    """Tiered Sinkhorn cost of (N, K) padded diagram pairs → (N,).  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel
    (`ops/wasserstein_cuda.py`: one bucketing launch, then one launch per
    width class, five at the comparison's pad width; no host
    synchronisation) or raises — there is no fallback.  Inside a
    `runtime.timed_spans()` block it counts its work (`count_sinkhorn_work`)."""
    if counting():
        count_sinkhorn_work(m1, m2)
    if b1.device.type == "cpu":
        return wass_sinkhorn_tiered_plain(b1, d1, m1, b2, d2, m2)
    return sinkhorn_tiered_cuda(*(x.contiguous() for x in (b1, d1, m1, b2, d2, m2)))


def count_sinkhorn_work(m1, m2):
    """Counters `sinkhorn_tiered.pairs` and `sinkhorn_tiered.flop`: per pair
    4·S²·STEPS·ITERS (two S × S matvecs an iteration), S = n1 + n2 the
    augmented problem's own size, each side's visible bars and at least one
    (an empty diagram is the one [[0, 0]] bar).  Tiers, classes and pads
    are not counted, whatever kernel solves the pairs.  The flop count is
    summed on the masks' device."""
    S = m1.sum(dim=1).clamp(min=1) + m2.sum(dim=1).clamp(min=1)
    count("sinkhorn_tiered.pairs", m1.shape[0])
    count("sinkhorn_tiered.flop", (S * S).sum() * (4 * STEPS * ITERS))


def wass_sinkhorn_tiered_plain(b1, d1, m1, b2, d2, m2, chunk: int = 128):
    """Size-sorted tiered Sinkhorn over (N, K) padded diagram pairs: pairs
    sorted by bar count, fixed-size chunks (zero-padded), each at its
    narrowest tier, results returned in input order.  The kernel's
    specification (one host synchronisation per chunk and tier)."""
    N = b1.shape[0]
    b1, d1, m1 = _compact_rows(b1, d1, m1)
    b2, d2, m2 = _compact_rows(b2, d2, m2)
    r = torch.maximum(m1.sum(dim=1), m2.sum(dim=1))
    order = torch.argsort(-r, stable=True)
    arrs = [x[order] for x in (b1, d1, m1, b2, d2, m2)]
    outs = []
    for c in range(0, N, chunk):
        end = min(c + chunk, N)
        blks = []
        for v in arrs:
            blk = v[c:end]
            if end - c < chunk:
                blk = torch.cat([blk, torch.zeros((chunk - (end - c), v.shape[1]),
                                                  dtype=v.dtype, device=v.device)])
            blks.append(blk)
        outs.append(_wass_chunk_tiered(*blks)[: end - c])
    return torch.cat(outs)[torch.argsort(order)]


def _pair_distance_program(eeg, n_samples, aud_use_idx, aud_n_win,
                           cfg: PipelineConfig, K: int, n_win_max: int):
    """Banded windows → the ≤K paired windows (the audio program's index
    set) → correlation distance.  Returns (dist (B, 5·K, n, n), kmask (B, K),
    n_pair (B,))."""
    B = eeg.shape[0]
    use_idx = aud_use_idx.clamp(0, n_win_max - 1)[:, None, :].expand(-1, N_BANDS, -1)
    dist = _window_distances(_band_bank(eeg, n_samples, cfg), use_idx, cfg)
    n_pair = aud_n_win.long()
    k = torch.arange(K, device=eeg.device)
    kmask = k[None, :] < torch.clamp(n_pair, max=K)[:, None]
    n = dist.shape[-1]
    return dist.reshape(B, N_BANDS * K, n, n), kmask, n_pair


def window_count_program(n_samples, win: int, step: int, t_pad: int):
    """Window count from recording length alone (w valid iff w·step + win ≤ n)."""
    n = torch.clamp(n_samples.long(), max=t_pad)
    return torch.clamp((n - win) // step + 1, min=0)


def _h0_pack(out):
    d = torch.where(torch.isfinite(out["h0_deaths"]), out["h0_deaths"], 0.0)
    return torch.zeros_like(d), d, out["h0_mask"]


def _h1_pack(out):
    b = out["births"]
    d = out["deaths"]
    m = out["h1_mask"] & torch.isfinite(d)
    return b, torch.where(m, d, 0.0), m


# the five H1 features the comparison correlates, among the 11: mean and
# total persistence, entropy, max persistence, n_features
H1_FEAT_COLS = (6, 9, 10, 8, 0)


def _comparison_stats_program(w_h0, w_h1, w_h1_mis, e_feats, a_feats,
                              kmask, a_degen, mis_degen, n_win_e, mis_n_win,
                              K: int):
    """Window-mean Wasserstein + Spearman correlations of five H1 features
    → (B, 5) stats.  Degenerate Takens windows (< 3 points) are excluded
    (reference tda_eeg_audio_comparison.py:90-91)."""
    B = kmask.shape[0]
    dev = kmask.device
    k = torch.arange(K, device=dev)
    km_b = kmask[:, None, :].expand(B, N_BANDS, K)
    pm = (km_b & ~a_degen).reshape(-1)
    n_mis = torch.clamp(torch.minimum(n_win_e.long(), mis_n_win.long()), max=K)
    mis_pm = (km_b & (k[None, None, :] < n_mis[:, None, None]) & ~mis_degen).reshape(-1)

    def wmean(w, m):
        w = w.reshape(B, N_BANDS, K)
        m = m.reshape(B, N_BANDS, K)
        return torch.where(m, w, 0.0).sum(-1) / torch.clamp(m.sum(-1), min=1)

    feat_idx = device_constant(np.asarray, dev, torch.int64, H1_FEAT_COLS)
    ef = e_feats.reshape(B, N_BANDS, K, 2, 11)[:, :, :, 1, :]
    af = a_feats.reshape(B, N_BANDS, K, 2, 11)[:, :, :, 1, :]
    e_ts = ef[..., feat_idx].movedim(-1, 2)                       # (B, 5, 5f, K)
    a_ts = af[..., feat_idx].movedim(-1, 2)
    km3 = (km_b & ~a_degen)[:, :, None, :].expand(e_ts.shape)
    r, p = tstats.spearmanr(a_ts.reshape(-1, K), e_ts.reshape(-1, K),
                            km3.reshape(-1, K))
    n_valid = (km_b & ~a_degen).sum(-1)

    def mstd(x):    # np.std over the kept windows only
        nv = torch.clamp(km3.sum(-1), min=1)
        mu = torch.where(km3, x, 0.0).sum(-1) / nv
        return torch.sqrt(torch.where(km3, (x - mu[..., None]) ** 2, 0.0).sum(-1) / nv)

    std_ok = (mstd(a_ts) > 1e-10) & (mstd(e_ts) > 1e-10)
    ok = (n_valid[:, :, None] >= 5) & std_ok
    r = torch.where(ok, r.reshape(B, N_BANDS, 5), 0.0)
    p = torch.where(ok, p.reshape(B, N_BANDS, 5), 1.0)
    return dict(w_h0=wmean(w_h0, pm), w_h1=wmean(w_h1, pm),
                w_h1_mis=wmean(w_h1_mis, mis_pm), corr_r=r, corr_p=p)


def _diagrams_flat(dm, n_pts, thresh, na_max, step_budget):
    """(B, M, n, n) batch-first clouds → flat (B·M, ...) audio_window_diagrams
    outputs (window-major within recording)."""
    B, M = dm.shape[:2]
    return audio_window_diagrams(dm.reshape(B * M, *dm.shape[2:]),
                                 n_pts.reshape(B * M), thresh=thresh,
                                 na_max=na_max, h1_max=na_max,
                                 step_budget=step_budget)


# ─────────────────────────────────────────────────────────────────────────────
# Comparison entry points
# ─────────────────────────────────────────────────────────────────────────────


def audio_h1_program(audio, n_a, cfg: PipelineConfig = DEFAULT_CONFIG,
                     n_rs_max: int = 5900, n_win_max: int = 90, K: int = 15,
                     n_win_cap=None, device=None):
    """Audio → per-band H1 diagrams on the ≤K subsampled windows (the
    mismatched-control getter, reference matched_vs_mismatched.py:35-63).

    Returns dict h1_b/h1_d/h1_m (B·5·K, 96), n_win (B,), degen (B, 5, K),
    overflow (B·5·K,)."""
    dev = resolve_device(device)
    audio = torch.as_tensor(audio, device=dev, dtype=torch.float32)
    n_a = torch.as_tensor(n_a, device=dev).long()
    if n_win_cap is not None:
        n_win_cap = torch.as_tensor(n_win_cap, device=dev).long()
    aud = audio_takens_program(audio, n_a, cfg, n_rs_max, n_win_max, K,
                               n_win_cap=n_win_cap, device=dev)
    P = cfg.max_takens_points
    B = audio.shape[0]
    out = _diagrams_flat(aud["dm"].reshape(B, N_BANDS * K, P, P),
                         aud["n_pts"].reshape(B, N_BANDS * K),
                         cfg.max_edge_length, 96, 8192)
    b, d, m = _h1_pack(out)
    return dict(h1_b=b, h1_d=d, h1_m=m, n_win=aud["n_win"],
                degen=aud["n_pts"] < 3, overflow=out["overflow"])


def comparison_program(eeg, n_e, audio, n_a, mis_h1, mis_n_win, mis_degen,
                       cfg: PipelineConfig = DEFAULT_CONFIG,
                       n_win_max: int = 90, n_rs_max: int = 5900,
                       K: int = 15, device=None):
    """EEG↔audio comparison + matched/mismatched control for one batch
    (reference scripts/tda_eeg_audio_comparison.py:45-124 and
    matched_vs_mismatched.py:35-95): EEG → paired distance windows; own
    audio → Takens diagrams; window-paired Wasserstein W_H0 (exact DP) and
    W_H1 (tiered Sinkhorn, matched and mismatched); Spearman correlations of
    five H1 features.

    mis_h1 = (b, d, m) H1 arrays (B·5·K, 96) of each recording's mismatch
    audio from `audio_h1_program`, with mis_n_win (B,), mis_degen (B, 5, K).
    Returns w_h0, w_h1, w_h1_mis (B, 5), corr_r, corr_p (B, 5, 5), tau
    (B, 5), n_pair (B,), a_degen (B, 5), overflow (B,)."""
    dev = resolve_device(device)
    eeg = torch.as_tensor(eeg, device=dev, dtype=torch.float32)
    n_e = torch.as_tensor(n_e, device=dev).long()
    audio = torch.as_tensor(audio, device=dev, dtype=torch.float32)
    n_a = torch.as_tensor(n_a, device=dev).long()
    mis_h1 = tuple(torch.as_tensor(x, device=dev) for x in mis_h1)
    mis_n_win = torch.as_tensor(mis_n_win, device=dev).long()
    mis_degen = torch.as_tensor(mis_degen, device=dev, dtype=torch.bool)
    B = eeg.shape[0]
    n_win_e = window_count_program(n_e, cfg.win_samples, cfg.step_samples,
                                   eeg.shape[-1])
    with span("audio_takens", dev):
        aud = audio_takens_program(audio, n_a, cfg, n_rs_max, n_win_max, K,
                                   n_win_cap=n_win_e, device=dev)
    with span("eeg_pair_distance", dev):
        sel_e, kmask, n_pair = _pair_distance_program(
            eeg, n_e, aud["use_idx"], aud["n_win"], cfg, K, n_win_max)
    n = sel_e.shape[-1]
    with span("eeg_diagrams", dev):
        e_out = _diagrams_flat(
            sel_e, torch.full(sel_e.shape[:2], n, dtype=torch.long, device=dev),
            cfg.max_edge_length, 96, 4096)
    P = cfg.max_takens_points
    with span("audio_diagrams", dev):
        a_out = _diagrams_flat(aud["dm"].reshape(B, N_BANDS * K, P, P),
                               aud["n_pts"].reshape(B, N_BANDS * K),
                               cfg.max_edge_length, 96, 8192)
    _, e0d, e0m = _h0_pack(e_out)
    e_ovf = e_out["overflow"].reshape(B, -1).any(dim=1)
    return _comparison_tail(e0d, e0m, _h1_pack(e_out), e_out["features"],
                            e_ovf, aud, a_out, kmask, n_win_e, n_pair,
                            mis_h1, mis_n_win, mis_degen, K, B)


def comparison_from_bank(e_bank, gidx, n_e, audio, n_a, mis_h1, mis_n_win,
                         mis_degen, cfg: PipelineConfig = DEFAULT_CONFIG,
                         n_win_max: int = 90, n_rs_max: int = 5900,
                         K: int = 15, t_eeg_pad: int = 5800, device=None):
    """`comparison_program` with the EEG side gathered from the features
    stage's per-window diagram bank instead of recomputed.

    e_bank: flat (R, ·) leaves h1_b/h1_d/h1_m/h0_d/h0_m/feats of
    `eeg_feature_program(return_bank=True)`, R = bank rows · 5 · K_feat, on
    any device (the rows are gathered there and moved to `device`);
    gidx: (B·5·K,) flat indices of each recording's paired windows (the
    runner appends them to every bank row as mask=False columns).

    The bank's H1 rows are as wide as the features stage's arena; they are
    normalised to the in-call path's 96 columns — a wider row is sliced and
    any bar beyond 96 flags the recording's `overflow` (the recordings the
    in-call path would flag), a narrower row is zero-padded, because the
    tiered Sinkhorn's widths follow the row width."""
    dev = resolve_device(device)
    gidx = torch.as_tensor(gidx, device=dev).long()
    n_e = torch.as_tensor(n_e, device=dev).long()
    audio = torch.as_tensor(audio, device=dev, dtype=torch.float32)
    n_a = torch.as_tensor(n_a, device=dev).long()
    mis_h1 = tuple(torch.as_tensor(x, device=dev) for x in mis_h1)
    mis_n_win = torch.as_tensor(mis_n_win, device=dev).long()
    mis_degen = torch.as_tensor(mis_degen, device=dev, dtype=torch.bool)
    B = audio.shape[0]
    n_win_e = window_count_program(n_e, cfg.win_samples, cfg.step_samples,
                                   t_eeg_pad)
    with span("audio_takens", dev):
        aud = audio_takens_program(audio, n_a, cfg, n_rs_max, n_win_max, K,
                                   n_win_cap=n_win_e, device=dev)
    P = cfg.max_takens_points
    with span("audio_diagrams", dev):
        a_out = _diagrams_flat(aud["dm"].reshape(B, N_BANDS * K, P, P),
                               aud["n_pts"].reshape(B, N_BANDS * K),
                               cfg.max_edge_length, 96, 8192)
    with span("bank_gather", dev):
        # gathered where the bank lies (a runner's mesh keeps it on its
        # first device), then the rows moved: the bank is not copied whole
        g = {}
        for k in ("h1_b", "h1_d", "h1_m", "h0_d", "h0_m", "feats"):
            leaf = torch.as_tensor(e_bank[k])
            g[k] = leaf[gidx.to(leaf.device)].to(dev, non_blocking=True)
        Wb = g["h1_m"].shape[1]
        if Wb < 96:
            e1 = tuple(torch.nn.functional.pad(g[k], (0, 96 - Wb))
                       for k in ("h1_b", "h1_d", "h1_m"))
            e_ovf = torch.zeros(B, dtype=torch.bool, device=dev)
        else:
            e1 = (g["h1_b"][:, :96], g["h1_d"][:, :96], g["h1_m"][:, :96])
            e_ovf = g["h1_m"][:, 96:].reshape(B, -1).any(dim=1)
    return _comparison_tail(g["h0_d"], g["h0_m"], e1, g["feats"], e_ovf, aud,
                            a_out, aud["wmask"], n_win_e, aud["n_win"],
                            mis_h1, mis_n_win, mis_degen, K, B)


def _comparison_tail(e0d, e0m, e1, e_feats, e_ovf, aud, a_out, kmask,
                     n_win_e, n_pair, mis_h1, mis_n_win, mis_degen, K, B):
    """Wasserstein + window statistics shared by `comparison_program` (EEG
    diagrams computed in the call) and `comparison_from_bank` (gathered)."""
    dev = e0d.device
    _, a0d, a0m = _h0_pack(a_out)
    with span("h0_exact_dp", dev):
        w_h0 = wasserstein_h0_exact(e0d, e0m, a0d, a0m)
    a1 = _h1_pack(a_out)
    # one tiered Sinkhorn call for matched + mismatched pairs
    n_pairs = e1[0].shape[0]
    with span("h1_tiered_sinkhorn", dev):
        w_both = _wass_sinkhorn_tiered(
            *(torch.cat([x, x]) for x in e1),
            torch.cat([a1[0], mis_h1[0]]), torch.cat([a1[1], mis_h1[1]]),
            torch.cat([a1[2], mis_h1[2]]))
    w_h1, w_mis = w_both[:n_pairs], w_both[n_pairs:]
    with span("stats", dev):
        out = _comparison_stats_program(
            w_h0, w_h1, w_mis, e_feats, a_out["features"], kmask,
            aud["n_pts"] < 3, mis_degen, n_win_e, mis_n_win, K)
    a_degen = ((aud["n_pts"] < 3) & aud["wmask"][:, None, :]).any(dim=-1)
    ovf_rec = e_ovf | a_out["overflow"].reshape(B, -1).any(dim=1)
    out.update(tau=aud["tau"], n_pair=torch.clamp(n_pair, max=K),
               a_degen=a_degen, overflow=ovf_rec)
    return out


# ─────────────────────────────────────────────────────────────────────────────
# Output packing — one flat float32 vector per batch
# ─────────────────────────────────────────────────────────────────────────────

_CMP_FIELDS = (("w_h0", N_BANDS), ("w_h1", N_BANDS), ("w_h1_mis", N_BANDS),
               ("corr_r", N_BANDS * 5), ("corr_p", N_BANDS * 5),
               ("tau", N_BANDS), ("n_pair", 1), ("a_degen", N_BANDS),
               ("overflow", 1))


def pack_comparison_outputs(out):
    """comparison_program output dict → (B·77,) float32 vector."""
    return torch.cat([out[k].reshape(-1).to(torch.float32) for k, _ in _CMP_FIELDS])


def unpack_comparison_outputs(flat: np.ndarray, B: int) -> dict:
    """Host-side inverse of pack_comparison_outputs for one batch."""
    out = {}
    off = 0
    for k, width in _CMP_FIELDS:
        n = B * width
        v = flat[off:off + n]
        out[k] = v.reshape(B, width) if width > 1 else v
        off += n
    out["corr_r"] = out["corr_r"].reshape(B, N_BANDS, 5)
    out["corr_p"] = out["corr_p"].reshape(B, N_BANDS, 5)
    out["a_degen"] = out["a_degen"] > 0.5
    out["overflow"] = out["overflow"] > 0.5
    return out


def pack_feature_outputs(agg, diag, ovf, bank_ovf=None):
    """eeg_feature_program outputs → one flat float32 vector per batch."""
    parts = [agg, diag, ovf] + ([] if bank_ovf is None else [bank_ovf])
    return torch.cat([x.reshape(-1).to(torch.float32) for x in parts])


def unpack_feature_outputs(flat: np.ndarray, B: int, has_bank: bool = False):
    """(agg (B,5,2,11,2), diag (B,5,8), ovf (B,) bool[, bank_ovf (B,) bool])
    from the vector."""
    n_agg = B * N_BANDS * 2 * 11 * 2
    n_dg = B * N_BANDS * 8
    agg = flat[:n_agg].reshape(B, N_BANDS, 2, 11, 2)
    diag = flat[n_agg:n_agg + n_dg].reshape(B, N_BANDS, 8)
    off = n_agg + n_dg
    ovf = flat[off:off + B] > 0.5
    if has_bank:
        return agg, diag, ovf, flat[off + B:off + 2 * B] > 0.5
    return agg, diag, ovf


# ─────────────────────────────────────────────────────────────────────────────
# Audio branch
# ─────────────────────────────────────────────────────────────────────────────


def audio_takens_program(audio, n_samples, cfg: PipelineConfig = DEFAULT_CONFIG,
                         n_out_max: int = 5800, n_win_max: int = 90,
                         max_windows: int = 15, n_win_cap=None, device=None):
    """(B, T_audio_pad) padded audio → per-band Takens distance matrices
    (reference scripts/tda_eeg_audio_comparison.py:53-92): resample
    44.1 kHz → 250 Hz, Hilbert envelope, 5-band filter, 1 s windows, even
    subsample to ≤ max_windows (over min(own, n_win_cap) windows when a cap
    is given), τ from the first window, Takens embedding, min-max
    normalization, pairwise distances (padded points > thresh).

    Returns dm (B, 5, K, P, P), n_pts (B, 5, K), wmask (B, K), tau (B, 5),
    n_win (B,), use_idx (B, K), envelope, n_rs."""
    dev = resolve_device(device)
    audio = torch.as_tensor(audio, device=dev, dtype=torch.float32)
    n_samples = torch.as_tensor(n_samples, device=dev).long()
    h, up, down = tsig.design_resample_poly_filter(cfg.fs_eeg, cfg.fs_audio)
    W = device_constant(tsig.resample_poly_matrix, dev, audio.dtype,
                        cfg.fs_eeg, cfg.fs_audio)
    a_rs, n_rs = tsig.resample_poly_device(audio, n_samples, n_out_max, h, up, down, W)
    lp = device_constant(tsig.design_envelope_lowpass, dev, torch.float32, cfg.fs_eeg)
    hb = device_constant(tsig.design_hilbert_fir, dev, torch.float32)
    t_ids = torch.arange(n_out_max, device=dev)
    env = tsig.hilbert_envelope(
        a_rs, lp, hb, mask=(t_ids[None, :] < n_rs[:, None]).to(a_rs.dtype))
    env_b = tsig.bandpass_bank(env, _fir_bank(cfg, dev))           # (B, 5, T)
    win, step = cfg.win_samples, cfg.step_samples
    wins = tsig.sliding_windows(env_b, n_win_max, win, step)       # (B, 5, W, win)
    n_win = torch.clamp((n_rs - win) // step + 1, min=0)
    if n_win_cap is not None:
        n_win = torch.minimum(n_win, torch.as_tensor(n_win_cap, device=dev).long())

    # even subsample: idx = linspace(0, n_win−1, K) in float32, truncated
    # (reference tda_eeg_audio_comparison.py:77-80)
    k = torch.arange(max_windows, device=dev, dtype=torch.float32)
    nw = torch.clamp(n_win.to(torch.float32), min=1.0)[:, None]
    use_all = n_win[:, None] <= max_windows
    idx_lin = (k[None, :] * (nw - 1.0) / (max_windows - 1)).to(torch.int64)
    idx_seq = torch.minimum(k.long()[None, :], n_win[:, None] - 1)
    use_idx = torch.where(use_all, idx_seq, idx_lin).clamp(0, n_win_max - 1)
    kmask = k[None, :] < torch.clamp(n_win, max=max_windows)[:, None]

    sel = wins.gather(2, use_idx[:, None, :, None].expand(-1, N_BANDS, -1, win))
    tau = tsig.autocorr_tau(sel[:, :, 0, :], win // 2)             # (B, 5)
    P = cfg.max_takens_points
    tau_b = tau[:, :, None].expand(sel.shape[:3])
    pts, pmask = tsig.takens_embed(sel, tau_b, cfg.takens_dim,
                                   cfg.takens_subsample, P)
    ptsn = tsig.minmax_normalize_points(pts, pmask)
    dm = tgeo.pairwise_distances(ptsn, pmask, pad_value=cfg.max_edge_length + 1.0)
    n_pts = pmask.sum(dim=-1)
    return dict(dm=dm, n_pts=n_pts, wmask=kmask, tau=tau, n_win=n_win,
                use_idx=use_idx, envelope=env, n_rs=n_rs)


def audio_window_diagrams(dm, n_pts, thresh: float = 2.0, na_max: int = 96,
                          h1_max: int = 96, step_budget: int = 8192):
    """(B, P, P) Takens distance matrices → H0/H1 diagrams + features.
    Windows with < 3 valid points get the reference's degenerate [[0, 0]]
    sentinel diagrams (scripts/utils.py:125-126)."""
    n = dm.shape[-1]
    out = h1_diagrams_routed(dm, n_pts, n=n, thresh=thresh, na_max=na_max,
                             h1_max=h1_max, step_budget=step_budget)
    degenerate = n_pts < 3
    n_comp = (n_pts - out["n_tree"]).to(torch.int32)
    first0 = torch.arange(out["h0_deaths"].shape[-1], device=dm.device)[None, :] == 0
    h0_deaths = torch.where(degenerate[:, None], 0.0, out["h0_deaths"])
    h0_mask = torch.where(degenerate[:, None], first0, out["h0_mask"])
    n_comp = torch.where(degenerate, 0, n_comp)
    f_h0 = diagram_features(torch.zeros_like(h0_deaths), h0_deaths, h0_mask, n_comp)

    first1 = torch.arange(out["births"].shape[-1], device=dm.device)[None, :] == 0
    births = torch.where(degenerate[:, None], 0.0, out["births"])
    deaths = torch.where(degenerate[:, None], 0.0, out["deaths"])
    h1_mask = torch.where(degenerate[:, None], first1, out["mask"])
    fin = h1_mask & torch.isfinite(deaths)
    n_ess1 = torch.where(degenerate, 0, out["n_essential"])
    f_h1 = diagram_features(births, torch.where(fin, deaths, 0.0), fin, n_ess1)
    return dict(h0_deaths=h0_deaths, h0_mask=h0_mask, n_comp=n_comp,
                births=births, deaths=deaths, h1_mask=h1_mask, fin_mask=fin,
                features=torch.stack([f_h0, f_h1], dim=1),
                overflow=out["overflow"])
