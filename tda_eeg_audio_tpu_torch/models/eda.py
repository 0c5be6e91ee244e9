"""Exploratory data analysis stage (the reference's notebooks/0_eda.ipynb as
structured artifacts): file inventory and subject × condition coverage,
duration statistics, per-band Welch power (on the device), slow-vs-fast RMS
band power, and hierarchical clustering of the subjects on their band-power
profiles (host scipy linkage: a tiny input).
"""

from __future__ import annotations

import csv
import json
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from ..config import FREQ_BANDS, GOOD_ELECTRODES
from ..ops.signal import welch_psd
from ..runtime import resolve_device

BAND_NAMES = list(FREQ_BANDS)


def _trapezoid(y, x):
    """Trapezoidal integral along the last axis, numpy's formula and order
    (`np.trapezoid`, which numpy < 2 lacks)."""
    return (np.diff(x) * (y[..., 1:] + y[..., :-1]) / 2.0).sum(axis=-1)


def _load_eda_batch(dataset, idxs, t_pad, device):
    """(eeg (B, 47, ≤ t_pad) float32 tensor on the device, ns_e (B,), metas)
    for host datasets (`.load(i)`, electrodes selected and padded here) and
    for the device-resident `DeviceStore`, whose batches are already
    electrode-selected and padded."""
    if hasattr(dataset, "batch"):
        eeg, _, ns_e, _, metas = dataset.batch(idxs)
        return eeg[:, :, :t_pad], np.minimum(np.asarray(ns_e), t_pad), metas
    eegs, ns_e, metas = [], [], []
    for i in idxs:
        rec = dataset.load(i)
        eeg = rec["eeg_raw"][list(GOOD_ELECTRODES)]
        e = np.zeros((len(GOOD_ELECTRODES), t_pad), np.float32)
        n_e = min(eeg.shape[1], t_pad)
        e[:, :n_e] = eeg[:, :n_e]
        eegs.append(e)
        ns_e.append(n_e)
        metas.append(rec)
    return (torch.as_tensor(np.stack(eegs), device=device), np.asarray(ns_e),
            metas)


def run_eda(dataset, cfg, results_dir=None, eeg_batch: int = 16,
            t_pad: int = 5800, verbose: bool = True, device=None) -> dict:
    """The EDA pass over a dataset → the eda_summary.json dict; with
    results_dir also eda_summary.json, file_inventory.csv and the EDA
    figures.  The Welch spectra run on `device` (a store's own device; None
    = CUDA for a host dataset)."""
    dev = dataset.device if hasattr(dataset, "batch") else resolve_device(device)
    fs = cfg.fs_eeg
    inventory = []
    coverage = defaultdict(lambda: {"slow": 0, "fast": 0})
    band_power = defaultdict(list)        # (subject, condition) → rows (5,)
    durations = {"slow": [], "fast": []}
    psd_sum = {"slow": None, "fast": None}
    psd_n = {"slow": 0, "fast": 0}
    waveforms: dict[str, np.ndarray] = {}
    freqs = None

    n = len(dataset)
    for b0 in range(0, n, eeg_batch):
        idxs = list(range(b0, min(b0 + eeg_batch, n)))
        eegs, ns_e, metas = _load_eda_batch(dataset, idxs, t_pad, dev)
        # Welch PSD per channel on the device, segments masked by each
        # recording's true length (averaging the zero-padded tail would bias
        # the shorter fast recordings low)
        freqs_t, pxx_t = welch_psd(
            eegs, fs=fs, nperseg=min(fs, t_pad),
            n=torch.as_tensor(ns_e, device=dev)[:, None])
        freqs, pxx = freqs_t.cpu().numpy(), pxx_t.cpu().numpy()   # (B, C, F)
        for bi, rec in enumerate(metas):
            if rec.get("failed"):      # store-staged corrupt files are zeroed
                continue
            subj, cond = rec["subject"], rec["condition"]
            dur = ns_e[bi] / fs
            # channel-mean PSD accumulators + one sample waveform per
            # condition for the EDA figures
            m = pxx[bi].mean(0)
            psd_sum[cond] = m if psd_sum[cond] is None else psd_sum[cond] + m
            psd_n[cond] += 1
            if cond not in waveforms:
                waveforms[cond] = eegs[bi, 0, : ns_e[bi]].cpu().numpy()
            inventory.append(dict(
                filename=rec["filename"], subject=subj, condition=cond,
                n_samples=int(ns_e[bi]), duration_sec=float(dur)))
            coverage[subj][cond] += 1
            durations[cond].append(dur)
            bp = []
            for band in BAND_NAMES:
                lo, hi = FREQ_BANDS[band]
                sel = (freqs >= lo) & (freqs < hi)
                # integrate the PSD over the band, mean over channels
                bp.append(float(_trapezoid(pxx[bi][:, sel], freqs[sel]).mean()))
            band_power[(subj, cond)].append(bp)
        if verbose:
            print(f"  eda: {min(b0 + eeg_batch, n)}/{n}")

    # slow-vs-fast RMS band power comparison (the notebook's RMS cells)
    power_by_cond = {c: [] for c in ("slow", "fast")}
    for (subj, cond), rows in band_power.items():
        power_by_cond[cond].extend(rows)
    band_stats = {}
    for bd, band in enumerate(BAND_NAMES):
        s = np.array([r[bd] for r in power_by_cond["slow"]])
        f = np.array([r[bd] for r in power_by_cond["fast"]])
        band_stats[band] = dict(
            power_slow_mean=float(s.mean()) if len(s) else None,
            power_fast_mean=float(f.mean()) if len(f) else None,
            rms_slow=float(np.sqrt(s.mean())) if len(s) else None,
            rms_fast=float(np.sqrt(f.mean())) if len(f) else None)

    # hierarchical clustering of subjects on mean band-power profiles
    subj_profiles = defaultdict(list)
    for (subj, cond), rows in band_power.items():
        subj_profiles[subj].extend(rows)
    subjects = sorted(subj_profiles)
    cluster_order = subjects
    if len(subjects) >= 3:
        from scipy.cluster.hierarchy import leaves_list, linkage

        M = np.log10(np.stack([np.mean(subj_profiles[s], 0)
                               for s in subjects]) + 1e-20)
        M = (M - M.mean(0)) / (M.std(0) + 1e-12)
        Z = linkage(M, method="ward")
        cluster_order = [subjects[i] for i in leaves_list(Z)]

    out = dict(
        n_recordings=len(inventory),
        n_subjects=len(coverage),
        n_slow=sum(1 for r in inventory if r["condition"] == "slow"),
        n_fast=sum(1 for r in inventory if r["condition"] == "fast"),
        duration_stats={
            c: dict(mean=float(np.mean(d)), min=float(np.min(d)),
                    max=float(np.max(d)))
            for c, d in durations.items() if d},
        coverage={s: dict(v) for s, v in sorted(coverage.items())},
        band_power=band_stats,
        subject_cluster_order=cluster_order,
        inventory=inventory,
    )
    if results_dir:
        results_dir = Path(results_dir)
        results_dir.mkdir(parents=True, exist_ok=True)
        slim = {k: v for k, v in out.items() if k != "inventory"}
        (results_dir / "eda_summary.json").write_text(json.dumps(slim, indent=2))
        with open(results_dir / "file_inventory.csv", "w", newline="") as fh:
            wr = csv.DictWriter(fh, fieldnames=list(inventory[0].keys()))
            wr.writeheader()
            wr.writerows(inventory)
        # EDA figures (reference paper/figures/eda_psd.png, eda_waveforms.png,
        # subject_distribution.png)
        from .study import _figures_module
        figures = _figures_module()
        if figures is None:
            return out
        if all(psd_n[c] for c in ("slow", "fast")):
            curves = {"freqs": freqs,
                      "slow": psd_sum["slow"] / psd_n["slow"],
                      "fast": psd_sum["fast"] / psd_n["fast"]}
            figures.eda_figures(curves, waveforms, fs, results_dir)
        figures.subject_distribution_figure(inventory, results_dir)
    return out
