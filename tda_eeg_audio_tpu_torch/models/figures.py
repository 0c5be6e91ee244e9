"""Figure generation: the reference's figure artifacts from computed results
(copy of the reference package's plotting layer):
  * confusion matrix / feature importance / statistical tests
    (reference scripts/classification_rerun.py:196-316)
  * Wasserstein comparison + temporal correlation
    (reference scripts/tda_eeg_audio_comparison.py:240-305)
  * sample persistence diagrams, subject distribution, filter response,
    EDA PSD/waveforms (reference paper/figures/*, notebooks 0-1)

All plotting is host-side matplotlib on tiny summary arrays the device
pipeline already produced; nothing here touches the hot path.  Only
`models/study._figures_module` imports this module, so a host without
matplotlib runs every stage and skips the figures.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from matplotlib.patches import Patch  # noqa: E402

from ..config import FREQ_BANDS

BAND_NAMES = list(FREQ_BANDS)
BAND_COLORS = {"delta": "#2196F3", "theta": "#009688", "alpha": "#4CAF50",
               "beta": "#FF9800", "gamma": "#F44336"}
SLOW_C, FAST_C = "#4ECDC4", "#FF6B6B"


def _dirs(out_dir, fig_dir):
    out_dir = Path(out_dir)
    fig_dir = Path(fig_dir) if fig_dir else out_dir / "figures"
    out_dir.mkdir(parents=True, exist_ok=True)
    fig_dir.mkdir(parents=True, exist_ok=True)
    return out_dir, fig_dir


def _sig_level(p):
    if p < 0.001:
        return "*** (p < 0.001)"
    if p < 0.01:
        return "** (p < 0.01)"
    if p < 0.05:
        return "* (p < 0.05)"
    return "ns"


def _save(fig, *paths):
    for p in paths:
        fig.savefig(p, dpi=200, bbox_inches="tight")
    plt.close(fig)


def classification_figures(res: dict, null_scores, boot_scores,
                           out_dir, fig_dir=None) -> list[str]:
    """Confusion matrix, feature importance, permutation/bootstrap figures
    (reference classification_rerun.py:196-316)."""
    out_dir, fig_dir = _dirs(out_dir, fig_dir)
    written = []

    # ── confusion matrix ──
    cm = np.asarray(res["confusion_matrix"])
    fig, ax = plt.subplots(figsize=(7, 6))
    im = ax.imshow(cm, cmap="Blues")
    for (r, c), v in np.ndenumerate(cm):
        ax.text(c, r, f"{v:d}", ha="center", va="center", fontsize=18,
                color="white" if v > cm.max() / 2 else "black")
    ax.set_xticks([0, 1], ["Slow", "Fast"])
    ax.set_yticks([0, 1], ["Slow", "Fast"])
    ax.set_xlabel("Predicted", fontsize=13, fontweight="bold")
    ax.set_ylabel("Actual", fontsize=13, fontweight="bold")
    ax.set_title("Cross-Validated Confusion Matrix", fontsize=14,
                 fontweight="bold")
    fig.colorbar(im, ax=ax, shrink=0.8)
    txt = (f"Accuracy: {res['cv_accuracy_mean']:.1%}\n"
           f"F1: {res['f1_score']:.3f}\nAUC: {res['roc_auc']:.3f}")
    ax.text(1.35, 0.5, txt, transform=ax.transAxes, fontsize=12,
            va="center", bbox=dict(boxstyle="round", facecolor="wheat",
                                   alpha=0.8))
    fig.tight_layout()
    _save(fig, out_dir / "confusion_matrix_v2.png",
          fig_dir / "fig_confusion_matrix.png")
    written += ["confusion_matrix_v2.png", "fig_confusion_matrix.png"]

    # ── feature importance: top-15 + per-band totals ──
    top = res["top_features"][:15]
    fig, axes = plt.subplots(1, 2, figsize=(15, 6))
    ax1 = axes[0]
    colors = ["#1f77b4" if "_h0_" in t["feature"] else "#ff7f0e" for t in top]
    ax1.barh(range(len(top)), [t["importance"] for t in top], color=colors,
             alpha=0.8)
    ax1.set_yticks(range(len(top)), [t["feature"] for t in top], fontsize=9)
    ax1.set_xlabel("Importance")
    ax1.set_title("Top 15 Features", fontsize=14, fontweight="bold")
    ax1.invert_yaxis()
    ax1.legend(handles=[Patch(facecolor="#1f77b4", alpha=0.8,
                              label="H0 (components)"),
                        Patch(facecolor="#ff7f0e", alpha=0.8,
                              label="H1 (cycles)")], loc="lower right")
    ax2 = axes[1]
    band_imp = {b: v["importance"] for b, v in res["band_importance"].items()}
    total = max(sum(band_imp.values()), 1e-30)
    items = sorted(band_imp.items(), key=lambda kv: kv[1])
    ax2.barh([b for b, _ in items], [v for _, v in items],
             color=[BAND_COLORS.get(b, "#666666") for b, _ in items],
             alpha=0.85)
    for i, (b, v) in enumerate(items):
        ax2.text(v + 0.005, i, f"{v / total * 100:.1f}%", va="center",
                 fontsize=11)
    ax2.set_xlabel("Total Importance")
    ax2.set_title("Feature Importance by Frequency Band", fontsize=14,
                  fontweight="bold")
    fig.tight_layout()
    _save(fig, out_dir / "feature_importance_v2.png",
          fig_dir / "fig_feature_importance.png")
    written += ["feature_importance_v2.png", "fig_feature_importance.png"]

    # ── permutation null + bootstrap CI ──
    obs = res["cv_accuracy_mean"]
    null = np.asarray(null_scores, float)
    boots = np.asarray(boot_scores, float)
    fig, axes = plt.subplots(1, 2, figsize=(15, 6))
    ax1 = axes[0]
    ax1.hist(null, bins=50, alpha=0.7, color="gray", edgecolor="black",
             density=True, label=f"Null distribution (n={len(null)})")
    ax1.axvline(obs, color="red", linewidth=3, linestyle="--",
                label=f"Observed ({obs:.1%})")
    ax1.axvline(null.mean(), color="blue", linewidth=2, linestyle=":",
                label=f"Null mean ({null.mean():.1%})")
    ax1.axvline(0.5, color="green", linewidth=2, linestyle="-.",
                label="Chance (50%)")
    ax1.set_xlabel("Cross-Validation Accuracy", fontweight="bold")
    ax1.set_ylabel("Density", fontweight="bold")
    ax1.set_title("Permutation Test", fontsize=14, fontweight="bold")
    ax1.legend(loc="upper left", fontsize=10)
    ax1.grid(True, alpha=0.3)
    ax1.text(0.97, 0.97,
             f"p = {res['p_value']:.4f}\n"
             f"Cohen's d = {res['effect_size_cohens_d']:.2f}\n"
             f"{_sig_level(res['p_value'])}",
             transform=ax1.transAxes, fontsize=11, va="top", ha="right",
             bbox=dict(boxstyle="round", facecolor="wheat", alpha=0.9))
    ax2 = axes[1]
    lo, hi = res["ci_lower_bootstrap"], res["ci_upper_bootstrap"]
    ax2.hist(boots, bins=50, alpha=0.7, color="steelblue", edgecolor="black",
             density=True, label=f"Bootstrap distribution (n={len(boots)})")
    ax2.axvline(obs, color="red", linewidth=3, linestyle="--",
                label=f"Observed ({obs:.1%})")
    ax2.axvline(lo, color="orange", linewidth=2, linestyle=":")
    ax2.axvline(hi, color="orange", linewidth=2, linestyle=":",
                label=f"95% CI: [{lo:.1%}, {hi:.1%}]")
    ax2.axvspan(lo, hi, alpha=0.2, color="orange")
    ax2.axvline(0.5, color="green", linewidth=2, linestyle="-.",
                label="Chance (50%)")
    ax2.set_xlabel("Cross-Validation Accuracy", fontweight="bold")
    ax2.set_ylabel("Density", fontweight="bold")
    ax2.set_title("Bootstrap 95% Confidence Interval", fontsize=14,
                  fontweight="bold")
    ax2.legend(loc="upper left", fontsize=10)
    ax2.grid(True, alpha=0.3)
    fig.tight_layout()
    _save(fig, out_dir / "statistical_tests_v2.png")
    written.append("statistical_tests_v2.png")
    return written


def comparison_figures(rows: list[dict], band_results: dict,
                       out_dir, fig_dir=None) -> list[str]:
    """Per-band W_H1 boxplots + band summary + temporal correlation
    (reference tda_eeg_audio_comparison.py:240-305)."""
    out_dir, fig_dir = _dirs(out_dir, fig_dir)
    written = []

    # subject×condition mean W_H1 per band
    def subj_means(band, cond):
        per = {}
        for r in rows:
            if r["band"] == band and r["condition"] == cond and \
                    np.isfinite(r["wasserstein_h1"]):
                per.setdefault(r["subject"], []).append(r["wasserstein_h1"])
        return np.array([np.mean(v) for v in per.values()])

    fig, axes = plt.subplots(2, 3, figsize=(18, 12))
    for idx, band in enumerate(BAND_NAMES):
        ax = axes[idx // 3, idx % 3]
        sv, fv = subj_means(band, "slow"), subj_means(band, "fast")
        if len(sv) and len(fv):
            bp = ax.boxplot([sv, fv], positions=[0, 1], widths=0.6,
                            patch_artist=True, showmeans=True,
                            meanprops=dict(marker="D",
                                           markerfacecolor="red",
                                           markersize=6))
            bp["boxes"][0].set_facecolor(SLOW_C)
            bp["boxes"][1].set_facecolor(FAST_C)
        pf = band_results.get(band, {}).get("wass_h1_p_fdr", 1.0)
        sig = ("***" if pf < 0.001 else
               "**" if pf < 0.01 else "*" if pf < 0.05 else "ns")
        ax.set_title(f"{band.upper()} (p_fdr={pf:.3f}) {sig}", fontsize=12,
                     fontweight="bold")
        ax.set_xticks([0, 1], ["Slow", "Fast"])
        ax.set_ylabel("Wasserstein H1")
        ax.grid(True, alpha=0.3)
    ax = axes[1, 2]
    sl = [band_results.get(b, {}).get("wass_h1_slow", 0) for b in BAND_NAMES]
    ft = [band_results.get(b, {}).get("wass_h1_fast", 0) for b in BAND_NAMES]
    x = np.arange(len(BAND_NAMES))
    ax.bar(x - 0.175, sl, 0.35, label="Slow", color=SLOW_C, alpha=0.8)
    ax.bar(x + 0.175, ft, 0.35, label="Fast", color=FAST_C, alpha=0.8)
    ax.set_xticks(x, [b.capitalize() for b in BAND_NAMES])
    ax.set_ylabel("Mean Wasserstein H1")
    ax.set_title("Summary by Band", fontsize=12, fontweight="bold")
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.suptitle("EEG-Audio Topological Comparison (Wasserstein H1)\n"
                 "Lower = brain topology more similar to audio topology",
                 fontsize=14, fontweight="bold", y=1.02)
    fig.tight_layout()
    _save(fig, out_dir / "eeg_audio_tda_comparison.png",
          fig_dir / "fig_wasserstein_comparison.png")
    written += ["eeg_audio_tda_comparison.png", "fig_wasserstein_comparison.png"]

    # temporal correlation figure
    fig, axes = plt.subplots(1, 2, figsize=(14, 6))
    for idx, feat in enumerate(["corr_mean_persistence_r",
                                "corr_persistence_entropy_r"]):
        ax = axes[idx]
        label = (feat.replace("corr_", "").replace("_r", "")
                 .replace("_", " ").title())
        for band in BAND_NAMES:
            bs = [r[feat] for r in rows
                  if r["band"] == band and r["condition"] == "slow"
                  and feat in r]
            bf = [r[feat] for r in rows
                  if r["band"] == band and r["condition"] == "fast"
                  and feat in r]
            if not bs or not bf:
                continue
            ms, mf = np.mean(bs), np.mean(bf)
            ax.scatter([band], [ms], color=SLOW_C, s=100, zorder=5)
            ax.scatter([band], [mf], color=FAST_C, s=100, zorder=5)
            ax.plot([band, band], [ms, mf], "k-", alpha=0.3)
        ax.axhline(0, color="grey", ls="--", alpha=0.5)
        ax.set_ylabel("Spearman r (EEG-Audio)")
        ax.set_title(f"Temporal Correlation: {label}", fontsize=12,
                     fontweight="bold")
        ax.grid(True, alpha=0.3)
    fig.suptitle("EEG-Audio TDA Feature Temporal Correlation", fontsize=14,
                 fontweight="bold")
    fig.tight_layout()
    _save(fig, out_dir / "eeg_audio_tda_temporal_correlation.png",
          fig_dir / "fig_temporal_correlation.png")
    written += ["eeg_audio_tda_temporal_correlation.png",
                "fig_temporal_correlation.png"]
    return written


def persistence_figures(eeg_dgms: dict, audio_dgms: dict,
                        out_dir, fig_dir=None) -> list[str]:
    """Sample persistence diagrams: per-band EEG H0/H1 + EEG-vs-audio H1
    (reference paper/figures/fig_persistence_diagrams.png,
    fig_sample_persistence.png, persistence_diagrams_comparison.png).

    eeg_dgms/audio_dgms: band → {"h0": (n, 2), "h1": (m, 2)} finite bars of
    one sample window.
    """
    out_dir, fig_dir = _dirs(out_dir, fig_dir)

    def plot_dgm(ax, dgms, title):
        hi = 0.0
        for dim, (pts, color) in enumerate(
                [(dgms["h0"], "#1f77b4"), (dgms["h1"], "#ff7f0e")]):
            pts = np.asarray(pts).reshape(-1, 2)
            if len(pts):
                ax.scatter(pts[:, 0], pts[:, 1], s=18, color=color,
                           alpha=0.8, label=f"H{dim}")
                hi = max(hi, float(pts.max()))
        hi = hi * 1.1 + 1e-6
        ax.plot([0, hi], [0, hi], "k--", alpha=0.4)
        ax.set_xlim(-0.02 * hi, hi)
        ax.set_ylim(-0.02 * hi, hi)
        ax.set_xlabel("Birth")
        ax.set_ylabel("Death")
        ax.set_title(title, fontsize=11, fontweight="bold")
        ax.legend(fontsize=8)
        ax.grid(True, alpha=0.3)

    fig, axes = plt.subplots(2, 3, figsize=(16, 10))
    for idx, band in enumerate(BAND_NAMES):
        plot_dgm(axes[idx // 3, idx % 3], eeg_dgms[band],
                 f"EEG {band.upper()}")
    axes[1, 2].axis("off")
    fig.suptitle("Sample EEG Persistence Diagrams (one window per band)",
                 fontsize=14, fontweight="bold")
    fig.tight_layout()
    _save(fig, fig_dir / "fig_persistence_diagrams.png",
          fig_dir / "fig_sample_persistence.png")

    fig, axes = plt.subplots(2, len(BAND_NAMES), figsize=(20, 8))
    for idx, band in enumerate(BAND_NAMES):
        plot_dgm(axes[0, idx], eeg_dgms[band], f"EEG {band.upper()}")
        plot_dgm(axes[1, idx], audio_dgms[band], f"Audio {band.upper()}")
    fig.suptitle("EEG vs Audio Persistence Diagrams (window-paired)",
                 fontsize=14, fontweight="bold")
    fig.tight_layout()
    _save(fig, out_dir / "persistence_diagrams_comparison.png")
    return ["fig_persistence_diagrams.png", "fig_sample_persistence.png",
            "persistence_diagrams_comparison.png"]


def subject_distribution_figure(inventory: list[dict],
                                out_dir, fig_dir=None) -> list[str]:
    """Recordings per subject×condition (reference
    paper/figures/fig_subject_distribution.png, notebook 0)."""
    out_dir, fig_dir = _dirs(out_dir, fig_dir)
    counts = {}
    for r in inventory:
        counts.setdefault(r["subject"], {"slow": 0, "fast": 0})
        counts[r["subject"]][r["condition"]] += 1
    subjects = sorted(counts)
    sl = [counts[s]["slow"] for s in subjects]
    ft = [counts[s]["fast"] for s in subjects]
    x = np.arange(len(subjects))
    fig, ax = plt.subplots(figsize=(max(10, len(subjects) * 0.3), 5))
    ax.bar(x - 0.2, sl, 0.4, label="Slow", color=SLOW_C, alpha=0.85)
    ax.bar(x + 0.2, ft, 0.4, label="Fast", color=FAST_C, alpha=0.85)
    ax.set_xticks(x, subjects, rotation=90, fontsize=7)
    ax.set_ylabel("Recordings")
    ax.set_title("Recordings per Subject and Condition", fontsize=13,
                 fontweight="bold")
    ax.legend()
    ax.grid(True, axis="y", alpha=0.3)
    fig.tight_layout()
    _save(fig, out_dir / "subject_distribution.png",
          fig_dir / "fig_subject_distribution.png")
    return ["subject_distribution.png", "fig_subject_distribution.png"]


def filter_response_figure(cfg, out_dir, fig_dir=None) -> list[str]:
    """|H(f)| of the 5-band filter bank vs the Butterworth filtfilt target
    and the -3 dB band edges (reference notebook 1 cell 2 sanity figure,
    paper/figures/filter_response.png)."""
    from scipy import signal as sps
    from ..ops.signal import design_band_fir_bank

    out_dir, fig_dir = _dirs(out_dir, fig_dir)
    bank = np.asarray(design_band_fir_bank(cfg.fs_eeg, cfg.filter_order,
                                           cfg.fir_numtaps))
    fig, ax = plt.subplots(figsize=(12, 6))
    nfft = 1 << 14
    freqs = np.fft.rfftfreq(nfft, 1.0 / cfg.fs_eeg)
    for bd, band in enumerate(BAND_NAMES):
        lo, hi = FREQ_BANDS[band]
        H = np.abs(np.fft.rfft(bank[bd], nfft))
        ax.plot(freqs, 20 * np.log10(H + 1e-12),
                color=BAND_COLORS[band], label=f"{band} FIR")
        # zero-phase Butterworth target: |H_butter|^2
        b, a = sps.butter(cfg.filter_order, [lo, hi],
                          btype="band", fs=cfg.fs_eeg)
        w, Hb = sps.freqz(b, a, worN=freqs, fs=cfg.fs_eeg)
        ax.plot(freqs, 20 * np.log10(np.abs(Hb) ** 2 + 1e-12), ":",
                color=BAND_COLORS[band], alpha=0.7)
        ax.axvline(lo, color=BAND_COLORS[band], alpha=0.2)
        ax.axvline(hi, color=BAND_COLORS[band], alpha=0.2)
    ax.axhline(-3, color="k", ls="--", alpha=0.5, label="-3 dB")
    ax.set_ylim(-80, 5)
    ax.set_xlim(0, 60)
    ax.set_xlabel("Frequency (Hz)")
    ax.set_ylabel("Magnitude (dB)")
    ax.set_title("Band-pass bank: FIR (solid) vs zero-phase Butterworth "
                 "target (dotted)", fontsize=13, fontweight="bold")
    ax.legend(ncols=3, fontsize=9)
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    _save(fig, fig_dir / "filter_response.png")
    return ["filter_response.png"]


def eda_figures(psd_curves: dict, waveforms: dict, fs: int,
                out_dir, fig_dir=None) -> list[str]:
    """Condition-mean PSD and sample waveforms (reference
    paper/figures/eda_psd.png, eda_waveforms.png; notebook 0).

    psd_curves: {"freqs": (F,), "slow": (F,), "fast": (F,)} channel-mean PSD;
    waveforms: condition → (t, x) sample EEG channel.
    """
    out_dir, fig_dir = _dirs(out_dir, fig_dir)
    freqs = np.asarray(psd_curves["freqs"])
    fig, ax = plt.subplots(figsize=(10, 6))
    for cond, color in (("slow", SLOW_C), ("fast", FAST_C)):
        ax.semilogy(freqs, psd_curves[cond], color=color, label=cond)
    for band in BAND_NAMES:
        lo, hi = FREQ_BANDS[band]
        ax.axvspan(lo, hi, alpha=0.08, color=BAND_COLORS[band])
        ax.text((lo + hi) / 2, ax.get_ylim()[1], band, ha="center",
                va="top", fontsize=8, color=BAND_COLORS[band])
    ax.set_xlim(0, 60)
    ax.set_xlabel("Frequency (Hz)")
    ax.set_ylabel("PSD (V²/Hz)")
    ax.set_title("Channel-mean EEG PSD by Condition (Welch)", fontsize=13,
                 fontweight="bold")
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    _save(fig, fig_dir / "eda_psd.png")

    fig, axes = plt.subplots(len(waveforms), 1,
                             figsize=(12, 3 * len(waveforms)), squeeze=False)
    for ax, (cond, x) in zip(axes[:, 0], sorted(waveforms.items())):
        t = np.arange(len(x)) / fs
        ax.plot(t, x, color=SLOW_C if cond == "slow" else FAST_C,
                linewidth=0.6)
        ax.set_title(f"Sample EEG waveform — {cond}", fontsize=11,
                     fontweight="bold")
        ax.set_xlabel("Time (s)")
        ax.set_ylabel("µV")
        ax.grid(True, alpha=0.3)
    fig.tight_layout()
    _save(fig, fig_dir / "eda_waveforms.png")
    return ["eda_psd.png", "eda_waveforms.png"]
