"""Synthetic dataset generator shaped like the reference study's data (copy
of the reference package's numpy generator: deterministic in (subject,
utterance, condition), so both packages see identical recordings), plus the
study's batch staging (electrode selection, padding, md5 window sampling).
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..config import PipelineConfig, DEFAULT_CONFIG, GOOD_ELECTRODES

__all__ = ["synth_recording", "synth_dataset_index", "SynthDataset",
           "window_sample_indices", "load_batch"]

# Padded study shapes (max recording ≈ 23 s @ 250 Hz), as in the reference
# runner: 47 × 5800 EEG samples, 24 s of 44.1 kHz audio.
T_EEG_PAD = 5800
T_AUDIO_PAD = 44100 * 24


def _speech_like_audio(rng: np.random.Generator, n: int, fs: int, rate_hz: float) -> np.ndarray:
    """Carrier noise amplitude-modulated at a syllable-like rate."""
    t = np.arange(n) / fs
    am = 1.0 + 0.7 * np.sin(2 * np.pi * rate_hz * t + rng.uniform(0, 2 * np.pi))
    am *= 1.0 + 0.4 * np.sin(2 * np.pi * 0.9 * t + rng.uniform(0, 2 * np.pi))
    am = np.maximum(am, 0.0)
    carrier = rng.standard_normal(n)
    x = am * carrier
    return (x / (np.abs(x).max() + 1e-9)).astype(np.float64)


def synth_recording(subject: int, utterance: int, condition: str,
                    cfg: PipelineConfig = DEFAULT_CONFIG,
                    n_electrodes_raw: int = 65):
    """One synthetic recording: (eeg_raw[65, T_eeg], audio[T_audio], fs_audio)."""
    seed = (subject * 1000003 + utterance * 101 + (0 if condition == "slow" else 1)) & 0x7FFFFFFF
    rng = np.random.default_rng(seed)
    dur = rng.uniform(17.0, 23.0) if condition == "slow" else rng.uniform(10.6, 15.5)
    rate = 3.0 if condition == "slow" else 5.5
    n_audio = int(dur * cfg.fs_audio)
    audio = _speech_like_audio(rng, n_audio, cfg.fs_audio, rate)
    n_eeg = int(round(dur * cfg.fs_eeg))
    t = np.arange(n_eeg) / cfg.fs_eeg
    sources = []
    for f0 in (2.0, 6.0, 10.0, 20.0, 40.0):
        ph = rng.uniform(0, 2 * np.pi, size=(8, 1))
        fr = f0 * (1 + 0.1 * rng.standard_normal((8, 1)))
        sources.append(np.sin(2 * np.pi * fr * t[None, :] + ph))
    S = np.concatenate(sources, axis=0)  # (40, n)
    env_ds = np.interp(np.arange(n_eeg) * cfg.fs_audio / cfg.fs_eeg,
                       np.arange(n_audio), np.abs(audio))
    S *= 1.0 + 0.3 * env_ds[None, :]
    A = rng.standard_normal((n_electrodes_raw, S.shape[0])) / np.sqrt(S.shape[0])
    eeg = A @ S + 0.8 * rng.standard_normal((n_electrodes_raw, n_eeg))
    return eeg.astype(np.float64), audio, cfg.fs_audio


def synth_dataset_index(n_subjects: int = 45, n_per_subject_slow: int = 16,
                        n_per_subject_fast: int = 16):
    """List of (filename, subject_id, condition) like bbXX_utYY.mat."""
    index = []
    for s in range(1, n_subjects + 1):
        for u in range(1, n_per_subject_slow + 1):
            index.append((f"bb{s:02d}_ut{u:02d}.mat", f"bb{s:02d}", "slow"))
        for u in range(1, n_per_subject_fast + 1):
            index.append((f"bb{s:02d}_ut{u:02d}.mat", f"bb{s:02d}", "fast"))
    return index


class SynthDataset:
    """Lazy synthetic dataset; `cache=True` keeps generated recordings."""

    def __init__(self, n_subjects: int = 45, n_per_subject: int = 16,
                 cfg: PipelineConfig = DEFAULT_CONFIG, cache: bool = True):
        self.cfg = cfg
        self.index = synth_dataset_index(n_subjects, n_per_subject, n_per_subject)
        self._cache: dict[int, dict] | None = {} if cache else None

    def __len__(self):
        return len(self.index)

    def load(self, i: int):
        if self._cache is not None and i in self._cache:
            return self._cache[i]
        filename, subject, condition = self.index[i]
        ut = int(filename.split("_ut")[1].split(".")[0])
        s = int(subject[2:])
        eeg, audio, fs_audio = synth_recording(s, ut, condition, self.cfg)
        rec = dict(filename=filename, subject=subject, condition=condition,
                   eeg_raw=eeg, audio=audio, fs_audio=fs_audio)
        if self._cache is not None:
            self._cache[i] = rec
        return rec


def window_sample_indices(filename_stem: str, band: str, n_windows: int,
                          max_n: int, sampling: str = "random",
                          seed: int = 42) -> np.ndarray:
    """The reference's deterministic md5-seeded window subsample
    (scripts/tda_eeg_classification_v2.py:394-400)."""
    max_n = min(max_n, n_windows)
    if sampling == "random":
        s = f"{filename_stem}-{band}-{seed}"
        rng_seed = int(hashlib.md5(s.encode()).hexdigest()[:8], 16)
        rng = np.random.default_rng(rng_seed)
        return rng.choice(n_windows, size=max_n, replace=False)
    return np.arange(max_n)


def load_batch(ds, idxs, K: int, cfg: PipelineConfig = DEFAULT_CONFIG,
               t_eeg_pad: int = T_EEG_PAD, t_audio_pad: int = T_AUDIO_PAD):
    """Stage recordings as the study runner does: the 47 good electrodes,
    zero-padded EEG (B, 47, t_eeg_pad) and audio (B, t_audio_pad), true
    lengths, and the features stage's md5 window sample (B, 5, K) with its
    mask.  Returns a dict of numpy arrays."""
    from ..config import BAND_NAMES

    win, step = cfg.win_samples, cfg.step_samples
    B = len(idxs)
    eeg = np.zeros((B, len(GOOD_ELECTRODES), t_eeg_pad), np.float32)
    audio = np.zeros((B, t_audio_pad), np.float32)
    n_e = np.zeros(B, np.int32)
    n_a = np.zeros(B, np.int32)
    use_idx = np.zeros((B, len(BAND_NAMES), K), np.int32)
    use_mask = np.zeros((B, len(BAND_NAMES), K), bool)
    for b, i in enumerate(idxs):
        rec = ds.load(i)
        e = rec["eeg_raw"][list(GOOD_ELECTRODES)]
        n_e[b] = min(e.shape[1], t_eeg_pad)
        eeg[b, :, :n_e[b]] = e[:, :n_e[b]]
        n_a[b] = min(len(rec["audio"]), t_audio_pad)
        audio[b, :n_a[b]] = rec["audio"][:n_a[b]]
        nw = max((int(n_e[b]) - win) // step + 1, 0)
        stem = rec["filename"].replace(".mat", "")
        for bd, band in enumerate(BAND_NAMES):
            sel = window_sample_indices(stem, band, nw, K, cfg.window_sampling,
                                        cfg.window_sample_seed)
            use_idx[b, bd, :len(sel)] = sel
            use_mask[b, bd, :len(sel)] = True
    return dict(eeg=eeg, n_e=n_e, audio=audio, n_a=n_a, use_idx=use_idx,
                use_mask=use_mask)
