"""GPU-resident dataset store: every recording is staged into device memory
once, and every stage of the study (features, comparison, control) reads
device slices of it.

Sizing: the full study (1,440 recordings) is 47 × 5,800 float32 EEG
(1.57 GB) plus 24 s of 44.1 kHz float32 audio (6.1 GB).

`build_synthetic_device` generates the synthetic benchmark dataset directly
on the device; `build_from_dataset` stages a host dataset (`.load(i)`
records, e.g. `io.synthetic.SynthDataset`) with per-file failure isolation.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import PipelineConfig, DEFAULT_CONFIG
from ..runtime import resolve_device
from .synthetic import synth_dataset_index

__all__ = ["DeviceStore", "build_synthetic_device", "build_from_dataset"]


class DeviceStore:
    """Device-resident padded dataset.

    eeg:   (N, 47, t_eeg_pad) float32 tensor (good electrodes selected)
    audio: (N, t_audio_pad) float32 tensor
    ns_e, ns_a: (N,) int64 host arrays (true lengths)
    metas: list of {filename, subject, condition, failed}
    index: list of (filename, subject, condition), the dataset's index
    """

    def __init__(self, eeg, audio, ns_e, ns_a, metas, index=None):
        self.eeg = eeg
        self.audio = audio
        self.ns_e = np.asarray(ns_e, np.int64)
        self.ns_a = np.asarray(ns_a, np.int64)
        self.metas = metas
        self.index = index if index is not None else [
            (m["filename"], m["subject"], m["condition"]) for m in metas]

    def __len__(self):
        return self.eeg.shape[0]

    @property
    def device(self):
        return self.eeg.device

    def batch(self, idxs, pad_to: int | None = None):
        """Device-sliced batch (eeg, audio, ns_e, ns_a, metas); rows beyond
        len(idxs) are zeroed padding recordings of 250 EEG / 44100 audio
        samples (one empty second, masked downstream).  A contiguous run of
        recordings is taken by a slice; other indices are uploaded, a copy
        the host waits for."""
        B = len(idxs)
        P = max(pad_to or B, B)
        ii = np.asarray(idxs, np.int64)
        if B and (np.diff(ii) == 1).all():
            take = slice(int(ii[0]), int(ii[0]) + B)
        else:
            take = torch.as_tensor(ii, device=self.device)
        eeg = self.eeg.new_zeros((P,) + tuple(self.eeg.shape[1:]))
        audio = self.audio.new_zeros((P, self.audio.shape[1]))
        eeg[:B] = self.eeg[take]
        audio[:B] = self.audio[take]
        ns_e = np.full(P, 250, np.int64)
        ns_a = np.full(P, 44100, np.int64)
        ns_e[:B] = self.ns_e[idxs]
        ns_a[:B] = self.ns_a[idxs]
        return eeg, audio, ns_e, ns_a, [self.metas[i] for i in idxs]


def _synth_batch_device(gen, dur_s, rate_hz, n_eeg_ch: int, t_eeg: int,
                        t_audio: int, fs_eeg: int, fs_audio: int):
    """A batch of synthetic recordings made on the generator's device: an
    amplitude-modulated noise carrier as audio, five per-band sine banks
    mixed into the electrodes, the EEG weakly modulated by the audio's
    envelope (the construction of `io.synthetic.synth_recording`, batched).
    Returns (eeg (B, C, t_eeg), audio (B, t_audio), n_e, n_a)."""
    dev = dur_s.device
    B = dur_s.shape[0]
    two_pi = 2 * math.pi

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev) * two_pi

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    ph = uniform(B, 2)
    rate = rate_hz[:, None]

    def modulator(t):
        return ((1.0 + 0.7 * torch.sin(two_pi * rate * t + ph[:, :1]))
                * (1.0 + 0.4 * torch.sin(two_pi * 0.9 * t + ph[:, 1:])))

    t_a = torch.arange(t_audio, device=dev, dtype=torch.float32)[None, :] / fs_audio
    x = modulator(t_a).clamp(min=0.0) * normal(B, t_audio)
    n_a = (dur_s * fs_audio).to(torch.int64)
    x = torch.where(torch.arange(t_audio, device=dev)[None, :] < n_a[:, None], x, 0.0)
    audio = x / (x.abs().amax(dim=1, keepdim=True) + 1e-9)

    t_e = torch.arange(t_eeg, device=dev, dtype=torch.float32)[None, :] / fs_eeg
    f0 = torch.tensor([2.0, 6.0, 10.0, 20.0, 40.0], device=dev).repeat_interleave(8)
    fr = f0[None, :] * (1 + 0.1 * normal(B, 40))
    phs = uniform(B, 40, 1)
    S = torch.sin(two_pi * fr[:, :, None] * t_e[:, None, :] + phs)
    env = modulator(t_e).abs()
    S = S * (1.0 + 0.3 * env / (env.amax(dim=1, keepdim=True) + 1e-9))[:, None, :]
    A = normal(B, n_eeg_ch, 40) / math.sqrt(40.0)
    eeg = A @ S + 0.8 * normal(B, n_eeg_ch, t_eeg)
    n_e = torch.round(dur_s * fs_eeg).to(torch.int64)
    eeg = torch.where(torch.arange(t_eeg, device=dev)[None, None, :]
                      < n_e[:, None, None], eeg, 0.0)
    return eeg.float(), audio.float(), n_e, n_a


def build_synthetic_device(n_subjects: int = 45, n_per_subject: int = 16,
                           cfg: PipelineConfig = DEFAULT_CONFIG,
                           t_eeg_pad: int = 5800,
                           t_audio_pad: int = 44100 * 24,
                           batch: int = 48, seed: int = 42,
                           device=None, verbose: bool = False) -> DeviceStore:
    """Generate the synthetic study dataset directly into device memory.

    The index, and each recording's duration and syllable rate (host RNG
    seeded per subject, utterance and condition), are those of the
    reference's device generator; the samples come from one explicit
    `torch.Generator` seeded with `seed`, so they differ bit for bit from
    the reference's (its random streams cannot be reproduced here) while
    the construction and the statistics are the same.  Where two packages
    must see identical recordings, stage a host dataset with
    `build_from_dataset` instead."""
    dev = resolve_device(device)
    index = synth_dataset_index(n_subjects, n_per_subject, n_per_subject)
    N = len(index)
    durs = np.zeros(N, np.float32)
    rates = np.zeros(N, np.float32)
    for i, (fn, subj, cond) in enumerate(index):
        seed_i = (int(subj[2:]) * 1000003
                  + int(fn.split("_ut")[1].split(".")[0]) * 101
                  + (0 if cond == "slow" else 1)) & 0x7FFFFFFF
        r = np.random.default_rng(seed_i)
        durs[i] = r.uniform(17.0, 23.0) if cond == "slow" \
            else r.uniform(10.6, 15.5)
        rates[i] = 3.0 if cond == "slow" else 5.5
    gen = torch.Generator(device=dev).manual_seed(seed)
    eeg = torch.zeros((N, 47, t_eeg_pad), dtype=torch.float32, device=dev)
    audio = torch.zeros((N, t_audio_pad), dtype=torch.float32, device=dev)
    ns_e = np.zeros(N, np.int64)
    ns_a = np.zeros(N, np.int64)
    for b0 in range(0, N, batch):
        sl = slice(b0, min(b0 + batch, N))
        e, a, ne, na = _synth_batch_device(
            gen, torch.as_tensor(durs[sl], device=dev),
            torch.as_tensor(rates[sl], device=dev), n_eeg_ch=47,
            t_eeg=t_eeg_pad, t_audio=t_audio_pad, fs_eeg=cfg.fs_eeg,
            fs_audio=cfg.fs_audio)
        eeg[sl], audio[sl] = e, a
        ns_e[sl], ns_a[sl] = ne.cpu().numpy(), na.cpu().numpy()
        if verbose and b0 % (batch * 10) == 0:
            print(f"  device synth {b0}/{N}")
    metas = [dict(filename=fn, subject=subj, condition=cond, failed=False)
             for fn, subj, cond in index]
    return DeviceStore(eeg, audio, ns_e, ns_a, metas, index)


def build_from_dataset(ds, good_electrodes, t_eeg_pad: int = 5800,
                       t_audio_pad: int = 44100 * 24, device=None,
                       verbose: bool = False) -> DeviceStore:
    """Stage a host dataset into device memory once.

    A recording that fails to load is isolated: it becomes a zeroed
    recording of 250 / 44100 samples with `failed=True` and the error in its
    meta, and every stage of the runner drops it."""
    dev = resolve_device(device)
    N = len(ds)
    eeg_h = np.zeros((N, len(good_electrodes), t_eeg_pad), np.float32)
    audio_h = np.zeros((N, t_audio_pad), np.float32)
    ns_e = np.zeros(N, np.int64)
    ns_a = np.zeros(N, np.int64)
    metas = []
    for i in range(N):
        try:
            rec = ds.load(i)
            e = rec["eeg_raw"][list(good_electrodes)]
            n_e = min(e.shape[1], t_eeg_pad)
            n_a = min(len(rec["audio"]), t_audio_pad)
            eeg_h[i, :, :n_e] = e[:, :n_e]
            audio_h[i, :n_a] = rec["audio"][:n_a]
            ns_e[i], ns_a[i] = n_e, n_a
            metas.append(dict(filename=rec["filename"], subject=rec["subject"],
                              condition=rec["condition"], failed=False))
        except Exception as exc:  # noqa: BLE001 — per-file isolation
            fn, subj, cond = ds.index[i]
            eeg_h[i], audio_h[i] = 0.0, 0.0
            ns_e[i], ns_a[i] = 250, 44100
            metas.append(dict(filename=fn, subject=subj, condition=cond,
                              failed=True, error=repr(exc)))
        if verbose and i % 200 == 0:
            print(f"  stage {i}/{N}")
    return DeviceStore(torch.as_tensor(eeg_h, device=dev),
                       torch.as_tensor(audio_h, device=dev), ns_e, ns_a, metas,
                       list(ds.index))
