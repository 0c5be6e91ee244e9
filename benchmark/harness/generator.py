"""The benchmark's own synthetic study, made on the card from `--seed`.

A rewrite of the port's `io/device_store.build_synthetic_device` and
`io/synthetic.synth_dataset_index`, kept here so that later changes to the
program cannot change the benchmark's inputs:

* the index: per subject, `n_slow` slow then `n_fast` fast utterances,
  files `bbSS_utUU.mat`;
* each recording's duration and syllable rate from a host generator seeded
  by (subject, utterance, condition), as the reference's generator draws
  them: slow 17-23 s at 3.0 Hz, fast 10.6-15.5 s at 5.5 Hz.  So every seed
  has the same sizes, and the seed changes only the samples;
* the samples from one `torch.Generator` on the card seeded by `--seed`:
  an amplitude-modulated noise carrier as audio (44.1 kHz), five banks of
  eight sines (2, 6, 10, 20, 40 Hz) mixed into the 47 electrodes with
  0.8 x Gaussian noise, the EEG weakly modulated by the audio's envelope.
"""

from __future__ import annotations

import math

import numpy as np
import torch

N_ELECTRODES = 47
SOURCE_HZ = (2.0, 6.0, 10.0, 20.0, 40.0)
SINES_PER_SOURCE = 8


def dataset_index(n_subjects: int, n_slow: int, n_fast: int):
    """[(filename, subject, condition)], subjects 1..n_subjects."""
    index = []
    for s in range(1, n_subjects + 1):
        for u in range(1, n_slow + 1):
            index.append((f"bb{s:02d}_ut{u:02d}.mat", f"bb{s:02d}", "slow"))
        for u in range(1, n_fast + 1):
            index.append((f"bb{s:02d}_ut{u:02d}.mat", f"bb{s:02d}", "fast"))
    return index


def durations_and_rates(index):
    """(seconds, syllable rate in Hz) per recording, float32 arrays; they
    depend on the index alone, never on the seed."""
    durs = np.zeros(len(index), np.float32)
    rates = np.zeros(len(index), np.float32)
    for i, (fn, subj, cond) in enumerate(index):
        utt = int(fn.split("_ut")[1].split(".")[0])
        seed_i = (int(subj[2:]) * 1000003 + utt * 101
                  + (0 if cond == "slow" else 1)) & 0x7FFFFFFF
        r = np.random.default_rng(seed_i)
        durs[i] = r.uniform(17.0, 23.0) if cond == "slow" else r.uniform(10.6, 15.5)
        rates[i] = 3.0 if cond == "slow" else 5.5
    return durs, rates


def _batch(gen, dur_s, rate_hz, t_eeg: int, t_audio: int, fs_eeg: int,
           fs_audio: int):
    """One batch of recordings on the generator's device: (eeg (B, 47,
    t_eeg), audio (B, t_audio), n_e, n_a), zero past each true length."""
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

    n_src = len(SOURCE_HZ) * SINES_PER_SOURCE
    t_e = torch.arange(t_eeg, device=dev, dtype=torch.float32)[None, :] / fs_eeg
    f0 = torch.tensor(SOURCE_HZ, device=dev).repeat_interleave(SINES_PER_SOURCE)
    fr = f0[None, :] * (1 + 0.1 * normal(B, n_src))
    phs = uniform(B, n_src, 1)
    S = torch.sin(two_pi * fr[:, :, None] * t_e[:, None, :] + phs)
    env = modulator(t_e).abs()
    S = S * (1.0 + 0.3 * env / (env.amax(dim=1, keepdim=True) + 1e-9))[:, None, :]
    A = normal(B, N_ELECTRODES, n_src) / math.sqrt(float(n_src))
    eeg = A @ S + 0.8 * normal(B, N_ELECTRODES, t_eeg)
    n_e = torch.round(dur_s * fs_eeg).to(torch.int64)
    eeg = torch.where(torch.arange(t_eeg, device=dev)[None, None, :]
                      < n_e[:, None, None], eeg, 0.0)
    return eeg.float(), audio.float(), n_e, n_a


def make_study(dataset: dict, seed: int, device, batch: int = 48):
    """The study's tensors on `device` from `seed`: dict(eeg (N, 47,
    t_eeg_pad) float32, audio (N, t_audio_pad) float32, ns_e, ns_a (N,)
    int64 numpy, index).  `dataset` is the configuration's "dataset"
    object (subjects, slow, fast, t_eeg_pad, t_audio_pad, fs_eeg,
    fs_audio)."""
    index = dataset_index(dataset["subjects"], dataset["slow"], dataset["fast"])
    durs, rates = durations_and_rates(index)
    N = len(index)
    t_eeg, t_audio = dataset["t_eeg_pad"], dataset["t_audio_pad"]
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    eeg = torch.empty((N, N_ELECTRODES, t_eeg), dtype=torch.float32, device=dev)
    audio = torch.empty((N, t_audio), dtype=torch.float32, device=dev)
    ns_e = torch.empty(N, dtype=torch.int64, device=dev)
    ns_a = torch.empty(N, dtype=torch.int64, device=dev)
    durs_d = torch.as_tensor(durs, device=dev)
    rates_d = torch.as_tensor(rates, device=dev)
    for b0 in range(0, N, batch):
        sl = slice(b0, min(b0 + batch, N))
        eeg[sl], audio[sl], ns_e[sl], ns_a[sl] = _batch(
            gen, durs_d[sl], rates_d[sl], t_eeg, t_audio,
            dataset["fs_eeg"], dataset["fs_audio"])
    return dict(eeg=eeg, audio=audio, ns_e=ns_e.cpu().numpy(),
                ns_a=ns_a.cpu().numpy(), index=index)
