"""The exact H1 diagrams a job needs, counted from the job and not from the
program: by the benchmark's own copy of the window sampling, whatever
implements it.

* features: a recording's md5 sample of K windows a band, and (where the
  job also compares) the comparison's paired windows, n = 47 each;
* comparison: each recording's paired EEG windows (n = 47) and its own
  audio's Takens clouds (n <= 124), and the audio clouds of each distinct
  mismatch partner over its own selection;
* control: for each recording it redoes for its lengths, its own EEG
  selection (n = 47) and own audio clouds, and its partner's.

Distinct (recording, band, window) triples are counted once a side; a
cloud of the audio counts at the padded n = 124 of the configuration."""

from __future__ import annotations

from ..reference.study import (BAND_NAMES, K_CMP, md5_window_sample, own_window_idx,
                               paired_window_idx)


def h1_windows(ref, stages) -> dict:
    """{n: number of distinct diagrams} for a job of `stages` over the
    reference study `ref` (lengths only are read)."""
    eeg, aud = set(), set()
    n_rec = len(ref.st["index"])
    if "features" in stages:
        K = ref.feature_K()
        for i in range(n_rec):
            nw = ref.eeg_windows(i)
            if nw == 0:
                continue
            stem = ref.st["index"][i][0].replace(".mat", "")
            for bd, band in enumerate(BAND_NAMES):
                eeg.update((i, bd, int(w)) for w in md5_window_sample(
                    stem, band, nw, K, ref.cfg["window_sample_seed"]))
    if "comparison" in stages:
        partners = set()
        for i in range(n_rec):
            n = min(ref.audio_windows(i), ref.eeg_windows(i))
            idx = paired_window_idx(n)[:min(n, K_CMP)]
            for bd in range(len(BAND_NAMES)):
                eeg.update((i, bd, int(w)) for w in idx)
                aud.update((i, bd, int(w)) for w in idx)
            p = ref.partner(i)
            if p is not None:
                partners.add(p)
        for p in partners:
            n = ref.audio_windows(p)
            for bd in range(len(BAND_NAMES)):
                aud.update((p, bd, int(w)) for w in paired_window_idx(n)[:min(n, K_CMP)])
    if "control" in stages:
        redo = ref.deviants()
        for i in redo + [p for p in (ref.partner(i) for i in redo) if p is not None]:
            n = ref.audio_windows(i)
            for bd in range(len(BAND_NAMES)):
                aud.update((i, bd, int(w)) for w in paired_window_idx(n)[:min(n, K_CMP)])
        own_eeg = {(i, bd, int(w)) for i in redo for bd in range(len(BAND_NAMES))
                   for w in own_window_idx(ref.eeg_windows(i))}
        eeg |= own_eeg
    n_eeg = ref.st["eeg"].shape[1]
    P = -(-(int(ref.cfg["window_sec"] * ref.cfg["fs_eeg"]) - (ref.cfg["takens_dim"] - 1))
          // ref.cfg["takens_subsample"])
    return {n_eeg: len(eeg), P: len(aud)}
