"""Real-data ingestion: the reference's .mat directory contract (copy of the
reference package's loader).

Layout (reference README.md:24-39): <root>/slow/*.mat, <root>/fast/*.mat with
keys `subeeg` (EEG, 65 × samples or transposed), `y` (audio), `Fs` (audio
sampling rate).  Semantics of the reference's
notebooks/1_preprocesamiento.ipynb cell 1 `load_eeg_file` and
scripts/utils.py:47-53 `load_audio`:
  * EEG transposed to (electrodes, samples) when needed
  * stereo audio → channel mean
  * fs_eeg derived from the audio's duration (≈ 250 Hz)
The 47 good electrodes of 65 are selected downstream
(config.GOOD_ELECTRODES) by the study runner and the device store.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def load_mat_recording(path: str | Path) -> dict:
    """One recording: eeg_raw (electrodes, samples) and mono audio, both
    float64, with fs_audio and the derived fs_eeg."""
    from scipy.io import loadmat

    mat = loadmat(str(path))
    eeg_all = mat["subeeg"]
    audio = mat["y"]
    fs_audio = int(mat["Fs"][0, 0])
    if eeg_all.shape[0] > eeg_all.shape[1]:
        eeg_all = eeg_all.T
    n_audio = audio.shape[0]
    if audio.ndim > 1:
        audio = audio.mean(axis=1)
    duration = n_audio / fs_audio
    fs_eeg = int(round(eeg_all.shape[1] / duration))
    return dict(eeg_raw=eeg_all.astype(np.float64),
                audio=audio.astype(np.float64),
                fs_audio=fs_audio, fs_eeg=fs_eeg)


class MatDataset:
    """Directory-backed dataset with the `SynthDataset` interface: `index`
    of (filename, subject, condition), subject = the file name's prefix
    before "_", and `load(i)`."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.index = []
        for cond in ("slow", "fast"):
            for f in sorted((self.root / cond).glob("*.mat")):
                subject = f.stem.split("_")[0]
                self.index.append((f.name, subject, cond))

    def __len__(self):
        return len(self.index)

    def load(self, i: int) -> dict:
        filename, subject, condition = self.index[i]
        rec = load_mat_recording(self.root / condition / filename)
        rec.update(filename=filename, subject=subject, condition=condition)
        return rec
