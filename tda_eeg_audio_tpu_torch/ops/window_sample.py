"""The features stage's md5-seeded window sample
(scripts/tda_eeg_classification_v2.py:394-400) over a stage's recordings,
and the bank's paired comparison columns beside it.

`SampleTables` holds a stage's inputs, one row a recording in the stage's
order: the file stem, its window count nw and its paired count n_pair =
min(audio windows, nw); each device gets them uploaded once.
`window_sample(tables, row0, B, K, Kx, device)` is the router: the CPU
takes NumPy's generator (`window_sample_plain` over
`io.synthetic.window_sample_indices`, the specification); a CUDA device
launches `window_sample_cuda` (one launch a call) or raises — no
fallback.  Both give the same integers."""

from __future__ import annotations

import numpy as np
import torch

from ..config import BAND_NAMES
from ..io.synthetic import window_sample_indices
from .window_sample_cuda import N_BANDS, window_sample_cuda

__all__ = ["SampleTables", "window_sample", "window_sample_plain",
           "paired_window_idx"]


def paired_window_idx(n_pair: int, k: int) -> np.ndarray:
    """Host replication of `audio_takens_program`'s paired window selection
    over n_pair = min(n_win_eeg, n_win_audio) windows: the same float32
    arithmetic in the same order, so these indices address exactly the
    windows the device pairs."""
    if n_pair <= k:
        return np.minimum(np.arange(k), max(n_pair - 1, 0))
    return (np.arange(k, dtype=np.float32) * np.float32(n_pair - 1)
            / np.float32(k - 1)).astype(np.int64)


class SampleTables:
    """A features stage's sample inputs: stems (str), nw (window counts)
    and n_pair (paired counts; zeros where no bank column is drawn), one
    row a recording; `sampling` and `seed` as the configuration's
    `window_sampling` and `window_sample_seed`.  `on(device)` is the two
    tables the kernel reads, uploaded once a device: text (n + 5, width)
    uint8, the stems' bytes then the five band suffixes "-{band}-{seed}";
    ints (n + 5, 3) int32, byte length, nw, n_pair."""

    def __init__(self, stems, nw, n_pair=None, sampling: str = "random",
                 seed: int = 42):
        self.stems = list(stems)
        self.nw = np.asarray(nw, np.int64)
        self.n_pair = (np.zeros_like(self.nw) if n_pair is None
                       else np.asarray(n_pair, np.int64))
        self.sampling, self.seed = sampling, seed
        self.nw_max = int(self.nw.max(initial=0))
        self._on = {}

    def on(self, device):
        """(text, ints) on `device`, uploaded at the first call."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev not in self._on:
            raw = [s.encode() for s in self.stems] + \
                [f"-{band}-{self.seed}".encode() for band in BAND_NAMES]
            text = np.array(raw, dtype=bytes)
            text = text.view(np.uint8).reshape(len(raw), text.dtype.itemsize)
            n = len(self.stems)
            ints = np.zeros((len(raw), 3), np.int32)
            ints[:, 0] = [len(s) for s in raw]
            ints[:n, 1] = self.nw
            ints[:n, 2] = self.n_pair
            self._on[dev] = (torch.as_tensor(text, device=dev),
                             torch.as_tensor(ints, device=dev))
        return self._on[dev]


def window_sample_plain(tables: SampleTables, row0: int, B: int, K: int, Kx: int):
    """(use_idx (B, 5, Kx) int64, use_mask (B, 5, Kx) bool) numpy arrays of
    rows [row0, row0 + B): per band NumPy's md5-seeded draw of min(K, nw)
    windows, mask True; columns [K, Kx) the paired comparison windows over
    n_pair, mask False."""
    use_idx = np.zeros((B, N_BANDS, Kx), np.int64)
    use_mask = np.zeros((B, N_BANDS, Kx), bool)
    for b in range(B):
        r = row0 + b
        nw = int(tables.nw[r])
        for bd, band in enumerate(BAND_NAMES):
            sel = window_sample_indices(tables.stems[r], band, nw, min(K, nw),
                                        tables.sampling, tables.seed)
            use_idx[b, bd, :len(sel)] = sel
            use_mask[b, bd, :len(sel)] = True
        if Kx > K:
            use_idx[b, :, K:] = paired_window_idx(int(tables.n_pair[r]), Kx - K)
    return use_idx, use_mask


def window_sample(tables: SampleTables, row0: int, B: int, K: int, Kx: int, device):
    """The sample of rows [row0, row0 + B) as tensors on `device`: NumPy's
    generator on the CPU (`window_sample_plain`), the kernel on a CUDA
    device (`window_sample_cuda`, which raises for any other)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        use_idx, use_mask = window_sample_plain(tables, row0, B, K, Kx)
        return torch.from_numpy(use_idx), torch.from_numpy(use_mask)
    return window_sample_cuda(*tables.on(dev), row0, B, K, Kx,
                              tables.sampling != "random", tables.nw_max)
