"""The study runner: drives the batched programs of `models/programs.py`
over a dataset into the study's analyses and writes the artifacts in the
reference's JSON/CSV schemas.

  * `compute_feature_dataset` — X (N, 220), y, subjects, filenames, metadata
  * `run_classification` — slow vs fast → results_summary.json,
    feature_importance_ranked.csv (host scikit-learn, `models/classify.py`)
  * `run_comparison` — EEG↔audio comparison → eeg_audio_tda_comparison.json,
    eeg_audio_tda_detailed.csv
  * `run_control` — matched vs mismatched control → matched_vs_mismatched.json
  * `write_preprocessed` / `write_graphs` — the preprocessed/ and graphs/
    artifacts; `write_sample_figures` — sample diagrams, filter response

Backends.  With `backend` "auto" or "device" (the main path) every
window-level computation runs on the runner's device (the store's) in the
fused programs, and each stage reads its results back once, after its
batch loop; recordings whose reduction overflowed (creator arena, step
budget, bar count) are redone exactly through `homology_exec.run_tda`,
whose flagged windows go to the host engine.  With `backend="host"` the staged parity path runs instead: the
distances on the device, every diagram on the host engine, no bank.  With
`wasserstein_backend="host_exact"` the comparison and the control take the
staged path and match diagrams exactly on the host (persim's assignment,
`native.engine.wasserstein_batch`); "sinkhorn" is the fused on-device path.

Data parallelism (`mesh`): the fused features program and the fused
comparison pass split every batch of `eeg_batch` recordings into dp
contiguous slices, one a shard's device, as the reference's runner shards
the batch axis over its device mesh.  Every shard's programs are issued
before the stage reads anything back, and the outputs are gathered on the
first device in shard order; the features stage's diagram bank is gathered
there too.  The control's redo and the staged path run on the first device.

Figures need matplotlib on the host; without it they are skipped with a
logged `figures_skipped` event and every other artifact is written.
"""

from __future__ import annotations

import csv
import json
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from .. import tuning
from ..config import (PipelineConfig, DEFAULT_CONFIG, BAND_NAMES, FREQ_BANDS,
                      GOOD_ELECTRODES)
from ..io.device_store import DeviceStore
from ..ops import stats as tstats
from ..ops.features import aggregate_mean_std
from ..ops.signal import resample_n_out
from ..ops.wasserstein import sinkhorn_cost_pairs, wasserstein_h0_exact
from ..ops.window_sample import SampleTables, window_sample
from ..ops.window_sample import paired_window_idx as _paired_window_idx  # noqa: F401
from ..runtime import (host_waits, logged_span, process_rank_world, resolve_device,
                       span, to_device)
from ..utils import logging as tlog
from ..utils.validation import issues_from_diagnostics, matrix_diagnostics
from . import classify, homology_exec, programs
from .classify import features_to_row

BAND_NAMES = list(BAND_NAMES)
N_BANDS = len(BAND_NAMES)

K_CMP = 15          # windows per recording and band in the comparisons
K_H0_EEG = 64       # H0 diagram padding of the staged path: EEG ≤ 46 bars
K_H0_AUD = 128      # audio ≤ 123 bars
K_H1 = 128          # H1 diagram padding of the staged path, both sides
FEATS = ("mean_persistence", "total_persistence", "persistence_entropy",
         "max_persistence", "n_features")
# their columns among the 11 diagram features
FEAT_COLS = {"mean_persistence": 6, "total_persistence": 9,
             "persistence_entropy": 10, "max_persistence": 8, "n_features": 0}
WASSERSTEIN_BACKENDS = ("sinkhorn", "host_exact")


def _figures_module():
    """Figures are optional: matplotlib may be absent on a compute host.
    Every JSON / CSV result is written regardless; the figures are skipped
    with a message and a logged `figures_skipped` event."""
    try:
        from . import figures
        return figures
    except ImportError as e:
        print(f"  figures skipped (matplotlib unavailable: {e})")
        tlog.LOGGER.event("figures_skipped", error=repr(e))
        return None


def _indexed(dev: torch.device) -> torch.device:
    """A CUDA device with its index (the current card for a bare "cuda")."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _ref_linspace_idx(n_win: int, k: int) -> np.ndarray:
    """The reference's even window subsample, np.linspace(0, n − 1, k,
    dtype=int): each side's own selection in the control."""
    if n_win > k:
        return np.linspace(0, n_win - 1, k).astype(np.int64)
    return np.arange(max(n_win, 0), dtype=np.int64)


class StudyRunner:
    """Runs the study over a device-resident `io.device_store.DeviceStore`
    (a host dataset is staged into one by `build_from_dataset`).  `backend`
    (None = cfg.homology_backend): "auto" / "device" take the fused device
    programs, "host" the staged path with every diagram on the host engine.
    `eeg_batch`, `eeg_bank` and `feature_na_max` left at None take the
    measured values of `tuning.py`.

    `mesh`: "auto" (every visible CUDA card, the runner's first, when the
    fused programs run on a card, there are several and this process is not
    one of a multi-process group; off otherwise), None (off), or a sequence
    of devices, the data-parallel shards in order (repeats allowed; the
    first is the runner's device).  Under a mesh `eeg_batch` rounds up to a
    multiple of dp and shard s takes the slice [s·b, (s+1)·b) of every
    batch, b = eeg_batch / dp.  A shard whose device is not there raises."""

    def __init__(self, store: DeviceStore, cfg: PipelineConfig = DEFAULT_CONFIG,
                 eeg_batch: int | None = None,
                 results_dir: str | Path | None = None,
                 verbose: bool = True, eeg_bank: bool | None = None,
                 feature_na_max: int | None = None, t_eeg_pad: int = 5800,
                 t_audio_pad: int = 44100 * 24, n_rs_max: int = 5900,
                 device=None, backend: str | None = None, mesh="auto"):
        if not isinstance(store, DeviceStore):
            raise TypeError(f"StudyRunner takes a DeviceStore, not "
                            f"{type(store).__name__}: stage a host dataset with "
                            "io.device_store.build_from_dataset")
        if cfg.wasserstein_backend not in WASSERSTEIN_BACKENDS:
            raise ValueError(f"wasserstein_backend {cfg.wasserstein_backend!r} "
                             f"not in {WASSERSTEIN_BACKENDS}")
        backend = cfg.homology_backend if backend is None else backend
        if backend not in homology_exec.BACKENDS:
            raise ValueError(f"backend {backend!r} not in {homology_exec.BACKENDS}"
                             " (the port has no Pallas backend)")
        self.store = store
        self.cfg = cfg
        self.backend = backend
        # device-class backends take the fused programs; "host" the staged
        # parity path
        self.on_device = backend in ("auto", "device")
        # None = the measured knob (tuning.py); an explicit value wins
        eeg_batch = tuning.EEG_BATCH if eeg_batch is None else eeg_batch
        eeg_bank = tuning.EEG_BANK if eeg_bank is None else eeg_bank
        if feature_na_max is None:
            feature_na_max = tuning.FEATURE_NA_MAX
        self.eeg_batch = eeg_batch
        self.results_dir = Path(results_dir) if results_dir else None
        self.verbose = verbose
        # eeg_bank: the comparison stage reuses the features stage's
        # per-window EEG diagrams (programs.comparison_from_bank); the bank
        # rides the fused features program, so the staged path has none
        self.use_eeg_bank = bool(eeg_bank) and self.on_device
        self._eeg_bank = None
        # features-stage H1 arena width; windows beyond it overflow into the
        # exact redo, so results never change with it
        self.feature_na_max = feature_na_max
        self.t_eeg_pad = t_eeg_pad
        self.t_audio_pad = t_audio_pad
        self.n_rs_max = n_rs_max
        self.n_win_max = (t_eeg_pad - cfg.win_samples) // cfg.step_samples + 1
        if device is not None and resolve_device(device).type != store.device.type:
            raise ValueError("device differs from the store's")
        self.device = store.device
        if tuple(store.eeg.shape[1:]) != (len(GOOD_ELECTRODES), t_eeg_pad) \
                or store.audio.shape[1] != t_audio_pad:
            raise ValueError("the store's padded shapes differ from the "
                             "runner's t_eeg_pad / t_audio_pad")
        # files that failed to load, isolated by the store
        self.failed_files = [(m["filename"], m.get("error", "load failed"))
                             for m in store.metas if m.get("failed")]
        self._failed_idx = {i for i, m in enumerate(store.metas) if m.get("failed")}
        self.mesh = self._resolve_mesh(mesh)
        if self.mesh is not None:
            dp = len(self.mesh)
            self.eeg_batch = -(-self.eeg_batch // dp) * dp
            if verbose:
                print(f"mesh: dp={dp} over {[str(d) for d in self.mesh]}; "
                      f"eeg_batch={self.eeg_batch}")
        self._fused_cache = None
        self._bank_served = self._bank_fallback = 0
        # what the exact redo did, per stage (recordings), for reports
        self.redo_counts = dict(features=0, comparison=0, control_deviants=0)

    def _resolve_mesh(self, mesh):
        """The shards' devices (see the class), or None.  A mesh whose
        first device is not the store's raises."""
        if mesh is None:
            return None
        if isinstance(mesh, str):
            if mesh != "auto":
                raise ValueError(f"mesh {mesh!r}: 'auto', None or a sequence "
                                 "of devices")
            n = torch.cuda.device_count() if self.device.type == "cuda" else 0
            if not self.on_device or n < 2 or process_rank_world()[1] > 1:
                return None
            first = _indexed(self.device).index
            return [torch.device("cuda", (first + k) % n) for k in range(n)]
        devs = [_indexed(resolve_device(d)) for d in mesh]
        if not devs:
            raise ValueError("an empty mesh")
        for d in devs:
            if d.type == "cuda" and d.index >= torch.cuda.device_count():
                raise RuntimeError(f"mesh device {d} is not available: "
                                   f"{torch.cuda.device_count()} CUDA device(s)")
        if _indexed(self.device) != devs[0]:
            raise ValueError(f"the mesh's first device {devs[0]} is not the "
                             f"runner's device {self.device} (the store's)")
        return devs

    def _shards(self, idxs):
        """(device, recordings, their slice of the batch) of each
        data-parallel shard of a batch: the runner's device and the whole
        batch without a mesh; under one, shard s's contiguous slice
        [s·b, (s+1)·b) of the batch, b = eeg_batch / dp, an empty slice
        skipped."""
        if self.mesh is None:
            yield self.device, idxs, slice(0, len(idxs))
            return
        per = self.eeg_batch // len(self.mesh)
        for s, dev in enumerate(self.mesh):
            sl = slice(s * per, min((s + 1) * per, len(idxs)))
            if sl.start < sl.stop:
                yield dev, idxs[sl], sl

    @property
    def _fused(self) -> bool:
        """The comparison and the control take the fused device pass."""
        return self.on_device and self.cfg.wasserstein_backend == "sinkhorn"

    def _dev(self, a, dtype=None):
        return torch.as_tensor(a, device=self.device, dtype=dtype)

    # ---------------- stage: EEG distance matrices (graphs/) ----------------

    def eeg_distances(self, idxs):
        """(len(idxs), 5, W, 47, 47) distance matrices of every window, the
        window mask (len(idxs), W) and the metas."""
        eeg, _, ns_e, _, metas = self.store.batch(idxs)
        dist, _, wmask = programs.eeg_distance_program(
            eeg, ns_e, self.cfg, self.n_win_max, device=self.device)
        return dist, wmask, metas

    def _batches(self):
        for b0 in range(0, len(self.store), self.eeg_batch):
            yield list(range(b0, min(b0 + self.eeg_batch, len(self.store))))

    # ---------------- stage: preprocessed/ artifacts ----------------

    def write_preprocessed(self, out_dir) -> list[dict]:
        """The reference's preprocessed/ stage
        (notebooks/1_preprocesamiento.ipynb cell 3): per recording directory
        `{condition}/{stem}/`, the banded windows `{band}.npy` (n_win, 47,
        250), `window_times.npy` (window centres, s) and `audio.npy`, plus
        preprocessing_metadata.csv with the reference's columns."""
        out_dir = Path(out_dir)
        cfg = self.cfg
        win, step = cfg.win_samples, cfg.step_samples
        meta_rows = []
        for idxs in self._batches():
            eeg, audio, ns_e, ns_a, metas = self.store.batch(idxs)
            wins, wmask = programs.eeg_window_program(
                eeg, ns_e, cfg, self.n_win_max, device=self.device)
            wins, wmask = wins.cpu().numpy(), wmask.cpu().numpy()
            for bi, m in enumerate(metas):
                d = out_dir / m["condition"] / m["filename"].replace(".mat", "")
                d.mkdir(parents=True, exist_ok=True)
                nw = int(wmask[bi].sum())
                bands_meta = {}
                for bd, band in enumerate(BAND_NAMES):
                    arr = wins[bi, bd, :nw]
                    np.save(d / f"{band}.npy", arr)
                    bands_meta[band] = dict(
                        n_windows=nw, window_shape=tuple(arr.shape),
                        freq_range=tuple(FREQ_BANDS[band]))
                centers = (np.arange(nw) * step + win / 2) / cfg.fs_eeg
                np.save(d / "window_times.npy", centers)
                np.save(d / "audio.npy", audio[bi, :ns_a[bi]].cpu().numpy())
                meta_rows.append(dict(
                    filename=m["filename"], n_electrodes=eeg.shape[1],
                    n_samples=int(ns_e[bi]),
                    duration_sec=float(ns_e[bi] / cfg.fs_eeg),
                    fs_eeg=cfg.fs_eeg, bands=str(bands_meta), n_windows=nw,
                    condition=m["condition"]))
        with open(out_dir / "preprocessing_metadata.csv", "w", newline="") as f:
            wr = csv.DictWriter(f, fieldnames=list(meta_rows[0].keys()))
            wr.writeheader()
            wr.writerows(meta_rows)
        return meta_rows

    # ---------------- stage: graphs/ artifacts ----------------

    def write_graphs(self, out_dir) -> int:
        """The reference's graphs/ stage (notebooks/2_graph_construction.ipynb
        cell 8): per recording directory, `{band}_correlations.npy` and
        `{band}_distances.npy` (n_windows, 47, 47).  Returns the number of
        recordings written."""
        out_dir = Path(out_dir)
        n_files = 0
        for idxs in self._batches():
            eeg, _, ns_e, _, metas = self.store.batch(idxs)
            dist, corr, wmask = programs.eeg_distance_program(
                eeg, ns_e, self.cfg, self.n_win_max, device=self.device)
            dist, corr, wmask = (x.cpu().numpy() for x in (dist, corr, wmask))
            for bi, m in enumerate(metas):
                d = out_dir / m["condition"] / m["filename"].replace(".mat", "")
                d.mkdir(parents=True, exist_ok=True)
                nw = int(wmask[bi].sum())
                for bd, band in enumerate(BAND_NAMES):
                    np.save(d / f"{band}_correlations.npy", corr[bi, bd, :nw])
                    np.save(d / f"{band}_distances.npy", dist[bi, bd, :nw])
                n_files += 1
        return n_files

    # ---------------- stage: classification features ----------------

    def _sample_tables(self, all_idx, counts) -> SampleTables:
        """The md5 window sample's inputs for the stage's recordings, in
        its order: stems, window counts and (bank mode) the paired counts
        min(audio windows, nw) of the comparison's selection, which the
        bank's extra columns hold.  Lives for one features stage."""
        nw = np.array([counts[i] for i in all_idx], np.int64)
        n_pair = (np.minimum(self._audio_window_counts(all_idx), nw)
                  if self.use_eeg_bank else None)
        return SampleTables([self.store.index[i][0].replace(".mat", "") for i in all_idx],
                            nw, n_pair, self.cfg.window_sampling,
                            self.cfg.window_sample_seed)

    def compute_feature_dataset(self, max_windows_per_band=None,
                                batch_start: int | None = None,
                                batch_end: int | None = None):
        """X (N, 220), y, subjects, filenames, metadata — the features stage.

        Window equalization "min" and the md5 window sample are the
        reference's (scripts/tda_eeg_classification_v2.py:445-606).
        batch_start / batch_end slice the ordered file list for job-level
        sharding; the "min" equalization stays global so shards agree.
        Failed and zero-window recordings get no row.  The fused path reads
        the stage back once; the staged path (`backend="host"`) computes the
        distances of every window on the device, selects the sampled ones
        and reduces them on the host engine.  Spans: `features` with
        `features_index`, `features_dispatch` and `features_rows`."""
        with logged_span("features", self.device) as log:
            with span("features_index", self.device):
                all_idx, counts, K, min_windows, skipped_zero = self._feature_index(
                    max_windows_per_band, batch_start, batch_end)
                tables = self._sample_tables(all_idx, counts)
            with span("features_dispatch", self.device):
                pending, bank_batches, bank_slot = self._feature_dispatch(
                    all_idx, K, tables)
            with span("features_rows", self.device):
                X_rows, y, subjects, filenames, file_metadata = self._feature_rows(
                    pending, counts, K, bank_slot, tables)
            if self.use_eeg_bank and bank_batches:
                self._eeg_bank = dict(batches=bank_batches, slot=bank_slot,
                                      K=K + K_CMP, K_base=K, flat=None)
            log.update(items=len(all_idx) * N_BANDS * K, n_recordings=len(X_rows), K=K,
                       n_failed=len(self.failed_files))
        return (np.stack(X_rows), np.array(y), np.array(subjects), filenames,
                dict(min_windows=min_windows, K=K,
                     failed_files=[fn for fn, _ in self.failed_files],
                     skipped_zero_window=skipped_zero,
                     file_metadata=file_metadata))

    def _feature_index(self, max_windows_per_band, batch_start, batch_end):
        """(recordings in the reference's order, {recording: window count},
        K, the least window count, the zero-window files skipped)."""
        cfg = self.cfg
        win, step = cfg.win_samples, cfg.step_samples
        by_name = lambda i: self.store.index[i][0]  # noqa: E731
        # reference order: sorted slow files, then sorted fast files
        all_idx = [i for cond in ("slow", "fast") for i in sorted(
            (i for i in range(len(self.store)) if self.store.index[i][2] == cond),
            key=by_name)]

        counts = {}
        for i in all_idx:
            if i not in self._failed_idx:   # a failed file must not collapse the min
                n_e = min(int(self.store.ns_e[i]), self.t_eeg_pad)
                counts[i] = max((n_e - win) // step + 1, 0)
        skipped_zero = [self.store.index[i][0] for i in all_idx
                        if counts.get(i) == 0]
        for fn_ in skipped_zero:
            tlog.LOGGER.event("zero_window_skipped", file=fn_)
        all_idx = [i for i in all_idx if counts.get(i, 0) > 0]
        if not all_idx:
            raise RuntimeError("no loadable recordings in dataset")
        min_windows = min(counts[i] for i in all_idx)
        if max_windows_per_band is None:
            max_windows_per_band = (min_windows if cfg.equalize_windows
                                    else None)
        K = int(max_windows_per_band or max(counts.values()))
        if batch_start is not None or batch_end is not None:
            all_idx = all_idx[batch_start or 0:batch_end]
        return all_idx, counts, K, min_windows, skipped_zero

    def _feature_dispatch(self, all_idx, K, tables):
        """The batch loop: each batch's programs issued, nothing read back.
        Returns pending [(packed outputs, recordings)], the bank's batches
        and {recording: bank row}.  Spans: `features_window_sample` (the md5
        sample of the batch, or of each shard, on its device: one kernel
        launch on a card) and (inside the program) `eeg_feature_program`,
        each once a batch."""
        cfg = self.cfg
        t0 = time.time()
        with_bank = self.use_eeg_bank
        # bank mode: the comparison's paired windows ride the features
        # program as K_CMP extra mask=False columns, so the bank serves the
        # comparison even where the md5 sample misses a paired window
        Kx = K + K_CMP if with_bank else K
        pending, bank_batches, bank_slot, n_rows = [], [], {}, 0
        for b0 in range(0, len(all_idx), self.eeg_batch):
            idxs = all_idx[b0:b0 + self.eeg_batch]
            if not self.on_device:
                with span("features_window_sample", self.device):
                    use_idx, use_mask = window_sample(tables, b0, len(idxs), K, Kx,
                                                      self.device)
                pending.append((self._staged_features(idxs, use_idx, use_mask),
                                idxs))
                continue
            eeg, _, ns_e, _, _ = self.store.batch(idxs)
            for dev, part, sl in self._shards(idxs):
                with span("features_window_sample", self.device):
                    use_idx, use_mask = window_sample(tables, b0 + sl.start, len(part),
                                                      K, Kx, dev)
                outs = programs.eeg_feature_program(
                    eeg[sl].to(dev, non_blocking=True), ns_e[sl], use_idx,
                    use_mask, cfg, K=Kx, na_max=self.feature_na_max,
                    return_dm0=True, return_bank=with_bank, device=dev)
                if with_bank:
                    bank = outs[3]
                    bank_ovf = bank.pop("ovf")
                    for b, i in enumerate(part):
                        bank_slot[i] = n_rows + b
                    n_rows += len(part)
                    bank_batches.append(bank)
                    packed = programs.pack_feature_outputs(*outs[:3], bank_ovf)
                else:
                    packed = programs.pack_feature_outputs(*outs[:3])
                pending.append((packed, part))
            if self.verbose:
                print(f"  features: {b0 + len(idxs)}/{len(all_idx)} recordings "
                      f"dispatched ({time.time() - t0:.0f}s)")
        return pending, bank_batches, bank_slot

    def _feature_rows(self, pending, counts, K, bank_slot, tables):
        """The stage's one read-back, the exact redo of recordings whose used
        windows overflowed (span `features_overflow_redo`), and the rows:
        (X rows, y, subjects, filenames, file metadata).  Drops from
        `bank_slot` the recordings the bank cannot serve.  `pending` is in
        the stage's order, so a recording's row of `tables` is its offset."""
        cfg = self.cfg
        with_bank = self.use_eeg_bank
        if self.on_device:      # the stage's one read-back
            flat = torch.cat([p.to(self.device, non_blocking=True)
                              for p, _ in pending]).cpu().numpy()
            done, off = [], 0
            for packed, idxs in pending:
                n = packed.shape[0]
                outs_h = programs.unpack_feature_outputs(
                    flat[off:off + n], len(idxs), has_bank=with_bank)
                off += n
                done.append((outs_h[0].copy(), *outs_h[1:3],
                             outs_h[3] if with_bank else None, idxs))
        else:   # the staged path's batches are on the host already
            done = [(*out, None, idxs) for out, idxs in pending]
        with span("features_overflow_redo", self.device):
            row0 = 0
            for agg, _, ovf, _, idxs in done:
                for b, i in enumerate(idxs):
                    if ovf[b]:
                        if self.verbose:
                            print("  features: overflow → exact redo "
                                  f"{self.store.index[i][0]}")
                        tlog.LOGGER.event("feature_overflow_redo",
                                          file=self.store.index[i][0])
                        agg[b] = self._staged_feature_agg([i], tables, row0 + b, K)[0]
                        self.redo_counts["features"] += 1
                row0 += len(idxs)
        X_rows, y, subjects, filenames, file_metadata = [], [], [], [], []
        for agg, diag, _, bank_ovf, idxs in done:
            for b, i in enumerate(idxs):
                if bank_ovf is not None and bank_ovf[b]:
                    # a truncated diagram on ANY column (possibly a union
                    # column outside `ovf`): the row cannot serve the
                    # comparison; the feature aggregate is redone only when
                    # a USED window overflowed
                    bank_slot.pop(i, None)
                X_rows.append(features_to_row(agg[b]))
                fn, subj, cond = self.store.index[i]
                y.append(0 if cond == "slow" else 1)
                subjects.append(subj)
                filenames.append(fn)
                issues = [f"{band}: {x}" for bd, band in enumerate(BAND_NAMES)
                          for x in issues_from_diagnostics(diag[b, bd])]
                nw, used = counts[i], min(K, counts[i])
                file_metadata.append(dict(
                    filename=fn,
                    n_windows={b_: nw for b_ in BAND_NAMES},
                    n_windows_used={b_: used for b_ in BAND_NAMES},
                    validation_issues=issues,
                    window_sampling=cfg.window_sampling,
                    max_windows_per_band=K,
                    n_windows_total=nw * N_BANDS,
                    n_windows_used_total=used * N_BANDS))
        return X_rows, y, subjects, filenames, file_metadata

    def _staged_features(self, idxs, use_idx, use_mask):
        """The staged features path of one batch: the distances of every
        window (`eeg_distance_program`), the sampled (B, 5, K) of them
        reduced by `run_tda` on the runner's backend, and the window-0
        diagnostics from the host.  Returns host (agg (B, 5, 2, 11, 2),
        diag (B, 5, 8), ovf (B,) all False: run_tda leaves no window
        truncated)."""
        B, _, K = use_idx.shape
        dist, _, _ = self.eeg_distances(idxs)
        n = dist.shape[-1]
        sel = dist.gather(2, self._dev(use_idx)[:, :, :, None, None]
                          .expand(-1, -1, -1, n, n))
        tda = homology_exec.run_tda(sel.reshape(B * N_BANDS * K, n, n),
                                    self.cfg.max_edge_length,
                                    verbose=self.verbose, backend=self.backend)
        agg = aggregate_mean_std(tda["features"].reshape(B, N_BANDS, K, 22),
                                 self._dev(use_mask))
        return (agg.reshape(B, N_BANDS, 2, 11, 2).cpu().numpy(),
                matrix_diagnostics(dist[:, :, 0].cpu().numpy()),
                np.zeros(B, bool))

    def _staged_feature_agg(self, idxs, tables, row0, K):
        """(len(idxs), 5, 2, 11, 2) feature aggregate through `run_tda`,
        which redoes overflowed windows on the host engine — for recordings
        whose features-stage reduction overflowed; idxs are the rows
        [row0, row0 + len(idxs)) of the stage's sample tables."""
        B = len(idxs)
        use_idx, use_mask = window_sample(tables, row0, B, K, K, self.device)
        eeg, _, ns_e, _, _ = self.store.batch(idxs)
        dist = programs.eeg_window_distances(eeg, self._dev(ns_e), self._dev(use_idx),
                                             self.cfg)
        n = dist.shape[-1]
        tda = homology_exec.run_tda(dist.reshape(B * N_BANDS * K, n, n),
                                    self.cfg.max_edge_length, na_max=128,
                                    verbose=self.verbose, backend=self.backend)
        agg = aggregate_mean_std(tda["features"].reshape(B, N_BANDS, K, 22),
                                 self._dev(use_mask))
        return agg.reshape(B, N_BANDS, 2, 11, 2).cpu().numpy()

    # ---------------- exact diagrams for the redo paths ----------------

    def _audio_clouds(self, audio, ns_a, n_win_cap=None):
        aud = programs.audio_takens_program(
            audio, ns_a, self.cfg, self.n_rs_max, self.n_win_max, K_CMP,
            n_win_cap=n_win_cap, device=self.device)
        P = self.cfg.max_takens_points
        out = homology_exec.run_tda(
            aud["dm"].reshape(-1, P, P), self.cfg.max_edge_length,
            n_pts=aud["n_pts"].reshape(-1), step_budget=8192,
            verbose=self.verbose, backend=self.backend)
        return aud, out

    def _eeg_clouds(self, eeg, ns_e, use_idx, n_win):
        dist, _, _ = programs._pair_distance_program(
            eeg, self._dev(ns_e), use_idx, n_win, self.cfg, K_CMP,
            self.n_win_max)
        n = dist.shape[-1]
        return homology_exec.run_tda(dist.reshape(-1, n, n),
                                     self.cfg.max_edge_length,
                                     verbose=self.verbose, backend=self.backend)

    def _comparison_diagrams(self, idxs):
        """Per recording: EEG + audio diagrams on the ≤ 15 comparison
        windows.  ONE index set over n_pair = min(eeg, audio) windows is
        drawn inside the audio program (through n_win_cap) and reused for
        the EEG side — the reference's paired selection
        (tda_eeg_audio_comparison.py:72-80)."""
        B = len(idxs)
        eeg, audio, ns_e, ns_a, metas = self.store.batch(idxs)
        cfg = self.cfg
        n_win_e = programs.window_count_program(
            self._dev(ns_e), cfg.win_samples, cfg.step_samples, eeg.shape[-1])
        aud, aud_out = self._audio_clouds(audio, ns_a, n_win_cap=n_win_e)
        eeg_out = self._eeg_clouds(eeg, ns_e, aud["use_idx"], aud["n_win"])
        n_pair = aud["n_win"]
        kmask = torch.arange(K_CMP, device=self.device)[None, :] < n_pair[:, None]
        return dict(eeg=eeg_out, audio=aud_out, kmask=kmask, metas=metas,
                    shape=(B, N_BANDS, K_CMP), tau=aud["tau"], n_pair=n_pair,
                    degen=aud["n_pts"] < 3)

    def _own_diagrams(self, idxs):
        """EEG + audio H1 diagrams with per-side OWN window selections — the
        control getters' semantics (matched_vs_mismatched.py:35-85): each
        side subsamples over its own window count.  Nothing is paired here;
        `_control_rows_exact` pairs positionally after compaction."""
        B = len(idxs)
        eeg, audio, ns_e, ns_a, metas = self.store.batch(idxs)
        cfg = self.cfg
        n_win_e = np.maximum(
            (np.minimum(ns_e, eeg.shape[-1]) - cfg.win_samples)
            // cfg.step_samples + 1, 0)
        use_idx = np.zeros((B, K_CMP), np.int64)
        for b in range(B):
            sel = _ref_linspace_idx(int(n_win_e[b]), K_CMP)
            use_idx[b, :len(sel)] = sel
        eeg_out = self._eeg_clouds(eeg, ns_e, self._dev(use_idx),
                                   self._dev(n_win_e))
        aud, aud_out = self._audio_clouds(audio, ns_a)   # own window count
        return dict(eeg=eeg_out, audio=aud_out, metas=metas,
                    len_e=np.minimum(n_win_e, K_CMP),
                    len_a=torch.clamp(aud["n_win"], max=K_CMP).cpu().numpy(),
                    degen=(aud["n_pts"] < 3).cpu().numpy())

    @staticmethod
    def _h1_padded(out):
        """H1 (births, deaths, mask) tensors padded to K_H1 columns, finite
        bars only — the reference's safe_wasserstein cleanup.  A masked slot
        holds (0, 0): an all-NaN window leaves NaN births in the slots that
        hold no bar (a visible bar's birth is finite: its death exceeds it),
        and no consumer reads a masked slot, but none receives a NaN."""
        b, d = out["births"][:, :K_H1], out["deaths"][:, :K_H1]
        m = out["mask"][:, :K_H1] & torch.isfinite(d)
        b, d = torch.where(m, b, 0.0), torch.where(m, d, 0.0)
        pad = (0, K_H1 - b.shape[1])
        return tuple(torch.nn.functional.pad(x, pad) for x in (b, d, m))

    def _mismatch_own_cache(self, mis_list):
        """Audio H1 diagrams (own-count selection) of each unique mismatch
        recording, computed once; a failed load maps to None, which yields
        NaN mismatch values as in the reference."""
        cache = {}
        for b0 in range(0, len(mis_list), self.eeg_batch):
            idxs = mis_list[b0:b0 + self.eeg_batch]
            d = self._own_diagrams(idxs)
            a_b, a_d, a_m = (x.cpu().numpy().reshape(len(idxs), N_BANDS, K_CMP, -1)
                             for x in self._h1_padded(d["audio"]))
            for b, i in enumerate(idxs):
                cache[i] = None if d["metas"][b].get("failed") else dict(
                    b=a_b[b], d=a_d[b], m=a_m[b], degen=d["degen"][b],
                    len_a=int(d["len_a"][b]))
        return cache

    def _control_rows_exact(self, all_idx, mis_idx, mis_cache):
        """Control rows with the reference's EXACT pairing
        (matched_vs_mismatched.py:50-61,87-95): per-side window selections,
        the audio's degenerate windows compacted out of its list (shifting
        later pairings), positional pairing over min(len_eeg, len_audio),
        and a nanmean of the per-pair W_H1.  mis_idx maps (subject,
        condition) → the subject's first opposite-condition recording."""
        rows = []
        for b0 in range(0, len(all_idx), self.eeg_batch):
            idxs = all_idx[b0:b0 + self.eeg_batch]
            with span("control_own_diagrams", self.device):
                d = self._own_diagrams(idxs)
            e_b, e_d, e_m = (x.cpu().numpy() for x in self._h1_padded(d["eeg"]))
            a_b, a_d, a_m = (x.cpu().numpy() for x in self._h1_padded(d["audio"]))
            pairs_e, groups, pend = [], [], []
            pa = {"b": [], "d": [], "m": []}
            for b, meta in enumerate(d["metas"]):
                if meta.get("failed"):
                    continue
                mis = mis_cache.get(
                    mis_idx.get((meta["subject"], meta["condition"])))
                len_e = int(d["len_e"][b])
                for bd, band in enumerate(BAND_NAMES):
                    ridx = len(pend)
                    pend.append(dict(subject=meta["subject"],
                                     condition=meta["condition"], band=band,
                                     filename=meta["filename"],
                                     w_matched=np.nan, w_mismatched=np.nan))
                    base = (b * N_BANDS + bd) * K_CMP
                    comp = [j for j in range(int(d["len_a"][b]))
                            if not d["degen"][b, bd, j]]
                    for i in range(min(len_e, len(comp))):
                        pairs_e.append(base + i)
                        for k, arr in (("b", a_b), ("d", a_d), ("m", a_m)):
                            pa[k].append(arr[base + comp[i]])
                        groups.append((ridx, "w_matched"))
                    if mis is not None:
                        compm = [j for j in range(int(mis["len_a"]))
                                 if not mis["degen"][bd, j]]
                        for i in range(min(len_e, len(compm))):
                            pairs_e.append(base + i)
                            for k in ("b", "d", "m"):
                                pa[k].append(mis[k][bd, compm[i]])
                            groups.append((ridx, "w_mismatched"))
            if pairs_e:
                with span("control_wass_h1", self.device):
                    w = self._wass_chunks(
                        *(self._dev(x[pairs_e]) for x in (e_b, e_d, e_m)),
                        *(self._dev(np.stack(pa[k])) for k in ("b", "d", "m"))
                    ).cpu().numpy()
                sums, cnts = defaultdict(float), defaultdict(int)
                for key, val in zip(groups, w):
                    if np.isfinite(val):          # reference nanmean
                        sums[key] += float(val)
                        cnts[key] += 1
                for (ridx, key), c in cnts.items():
                    pend[ridx][key] = sums[(ridx, key)] / c
            rows.extend(pend)
        return rows

    # ---------------- Wasserstein between EEG and audio diagrams ----------------

    def _wasserstein_h0h1(self, eeg_out, aud_out, pair_mask):
        """W_H0 and W_H1 of window-paired diagrams, flat (N,) tensors; NaN
        where pair_mask is False.  H0 (every birth 0): the exact DP with
        "sinkhorn", the host assignment with "host_exact"; H1 through
        `_wass_chunks`."""
        def h0(out, K):
            d = out["h0_deaths"][:, :K]
            return torch.where(torch.isfinite(d), d, 0.0), out["h0_mask"][:, :K]

        (e_d, e_m), (a_d, a_m) = h0(eeg_out, K_H0_EEG), h0(aud_out, K_H0_AUD)
        if self.cfg.wasserstein_backend == "sinkhorn":
            w_h0 = wasserstein_h0_exact(e_d, e_m, a_d, a_m)
        else:
            w_h0 = self._wass_chunks(torch.zeros_like(e_d), e_d, e_m,
                                     torch.zeros_like(a_d), a_d, a_m)
        w_h1 = self._wass_chunks(*self._h1_padded(eeg_out),
                                 *self._h1_padded(aud_out))
        nan = torch.full_like(w_h0, float("nan"))
        return torch.where(pair_mask, w_h0, nan), torch.where(pair_mask, w_h1, nan)

    def _wass_chunks(self, b1, d1, m1, b2, d2, m2):
        """Wasserstein distances (persim semantics) of (N, K) padded diagram
        pairs: with "host_exact" the exact assignment on the host
        (`native.engine.wasserstein_batch`, persim's Hungarian matching),
        with "sinkhorn" the un-tiered log-domain Sinkhorn
        (`sinkhorn_cost_pairs`: on the CPU the plain version in pieces, on
        the card one kernel launch).  Returns (N,) on the inputs' device."""
        if self.cfg.wasserstein_backend == "host_exact":
            from ..native.engine import wasserstein_batch

            w = wasserstein_batch(*(x.cpu().numpy() for x in (b1, d1, m1, b2, d2, m2)))
            return torch.as_tensor(w, device=b1.device)
        return sinkhorn_cost_pairs(b1, d1, m1, b2, d2, m2)

    # ---------------- the fused comparison pass ----------------

    def _mismatch_index(self):
        """(subject, condition) → index of the subject's FIRST
        opposite-condition recording (matched_vs_mismatched.py:117-121)."""
        by_subj = defaultdict(lambda: defaultdict(list))
        for i in range(len(self.store)):
            fn, subj, cond = self.store.index[i]
            by_subj[subj][cond].append(i)
        mis = {}
        for subj, conds in by_subj.items():
            for cond, opp in (("slow", "fast"), ("fast", "slow")):
                if conds[opp]:
                    mis[(subj, cond)] = min(conds[opp],
                                            key=lambda i: self.store.index[i][0])
        return mis

    def _mismatch_diagram_cache(self, mis_idx):
        """Each unique mismatch recording's audio H1 diagrams, computed ONCE
        (the reference recomputes the same file for every pairing).

        Returns (bank, slot): bank["b"/"d"/"m"] are (U + 1, 5·K_CMP, H)
        device tensors whose last row stays zero (the "no mismatch partner"
        slot), bank["n_win"/"degen"] host arrays read back once; slot maps a
        recording index to its row, failed recordings excluded."""
        mis_list = sorted(set(mis_idx.values()))
        WB = N_BANDS * K_CMP
        parts = {k: [] for k in ("h1_b", "h1_d", "h1_m", "n_win", "degen",
                                 "overflow")}
        slot = {}
        for b0 in range(0, len(mis_list), self.eeg_batch):
            batch = mis_list[b0:b0 + self.eeg_batch]
            _, audio_b, _, ns_a_b, metas_b = self.store.batch(batch)
            for dev, idxs, sl in self._shards(batch):
                out = programs.audio_h1_program(
                    audio_b[sl].to(dev, non_blocking=True), ns_a_b[sl], self.cfg,
                    self.n_rs_max, self.n_win_max, K_CMP, device=dev)
                for k in ("h1_b", "h1_d", "h1_m"):
                    parts[k].append(out[k].reshape(len(idxs), WB, -1)
                                    .to(self.device, non_blocking=True))
                for k in ("n_win", "degen", "overflow"):
                    parts[k].append(out[k].to(self.device, non_blocking=True))
            for b, i in enumerate(batch):
                if not metas_b[b].get("failed"):
                    slot[i] = b0 + b
        if not mis_list:
            return None, {}
        H = parts["h1_b"][0].shape[-1]

        def with_zero_row(k, dtype):
            return torch.cat(parts[k] + [torch.zeros((1, WB, H), dtype=dtype,
                                                     device=self.device)])

        n_ovf = int(torch.cat(parts["overflow"]).sum())
        if n_ovf:
            tlog.LOGGER.event("mismatch_cache_overflow", n_windows=n_ovf)
        return dict(b=with_zero_row("h1_b", torch.float32),
                    d=with_zero_row("h1_d", torch.float32),
                    m=with_zero_row("h1_m", torch.bool),
                    n_win=torch.cat(parts["n_win"]).cpu().numpy(),
                    degen=torch.cat(parts["degen"]).cpu().numpy()), slot

    def _bank_flat(self):
        """The features stage's per-batch bank leaves as flat
        (rows·5·K_feat, ·) tensors on the runner's device (a mesh's shards
        gathered onto its first), concatenated once, lazily."""
        bk = self._eeg_bank
        if bk["flat"] is None:
            bk["flat"] = {
                k: torch.cat([b[k].to(self.device, non_blocking=True)
                              for b in bk["batches"]]).flatten(0, 1)
                for k in ("h1_b", "h1_d", "h1_m", "h0_d", "h0_m", "feats")}
            bk["batches"] = None      # free the un-flattened copies
        return bk["flat"]

    def _audio_window_count(self, i: int) -> int:
        """Window count of recording i's audio envelope at the EEG rate."""
        win, step = self.cfg.win_samples, self.cfg.step_samples
        n_rs = int(resample_n_out(int(min(self.store.ns_a[i], self.t_audio_pad)),
                                  self.cfg.fs_eeg, self.cfg.fs_audio))
        return max((n_rs - win) // step + 1, 0)

    def _audio_window_counts(self, idxs) -> np.ndarray:
        """`_audio_window_count` of recordings idxs, at once."""
        win, step = self.cfg.win_samples, self.cfg.step_samples
        n_a = np.minimum(self.store.ns_a[np.asarray(idxs, np.int64)], self.t_audio_pad)
        n_rs = resample_n_out(n_a, self.cfg.fs_eeg, self.cfg.fs_audio)
        return np.maximum((n_rs - win) // step + 1, 0)

    def _comparison_plan(self, mis_idx, mis_slot, bank):
        """The comparison loop's per-recording host arrays, for every
        recording in store order (the loop's order), computed once a stage:
        slots (N,) each one's row of the mismatch bank (its zero row without
        a partner), has_mis (N,), mis_n_win (N,), mis_degen (N, 5, K_CMP);
        with the features stage's bank gidx (N, 5·K_CMP), the flat bank
        indices of each one's paired windows (0 where it has no bank row),
        and in_bank (N,); ns_e and ns_a (N,), the store's lengths."""
        N, zero_slot = len(self.store), bank["b"].shape[0] - 1
        slots = np.full(N, zero_slot, np.int64)
        for i in range(N):
            fn, subj, cond = self.store.index[i]
            u = mis_slot.get(mis_idx.get((subj, cond)))
            if u is not None:
                slots[i] = u
        has_mis = slots != zero_slot
        mis_n_win = np.zeros(N, np.int64)
        mis_degen = np.zeros((N, N_BANDS, K_CMP), bool)
        mis_n_win[has_mis] = bank["n_win"][slots[has_mis]]
        mis_degen[has_mis] = bank["degen"][slots[has_mis]]
        plan = dict(slots=slots, has_mis=has_mis, mis_n_win=mis_n_win,
                    mis_degen=mis_degen, ns_e=self.store.ns_e, ns_a=self.store.ns_a)
        if self._eeg_bank is not None:
            bk = self._eeg_bank
            rows = np.array([bk["slot"].get(i, -1) for i in range(N)], np.int64)
            plan["in_bank"] = rows >= 0
            cols = bk["K_base"] + np.arange(K_CMP, dtype=np.int64)
            gidx = ((rows[:, None] * N_BANDS + np.arange(N_BANDS))[:, :, None] * bk["K"]
                    + cols)
            plan["gidx"] = np.where(plan["in_bank"][:, None, None], gidx,
                                    0).reshape(N, -1)
        return plan

    def _bank_serves(self, plan, idxs, metas) -> bool:
        """Whether the features stage's bank serves a comparison batch: the
        whole batch or none of it; a live recording without a bank row
        (diagram overflow, zero windows, outside a features shard) sends
        the batch to `comparison_program`."""
        return self._eeg_bank is not None and all(
            plan["in_bank"][i] or m.get("failed") for i, m in zip(idxs, metas))

    @staticmethod
    def _plan_on(plan, dev):
        """The plan's arrays the programs read, on `dev` in one copy
        (`runtime.to_device`, no host wait): a dict of device views."""
        keys = ("ns_e", "ns_a", "slots", "mis_n_win")
        parts = [plan[k] for k in keys] + [plan["mis_degen"].reshape(-1)]
        if "gidx" in plan:
            parts.append(plan["gidx"].reshape(-1))
        flat = to_device(np.concatenate([np.asarray(x, np.int64) for x in parts]),
                         dev)
        on, off, N = {}, 0, len(plan["slots"])
        for k in keys:
            on[k], off = flat[off:off + N], off + N
        W = N_BANDS * K_CMP
        on["mis_degen"] = flat[off:off + N * W].reshape(N, N_BANDS, K_CMP).bool()
        if "gidx" in plan:
            on["gidx"] = flat[off + N * W:].reshape(N, W)
        return on

    def _fused_rows(self):
        """One device pass over all recordings → the comparison + control
        rows.  Wasserstein runs on the device (exact H0 DP, tiered Sinkhorn
        for H1); the stage reads back one packed vector after its loop.
        From `comparison_dispatch` to that read-back nothing makes the host
        wait for the card: the per-batch arrays are uploaded once a stage
        and device (`_comparison_plan`), the recordings are contiguous slices
        of the store and the programs' constants stay on the card, so the
        host enqueues ahead of the card (counter
        `comparison_dispatch.host_waits`, 0 when it does)."""
        if self._fused_cache is not None:
            return self._fused_cache
        cfg = self.cfg
        with logged_span("mismatch_cache", self.device) as log:
            mis_idx = self._mismatch_index()
            bank, mis_slot = self._mismatch_diagram_cache(mis_idx)
            log.update(items=len(mis_slot))
        WB = N_BANDS * K_CMP
        if bank is None:     # no opposite-condition file anywhere
            bank = dict(b=torch.zeros((1, WB, 96), device=self.device),
                        d=torch.zeros((1, WB, 96), device=self.device),
                        m=torch.zeros((1, WB, 96), dtype=torch.bool,
                                      device=self.device),
                        n_win=np.zeros(0, np.int64),
                        degen=np.zeros((0, N_BANDS, K_CMP), bool))
        # the mismatch diagrams and the plan on each shard's device, so
        # that a shard's gathers stay on its own device
        on_dev = {}
        self._bank_served = self._bank_fallback = 0
        t0 = time.time()
        all_idx = list(range(len(self.store)))
        batches = []        # (packed, idxs, metas, has_mis, mis_degen)
        with logged_span("comparison_dispatch", self.device,
                         items=len(all_idx) * N_BANDS * K_CMP,
                         n_mismatch_cached=len(mis_slot)) as log, \
                host_waits("comparison_dispatch.host_waits", self.device):
            plan = self._comparison_plan(mis_idx, mis_slot, bank)
            for b0 in range(0, len(all_idx), self.eeg_batch):
                idxs = all_idx[b0:b0 + self.eeg_batch]
                eeg_b, audio_b, _, _, metas_b = self.store.batch(idxs)
                served = self._bank_serves(plan, idxs, metas_b)
                if self._eeg_bank is not None:
                    self._bank_served += served
                    self._bank_fallback += not served
                for dev, part, sl in self._shards(idxs):
                    if dev not in on_dev:
                        on_dev[dev] = (tuple(bank[k].to(dev) for k in "bdm"),
                                       self._plan_on(plan, dev))
                    mis_h1, on = on_dev[dev]
                    rows = slice(b0 + sl.start, b0 + sl.stop)
                    ns_e, ns_a = on["ns_e"][rows], on["ns_a"][rows]
                    slots = on["slots"][rows]
                    mis_args = (tuple(x[slots].flatten(0, 1) for x in mis_h1),
                                on["mis_n_win"][rows], on["mis_degen"][rows])
                    audio = audio_b[sl].to(dev, non_blocking=True)
                    if served:
                        out = programs.comparison_from_bank(
                            self._bank_flat(), on["gidx"][rows].reshape(-1), ns_e,
                            audio, ns_a, *mis_args, cfg, self.n_win_max,
                            self.n_rs_max, K_CMP, t_eeg_pad=eeg_b.shape[-1],
                            device=dev)
                    else:
                        out = programs.comparison_program(
                            eeg_b[sl].to(dev, non_blocking=True), ns_e, audio, ns_a,
                            *mis_args, cfg, self.n_win_max, self.n_rs_max, K_CMP,
                            device=dev)
                    batches.append((programs.pack_comparison_outputs(out), part,
                                    metas_b[sl], plan["has_mis"][rows],
                                    plan["mis_degen"][rows]))
                if self.verbose:
                    print(f"  fused compare: {b0 + len(idxs)}/{len(all_idx)} "
                          f"dispatched ({time.time() - t0:.0f}s)")
            log.update(bank_batches=self._bank_served,
                       bank_fallback_batches=self._bank_fallback)
        with span("comparison_rows", self.device):
            flat_all = (torch.cat([b[0].to(self.device, non_blocking=True)
                                   for b in batches]).cpu().numpy()
                        if batches else np.zeros(0, np.float32))
            rows, off = [], 0
            for packed, idxs, metas, has_mis, mis_degen in batches:
                n = packed.shape[0]
                out_h = programs.unpack_comparison_outputs(flat_all[off:off + n],
                                                           len(idxs))
                off += n
                self._drain_fused(out_h, metas, has_mis, mis_degen, rows)
        n_ovf = sum(1 for r in rows if r.get("overflow"))
        if n_ovf:
            tlog.LOGGER.event("comparison_overflow", n_rows=n_ovf)
        self._fused_cache = rows
        return rows

    @staticmethod
    def _drain_fused(out, metas, has_mis, mis_degen, rows):
        for b, meta in enumerate(metas):
            if meta.get("failed"):      # dropped, like the reference's failed list
                continue
            for bd, band in enumerate(BAND_NAMES):
                row = dict(filename=meta["filename"],
                           condition=meta["condition"],
                           subject=meta["subject"], band=band,
                           wasserstein_h0=float(out["w_h0"][b, bd]),
                           wasserstein_h1=float(out["w_h1"][b, bd]),
                           w_mismatched=(float(out["w_h1_mis"][b, bd])
                                         if has_mis[b] else np.nan),
                           n_windows=int(out["n_pair"][b]),
                           tau=int(out["tau"][b, bd]),
                           # control-deviance / overflow flags (internal —
                           # not in the CSV schema)
                           a_degen=bool(out["a_degen"][b, bd]),
                           mis_degen=bool(has_mis[b] and mis_degen[b, bd].any()),
                           overflow=bool(out["overflow"][b]))
                for fi, fname in enumerate(FEATS):
                    row[f"corr_{fname}_r"] = float(out["corr_r"][b, bd, fi])
                    row[f"corr_{fname}_p"] = float(out["corr_p"][b, bd, fi])
                rows.append(row)

    # ---------------- analysis: EEG↔audio comparison ----------------

    def run_comparison(self, n_permutations: int | None = None) -> dict:
        """Hypothesis-2 analysis → the eeg_audio_tda_comparison.json schema.

        The fused pass (device backend, Sinkhorn) recomputes the recordings
        it flagged `overflow` through `_staged_comparison_rows` (exact
        diagrams); their flag stays set so the control stage redoes them
        exactly too.  Otherwise every recording takes the staged path.
        Spans: `comparison` with the fused pass's `mismatch_cache`,
        `comparison_dispatch` and `comparison_rows`, then `comparison_redo`
        and the statistics' `band_stats` and `results_write`."""
        with span("comparison", self.device):
            return self._comparison(n_permutations or 1000)

    def _comparison(self, n_perm: int) -> dict:
        if not self._fused:
            rows = self._staged_comparison_rows(list(range(len(self.store))))
            return self._comparison_stats(rows, n_perm)
        rows = [r for r in self._fused_rows() if r["n_windows"] > 0]
        ovf_keys = sorted({(r["filename"], r["condition"])
                           for r in rows if r.get("overflow")})
        with span("comparison_redo", self.device):
            if ovf_keys:
                if self.verbose:
                    print(f"  comparison: {len(ovf_keys)} overflow recordings → "
                          "exact redo")
                idx_map = {(fn, cond): i for i, (fn, subj, cond)
                           in enumerate(self.store.index)}
                redo = {(r["filename"], r["condition"], r["band"]): r
                        for r in self._staged_comparison_rows(
                            [idx_map[k] for k in ovf_keys])}
                self.redo_counts["comparison"] += len(ovf_keys)
                for ri, r in enumerate(rows):
                    s = redo.get((r["filename"], r["condition"], r["band"]))
                    if s is not None:
                        rows[ri] = {**r, **s, "overflow": True}
        return self._comparison_stats(rows, n_perm)

    def _staged_comparison_rows(self, all_idx) -> list[dict]:
        """Comparison rows through the staged pipeline: diagrams from
        `run_tda` on the runner's backend (overflowed windows on the host
        engine) and `_wass_chunks` — the parity path, also the redo path of
        recordings the fused pass flagged."""
        rows = []
        t0 = time.time()
        for b0 in range(0, len(all_idx), self.eeg_batch):
            idxs = all_idx[b0:b0 + self.eeg_batch]
            d = self._comparison_diagrams(idxs)
            B, NB, K = d["shape"]
            # degenerate Takens windows (< 3 points) are skipped entirely by
            # the reference: out of the Wasserstein means and the feature
            # time series
            km = d["kmask"][:, None, :].expand(B, NB, K) & ~d["degen"]
            w_h0, w_h1 = self._wasserstein_h0h1(d["eeg"], d["audio"],
                                                km.reshape(-1))
            ef = d["eeg"]["features"].reshape(B, NB, K, 2, 11)[:, :, :, 1, :]
            af = d["audio"]["features"].reshape(B, NB, K, 2, 11)[:, :, :, 1, :]
            # the batch's one read-back
            w_h0, w_h1, ef, af, km, n_pair, tau = (
                x.cpu().numpy() for x in (
                    w_h0.reshape(B, NB, K), w_h1.reshape(B, NB, K), ef, af, km,
                    d["n_pair"], d["tau"]))
            sp_a, sp_e, sp_m, sp_tgt = [], [], [], []
            for b, meta in enumerate(d["metas"]):
                if meta.get("failed"):
                    continue
                for bd, band in enumerate(BAND_NAMES):
                    msk = km[b, bd]
                    n_valid = int(msk.sum())
                    if n_valid == 0:
                        continue
                    row = dict(filename=meta["filename"],
                               condition=meta["condition"],
                               subject=meta["subject"], band=band,
                               wasserstein_h0=float(np.nanmean(w_h0[b, bd])),
                               wasserstein_h1=float(np.nanmean(w_h1[b, bd])),
                               # the reference reports len(idx), degenerate
                               # windows included
                               n_windows=int(min(n_pair[b], K)),
                               tau=int(tau[b, bd]))
                    for fname, fi in FEAT_COLS.items():
                        a_ts, e_ts = af[b, bd, :, fi], ef[b, bd, :, fi]
                        row[f"corr_{fname}_r"] = 0.0
                        row[f"corr_{fname}_p"] = 1.0
                        if (n_valid >= 5 and a_ts[msk].std() > 1e-10
                                and e_ts[msk].std() > 1e-10):
                            sp_tgt.append((row, fname))
                            sp_a.append(a_ts)
                            sp_e.append(e_ts)
                            sp_m.append(msk)
                    rows.append(row)
            if sp_tgt:      # one batched Spearman for the whole batch
                r_all, p_all = tstats.spearmanr(
                    self._dev(np.stack(sp_a)), self._dev(np.stack(sp_e)),
                    self._dev(np.stack(sp_m)))
                r_all, p_all = r_all.cpu().numpy(), p_all.cpu().numpy()
                for ti, (row, fname) in enumerate(sp_tgt):
                    row[f"corr_{fname}_r"] = float(r_all[ti])
                    row[f"corr_{fname}_p"] = float(p_all[ti])
            if self.verbose:
                print(f"  comparison (staged): {b0 + len(idxs)}/{len(all_idx)} "
                      f"({time.time() - t0:.0f}s)")
        return rows

    @staticmethod
    def _masked_delta_batch(deltas_by_band):
        """{band: per-subject delta list} → masked (5, n_max) float32 batch
        for the statistics, all bands in one call.  A band with < 5 subjects
        gets a placeholder True at column 0 so the batched statistic stays
        defined; callers skip those bands."""
        n_max = max(1, *(len(v) for v in deltas_by_band.values()))
        D = np.zeros((N_BANDS, n_max), np.float32)
        M = np.zeros((N_BANDS, n_max), bool)
        for bd, band in enumerate(BAND_NAMES):
            v = deltas_by_band[band]
            if len(v) < 5:
                M[bd, 0] = True
                continue
            D[bd, :len(v)] = v
            M[bd, :len(v)] = True
        return D, M

    def _stat(self, fn, D, M, **kw):
        out = fn(self._dev(D), self._dev(M), **kw)
        out = out[1] if isinstance(out, tuple) else out     # wilcoxon → p
        return out.cpu().numpy()

    def _fdr(self, pvals, alpha):
        reject, p_fdr = tstats.bh_fdr(
            self._dev(np.asarray(pvals, np.float32)[None]), alpha)
        return reject[0].cpu().numpy(), p_fdr[0].cpu().numpy()

    def _comparison_stats(self, rows, n_perm, signs=None) -> dict:
        """Band statistics — reference tda_eeg_audio_comparison.py:161-221.
        The sign-flip draws come from a generator seeded with 42 on the
        runner's device, or from `signs` (n_perm, 5, n_max) when given.
        Spans: `band_stats` (the statistics), `results_write` (the files)."""
        with logged_span("band_stats", self.device, items=len(rows)):
            out = self._band_stats(rows, n_perm, signs)
        if self.results_dir:
            with span("results_write", self.device):
                self.results_dir.mkdir(parents=True, exist_ok=True)
                slim = {k: v for k, v in out.items() if k != "detailed_rows"}
                (self.results_dir / "eeg_audio_tda_comparison.json").write_text(
                    json.dumps(slim, indent=2, default=str))
                self._write_detailed_csv(rows)
                figures = _figures_module()
                if figures:
                    figures.comparison_figures(rows, out["band_results"],
                                               self.results_dir)
        return out

    def _band_stats(self, rows, n_perm, signs) -> dict:
        per = defaultdict(lambda: defaultdict(list))
        for r in rows:
            per[r["band"]][(r["subject"], r["condition"])].append(r)
        band_data = {}
        for band in BAND_NAMES:
            means = {key: dict(
                h0=np.mean([x["wasserstein_h0"] for x in rs]),
                h1=np.mean([x["wasserstein_h1"] for x in rs]),
                corr=np.mean([x["corr_mean_persistence_r"] for x in rs]))
                for key, rs in per[band].items()}
            subs = sorted({s for (s, c) in means if (s, "slow") in means
                           and (s, "fast") in means})
            band_data[band] = (means, subs)

        def deltas(k):
            return {band: [band_data[band][0][(s, "slow")][k]
                           - band_data[band][0][(s, "fast")][k]
                           for s in band_data[band][1]]
                    for band in BAND_NAMES}

        D0, M = self._masked_delta_batch(deltas("h0"))
        D1, _ = self._masked_delta_batch(deltas("h1"))
        DC, _ = self._masked_delta_batch(deltas("corr"))
        p0_all = self._stat(tstats.wilcoxon, D0, M)
        p1_all = self._stat(tstats.wilcoxon, D1, M)
        pc_all = self._stat(tstats.wilcoxon, DC, M)
        gen = None
        if signs is None:
            gen = torch.Generator(device=self.device).manual_seed(42)
        perm_all = self._stat(tstats.sign_flip_pvalue, D1, M, n_perm=n_perm,
                              signs=signs, generator=gen)
        coh_all = self._stat(tstats.cohens_d_paired, D1, M)

        stats_out, pvals_h1 = {}, []
        for bd, band in enumerate(BAND_NAMES):
            means, subs = band_data[band]
            n = len(subs)
            bs = {"n_subjects": n, "band": band}
            if n >= 5:
                d1 = D1[bd, :n]
                mean_of = lambda k, c: float(np.mean(  # noqa: E731
                    [means[(s, c)][k] for s in subs]))
                bs.update({
                    "wass_h0_slow": mean_of("h0", "slow"),
                    "wass_h0_fast": mean_of("h0", "fast"),
                    "wass_h0_p": float(p0_all[bd]),
                    "wass_h1_slow": mean_of("h1", "slow"),
                    "wass_h1_fast": mean_of("h1", "fast"),
                    "wass_h1_p": float(p1_all[bd]),
                    "wass_h1_perm_p": float(perm_all[bd]),
                    "wass_h1_cohens_d": float(coh_all[bd]),
                    "wass_h1_direction": ("slow < fast" if d1.mean() < 0
                                          else "slow > fast"),
                    "corr_slow": mean_of("corr", "slow"),
                    "corr_fast": mean_of("corr", "fast"),
                    "corr_p": float(pc_all[bd]),
                    "n_slow_lower": int(np.sum(d1 < 0)),
                })
            stats_out[band] = bs
            pvals_h1.append(bs.get("wass_h1_p", 1.0))
        reject, p_fdr = self._fdr(pvals_h1, self.cfg.alpha)
        for i, band in enumerate(BAND_NAMES):
            stats_out[band]["wass_h1_p_fdr"] = float(p_fdr[i])
            stats_out[band]["wass_h1_sig_fdr"] = bool(reject[i])

        return {
            "analysis": "EEG-Audio Topological Comparison",
            "method": "Wasserstein distance on persistence diagrams + temporal feature correlation",
            "audio_construction": f"Takens embedding (dim={self.cfg.takens_dim}, tau=auto, subsample={self.cfg.takens_subsample})",
            "eeg_construction": "Connectivity graph distance matrix (device pipeline)",
            "n_recordings": len({r["filename"] + r["condition"] for r in rows}),
            "n_subjects": len({r["subject"] for r in rows}),
            "n_slow": len({r["filename"] for r in rows if r["condition"] == "slow"}),
            "n_fast": len({r["filename"] for r in rows if r["condition"] == "fast"}),
            "max_windows_per_recording": K_CMP,
            "statistical_test": "Wilcoxon signed-rank (within-subject, paired)",
            "multiple_comparison": "Benjamini-Hochberg FDR",
            "band_results": stats_out,
            "detailed_rows": rows,
        }

    def _write_detailed_csv(self, rows):
        """eeg_audio_tda_detailed.csv with the reference's exact column set;
        internal row fields (w_mismatched, control-deviance flags) are not
        serialized."""
        if not rows:
            return
        keys = ["filename", "condition", "subject", "band",
                "wasserstein_h0", "wasserstein_h1", "n_windows", "tau"]
        keys += [k for k in rows[0] if k.startswith("corr_")]
        with open(self.results_dir / "eeg_audio_tda_detailed.csv", "w",
                  newline="") as f:
            wr = csv.DictWriter(f, fieldnames=keys, extrasaction="ignore")
            wr.writeheader()
            wr.writerows(rows)

    # ---------------- analysis: matched vs mismatched control ----------------

    def run_control(self) -> dict:
        """Matched/mismatched Wasserstein control → matched_vs_mismatched.json.

        Reference scripts/matched_vs_mismatched.py: matched = EEG vs own
        audio; mismatched = EEG vs the subject's FIRST recording of the
        opposite condition; each side subsamples over its OWN window count
        and pairing is positional after the audio's degenerate windows are
        compacted out.  On the fused path the comparison's per-recording
        values are reused where they provably coincide with those semantics,
        and the deviants are redone exactly (`_control_rows_exact`); on the
        staged path every recording goes through `_control_rows_exact`.  The
        span `control` holds the stage, the `control_*` spans its parts."""
        with logged_span("control", self.device) as log:
            by_subj = defaultdict(lambda: defaultdict(list))
            for i in range(len(self.store)):
                fn, subj, cond = self.store.index[i]
                by_subj[subj][cond].append(i)
            for conds in by_subj.values():
                for lst in conds.values():
                    lst.sort(key=lambda i: self.store.index[i][0])
            common = sorted(s for s in by_subj
                            if by_subj[s]["slow"] and by_subj[s]["fast"])
            mis_idx = {}
            for s in common:
                mis_idx[(s, "slow")] = by_subj[s]["fast"][0]
                mis_idx[(s, "fast")] = by_subj[s]["slow"][0]
            all_idx = [i for s in common for c in ("slow", "fast")
                       for i in by_subj[s][c]]
            if self._fused:
                rows = self._control_rows_fused(all_idx, mis_idx)
            else:
                with span("control_mismatch_cache", self.device):
                    mis_cache = self._mismatch_own_cache(sorted(set(mis_idx.values())))
                with span("control_exact_rows", self.device):
                    rows = self._control_rows_exact(all_idx, mis_idx, mis_cache)
            log.update(items=len(rows))
            with span("control_stats", self.device):
                return self._control_stats(rows)

    def _control_rows_fused(self, all_idx, mis_idx):
        """Control rows from the fused comparison pass + exact redo of
        deviants.

        The fused program draws ONE paired index set over min(eeg, audio)
        windows and masks degenerates positionally; the reference control
        selects per side and compacts.  The two coincide exactly when both
        sides have equal window counts and no degenerate Takens window.
        Recordings where they differ (unequal counts, any matched/mismatch
        degenerate, overflow, zero windows on either side or in the
        mismatch partner) go through `_control_rows_exact`."""
        with span("control_fused_rows", self.device):
            frows = self._fused_rows()
        fmap = {(r["filename"], r["condition"], r["band"]): r for r in frows}
        win, step = self.cfg.win_samples, self.cfg.step_samples
        deviants, rows = [], []
        with span("control_deviant_scan", self.device):
            for i in all_idx:
                fn, subj, cond = self.store.index[i]
                if i in self._failed_idx:
                    continue
                n_e = min(int(self.store.ns_e[i]), self.t_eeg_pad)
                n_win_e = max((n_e - win) // step + 1, 0)
                n_win_a = self._audio_window_count(i)
                brows = [fmap.get((fn, cond, b)) for b in BAND_NAMES]
                if any(r is None for r in brows):
                    continue          # dropped by the comparison (failed load)
                degen = any(r.get("a_degen") or r.get("mis_degen")
                            or r.get("overflow") for r in brows)
                # zero-window cases go through the exact path: the fused
                # program's empty-pair means are 0.0, where the reference
                # nanmeans an empty pair list to NaN and drops the row
                mi = mis_idx.get((subj, cond))
                mis_zero = mi is not None and self._audio_window_count(mi) == 0
                if n_win_e != n_win_a or degen or n_win_e == 0 or mis_zero:
                    deviants.append(i)
                    continue
                rows.extend(dict(subject=subj, condition=cond, band=r["band"],
                                 filename=fn, w_matched=r["wasserstein_h1"],
                                 w_mismatched=r["w_mismatched"]) for r in brows)
        self.redo_counts["control_deviants"] += len(deviants)
        if deviants:
            if self.verbose:
                print(f"  control: {len(deviants)} deviant recordings → "
                      "exact per-side pairing redo")
            tlog.LOGGER.event("control_exact_redo", n=len(deviants))
            keys = {(self.store.index[i][1], self.store.index[i][2]) for i in deviants}
            with span("control_mismatch_cache", self.device):
                mis_cache = self._mismatch_own_cache(
                    sorted({mis_idx[k] for k in keys if k in mis_idx}))
            with span("control_exact_rows", self.device):
                rows.extend(self._control_rows_exact(deviants, mis_idx, mis_cache))
        return rows

    def _control_stats(self, rows) -> dict:
        def subject_means(groups):
            return {s: (np.mean([x["w_matched"] for x in rs]),
                        np.mean([x["w_mismatched"] for x in rs]))
                    for s, rs in groups.items()}

        finite = [r for r in rows if np.isfinite(r["w_matched"])
                  and np.isfinite(r["w_mismatched"])]
        per = defaultdict(lambda: defaultdict(list))
        per_cond = defaultdict(lambda: defaultdict(list))
        for r in finite:
            per[r["band"]][r["subject"]].append(r)
            per_cond[(r["band"], r["condition"])][r["subject"]].append(r)
        band_sm = {band: subject_means(per[band]) for band in BAND_NAMES}
        D, M = self._masked_delta_batch(
            {band: [m - mm for (m, mm) in band_sm[band].values()]
             for band in BAND_NAMES})
        p_all = self._stat(tstats.wilcoxon, D, M)
        d_all = self._stat(tstats.cohens_d_paired, D, M)

        results, pvals = {}, []
        for bd, band in enumerate(BAND_NAMES):
            sm = band_sm[band]
            n = len(sm)
            if n < 5:
                results[band] = {"n": n, "status": "insufficient"}
                pvals.append(1.0)
                continue
            diff = D[bd, :n]
            m_mean = float(np.mean([m for m, _ in sm.values()]))
            mm_mean = float(np.mean([mm for _, mm in sm.values()]))
            results[band] = {
                "n": n, "w_matched": m_mean, "w_mismatched": mm_mean,
                "direction": ("matched < mismatched" if m_mean < mm_mean
                              else "matched > mismatched"),
                "p": float(p_all[bd]),
                "cohens_d": float(d_all[bd]),
                "n_matched_lower": int(np.sum(diff < 0)),
                "pct_matched_lower": float(np.sum(diff < 0) / n * 100),
            }
            pvals.append(results[band]["p"])
        reject, p_fdr = self._fdr(pvals, 0.05)
        for i, band in enumerate(BAND_NAMES):
            if "p" in results[band]:
                results[band]["p_fdr"] = float(p_fdr[i])
                results[band]["sig_fdr"] = bool(reject[i])
        # per band × condition breakdown (matched_vs_mismatched.py:232-253)
        for band in BAND_NAMES:
            by_cond = {}
            for cond in ("slow", "fast"):
                sm = subject_means(per_cond[(band, cond)])
                if not sm:
                    continue
                diff = np.array([m - mm for (m, mm) in sm.values()])
                by_cond[cond] = {
                    "n": len(sm),
                    "w_matched": float(np.mean([m for m, _ in sm.values()])),
                    "w_mismatched": float(np.mean([mm for _, mm in sm.values()])),
                    "n_matched_lower": int(np.sum(diff < 0)),
                }
            if by_cond:
                results.setdefault(band, {})["by_condition"] = by_cond
        if self.results_dir:
            with span("results_write", self.device):
                self.results_dir.mkdir(parents=True, exist_ok=True)
                (self.results_dir / "matched_vs_mismatched.json").write_text(
                    json.dumps(results, indent=2, default=str))
        return results

    # ---------------- figures: sample diagrams + filter response ----------------

    def write_sample_figures(self) -> list[str]:
        """Sample persistence-diagram figures (first recording, window 0 of
        each band) and the filter-response figure — the reference's figures
        that are not derived from the results JSON.  Returns the file names
        written (none without results_dir or matplotlib)."""
        if not self.results_dir:
            return []
        figures = _figures_module()
        if figures is None:
            return []
        d = self._comparison_diagrams(list(range(min(self.eeg_batch, len(self.store)))))
        K = d["shape"][2]

        def dgm(out, flat):
            o = {k: out[k][flat].cpu().numpy() for k in
                 ("h0_deaths", "h0_mask", "births", "deaths", "mask")}
            h0m = o["h0_mask"] & np.isfinite(o["h0_deaths"])
            h1m = o["mask"] & np.isfinite(o["deaths"])
            return {"h0": np.stack([np.zeros(int(h0m.sum())), o["h0_deaths"][h0m]], -1),
                    "h1": np.stack([o["births"][h1m], o["deaths"][h1m]], -1)}

        eeg_dgms = {band: dgm(d["eeg"], bd * K) for bd, band in enumerate(BAND_NAMES)}
        audio_dgms = {band: dgm(d["audio"], bd * K)
                      for bd, band in enumerate(BAND_NAMES)}
        written = figures.persistence_figures(eeg_dgms, audio_dgms, self.results_dir)
        written += figures.filter_response_figure(self.cfg, self.results_dir)
        return written

    # ---------------- analysis: classification ----------------

    def run_classification(self, n_permutations: int | None = None,
                           n_bootstrap: int | None = None) -> dict:
        """Hypothesis 1, slow vs fast: the features stage, then the host
        Random Forest stage (`classify.run_classification`) →
        results_summary.json, feature_importance_ranked.csv, the features'
        metadata.csv / metadata.json and the classification figures."""
        X, y, subjects, filenames, meta = self.compute_feature_dataset()
        res = classify.run_classification(
            X, y, subjects, classify.feature_names_220(), self.cfg,
            n_permutations=n_permutations, n_bootstrap=n_bootstrap,
            verbose=self.verbose)
        file_metadata = meta.pop("file_metadata", [])
        res["window_equalization"] = meta
        null_scores = res.pop("null_scores", [])
        boot_scores = res.pop("bootstrap_scores", [])
        if self.results_dir:
            self.results_dir.mkdir(parents=True, exist_ok=True)
            from ..cli import _write_feature_metadata
            _write_feature_metadata(self.results_dir, file_metadata)
            figures = _figures_module()
            if figures:
                figures.classification_figures(res, null_scores, boot_scores,
                                               self.results_dir)
            ranked = res.pop("all_importances", {})
            (self.results_dir / "results_summary.json").write_text(
                json.dumps(res, indent=2))
            # feature_importance_ranked.csv (reference results artifact)
            with open(self.results_dir / "feature_importance_ranked.csv", "w") as f:
                f.write("rank,feature,importance\n")
                for rk, (name, imp) in enumerate(ranked.items(), 1):
                    f.write(f"{rk},{name},{imp}\n")
        return res
