"""The reference study: the answers the benchmark holds the program to,
worked out again from the benchmark's own inputs, recording by recording,
in plain PyTorch (float64 by default) on the inputs' device.

* `feature_rows`: the 220-feature rows (scripts/tda_eeg_classification_v2.py
  create_dataset): FIR bank → the md5 window sample of K windows a band
  ("min" equalisation) → Pearson distances → exact Rips H0 / H1 → 11
  features a diagram → mean and std over the windows.
* `comparison_rows`: per band the window-mean W_H0 (exact) and W_H1
  (entropic) of the EEG's paired windows against the own audio's Takens
  diagrams, and the mismatched W_H1 against the subject's first recording
  of the other condition (tda_eeg_audio_comparison.py:45-124,
  matched_vs_mismatched.py:35-95 as the fused pass pairs them).
* `control_rows`: the control's rows of a recording whose window counts
  differ between EEG and audio: each side's own selection, the audio's
  degenerate windows compacted out, positional pairs, a NaN-mean
  (matched_vs_mismatched.py:35-95).

`precision="bfloat16"` is the control of the benchmark's check: the same
arithmetic in float32 with every stage's output rounded to bfloat16.
Imports nothing of the program.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np
import torch

from . import features as F
from . import persistence as P
from . import signal as S
from . import wasserstein as W

BAND_NAMES = tuple(S.BANDS)
K_CMP = 15


def md5_window_sample(stem: str, band: str, n_windows: int, k: int, seed: int = 42):
    """The reference's window subsample (tda_eeg_classification_v2.py:394-400)."""
    k = min(k, n_windows)
    s = f"{stem}-{band}-{seed}"
    rng = np.random.default_rng(int(hashlib.md5(s.encode()).hexdigest()[:8], 16))
    return rng.choice(n_windows, size=k, replace=False)


def paired_window_idx(n_pair: int, k: int = K_CMP) -> np.ndarray:
    """The comparison's even subsample over n_pair windows, in float32 as
    the reference's jnp.linspace-and-truncate; repeats the last window when
    there are k or fewer."""
    if n_pair <= k:
        return np.minimum(np.arange(k), max(n_pair - 1, 0))
    return (np.arange(k, dtype=np.float32) * np.float32(n_pair - 1)
            / np.float32(k - 1)).astype(np.int64)


def own_window_idx(n_win: int, k: int = K_CMP) -> np.ndarray:
    """The control's own selection, np.linspace(0, n − 1, k, dtype=int)."""
    if n_win > k:
        return np.linspace(0, n_win - 1, k).astype(np.int64)
    return np.arange(max(n_win, 0), dtype=np.int64)


class Study:
    """Reference answers over one study's tensors (`study` as made by
    `harness.generator.make_study`) and configuration (`pipeline`: the
    configuration's pipeline fields with their defaults filled in)."""

    def __init__(self, study: dict, pipeline: dict, precision: str = "float64"):
        self.st = study
        self.cfg = pipeline
        self.dev = study["eeg"].device
        if precision == "float64":
            self.dtype, self.q = torch.float64, (lambda x: x)
        elif precision == "bfloat16":
            self.dtype = torch.float32
            self.q = lambda x: x.to(torch.bfloat16).to(torch.float32)
        else:
            raise ValueError(f"precision {precision!r}")
        c = pipeline
        self.win = int(c["window_sec"] * c["fs_eeg"])
        self.step = int(self.win * (1.0 - c["overlap"]))
        self.bank = S.band_bank(c["fs_eeg"], c["filter_order"], c["fir_numtaps"])
        self._banded = {}
        self._audio = {}
        self._dg = {}            # (side, recording, selection) → diagrams
        self.seconds = {}        # where the reference's time goes
        first = {}
        for j, (fn, subj, cond) in enumerate(study["index"]):
            if (subj, cond) not in first or fn < study["index"][first[(subj, cond)]][0]:
                first[(subj, cond)] = j
        self._first = first

    # ---- lengths ----------------------------------------------------------

    def eeg_windows(self, i: int) -> int:
        n = min(int(self.st["ns_e"][i]), self.st["eeg"].shape[-1])
        return max((n - self.win) // self.step + 1, 0)

    def audio_rate_length(self, i: int) -> int:
        up, down = self._updown()
        n_a = min(int(self.st["ns_a"][i]), self.st["audio"].shape[-1])
        return (n_a * up + down - 1) // down

    def audio_windows(self, i: int) -> int:
        return max((self.audio_rate_length(i) - self.win) // self.step + 1, 0)

    def _updown(self):
        _, up, down = S.resample_filter(self.cfg["fs_eeg"], self.cfg["fs_audio"])
        return up, down

    def feature_K(self) -> int:
        """The "min" equalisation: the fewest windows of any recording."""
        return min(n for n in (self.eeg_windows(i) for i in range(len(self.st["index"])))
                   if n > 0)

    def partner(self, i: int):
        """The subject's first recording (by file name) of the other
        condition, or None."""
        _, subj, cond = self.st["index"][i]
        return self._first.get((subj, "fast" if cond == "slow" else "slow"))

    def deviants(self):
        """Recordings whose control row the program redoes for their
        lengths alone: EEG and audio window counts differ, or a side or the
        partner has no window."""
        out = []
        for i in range(len(self.st["index"])):
            ne, na = self.eeg_windows(i), self.audio_windows(i)
            p = self.partner(i)
            if ne != na or ne == 0 or (p is not None and self.audio_windows(p) == 0):
                out.append(i)
        return out

    # ---- signals ----------------------------------------------------------

    def banded(self, i: int):
        """(47, 5, T_pad) banded EEG of recording i."""
        if i not in self._banded:
            x = self.q(self.st["eeg"][i].to(self.dtype))
            self._banded[i] = self.q(S.fir_bank(x, self.bank))
        return self._banded[i]

    def envelope_bands(self, i: int):
        """(5, n_rs_max) banded audio envelope at the EEG rate."""
        if i not in self._audio:
            h, up, down = S.resample_filter(self.cfg["fs_eeg"], self.cfg["fs_audio"])
            n_a = min(int(self.st["ns_a"][i]), self.st["audio"].shape[-1])
            x = self.q(self.st["audio"][i, :n_a].to(self.dtype))
            rs = self.q(S.resample_poly(x, n_a, up, down, h))
            pad = x.new_zeros(self.cfg["n_rs_max"])
            pad[:len(rs)] = rs
            env = self.q(S.hilbert_envelope(pad, S.envelope_lowpass(self.cfg["fs_eeg"]),
                                            S.hilbert_fir()))
            self._audio[i] = self.q(S.fir_bank(env, self.bank))
        return self._audio[i]

    def eeg_distances(self, i: int, idx_by_band):
        """(sum of windows, 47, 47) distances of the given windows a band."""
        b = self.banded(i)
        wins = [S.windows(b[:, bd], self.cfg["n_win_max"], self.win, self.step)
                .permute(1, 0, 2)[torch.as_tensor(np.asarray(idx), device=self.dev)]
                for bd, idx in enumerate(idx_by_band)]
        return self.q(S.correlation_distance(torch.cat(wins)))

    def audio_clouds(self, i: int, idx):
        """Takens distance matrices (5·len(idx), P, P), padded with 3.0, and
        the valid point counts, of the audio windows idx in every band."""
        env = self.envelope_bands(i)
        P_ = -(-(self.win - (self.cfg["takens_dim"] - 1)) // self.cfg["takens_subsample"])
        pad = self.cfg["max_edge_length"] + 1.0
        dms, npts = [], []
        for bd in range(len(BAND_NAMES)):
            wins = S.windows(env[bd], self.cfg["n_win_max"], self.win, self.step)
            tau = int(S.autocorr_tau(wins[int(idx[0])], self.win // 2)) if len(idx) else 1
            for w in idx:
                pts = self.q(S.takens_cloud(wins[int(w)], tau, self.cfg["takens_dim"],
                                            self.cfg["takens_subsample"]))
                k = pts.shape[0]
                dm = torch.full((P_, P_), pad, dtype=self.dtype, device=self.dev)
                dm[:k, :k] = self.q(S.cloud_distances(pts))
                dm.fill_diagonal_(0.0)
                dms.append(dm)
                npts.append(k)
        return torch.stack(dms), torch.as_tensor(npts, device=self.dev)

    # ---- diagrams -------------------------------------------------------

    def _diagrams(self, dm, n_pts=None):
        t = time.perf_counter()
        out = P.diagrams(dm, n_pts, self.cfg["max_edge_length"])
        self._tick(f"diagrams_n{dm.shape[-1]}", t)
        return out

    def _tick(self, name, t):
        self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t

    def prepare(self, eeg=(), audio=()):
        """Work out, in one batch a side, the diagrams later calls ask for:
        eeg [(recording, selection per band)], audio [(recording, window
        cap or None)].  An audio side is kept by the windows it selects
        from, so a recording's own diagrams serve as a partner's too."""
        todo = [("eeg", i, tuple(map(tuple, idx))) for i, idx in eeg
                if ("eeg", i, tuple(map(tuple, idx))) not in self._dg]
        if todo:
            t = time.perf_counter()
            dms = [self.eeg_distances(i, [np.asarray(x) for x in idx]) for _, i, idx in todo]
            self._tick("eeg_signal", t)
            self._split(todo, self._diagrams(torch.cat(dms)), [len(d) for d in dms])
        todo = list(dict.fromkeys(self._audio_key(i, cap) for i, cap in audio))
        todo = [k for k in todo if k not in self._dg]
        if todo:
            t = time.perf_counter()
            made = [self.audio_clouds(i, paired_window_idx(n)) for _, i, n in todo]
            self._tick("audio_signal", t)
            dm = torch.cat([m[0] for m in made])
            npts = torch.cat([m[1] for m in made])
            self._split(todo, self._diagrams(dm, npts), [len(m[0]) for m in made],
                        [m[1] for m in made])

    def _split(self, keys, out, sizes, npts=None):
        lo = 0
        for k, (key, size) in enumerate(zip(keys, sizes)):
            part = {name: v[lo:lo + size] for name, v in out.items() if torch.is_tensor(v)}
            if npts is not None:
                part["n_pts"] = npts[k]
            self._dg[key] = part
            lo += size

    def _eeg_dg(self, i, idx_by_band):
        key = ("eeg", i, tuple(map(tuple, idx_by_band)))
        self.prepare(eeg=[(i, idx_by_band)])
        return self._dg[key]

    def _audio_key(self, i, cap):
        n = self.audio_windows(i) if cap is None else min(self.audio_windows(i), cap)
        return ("audio", i, n)

    def _audio_idx(self, i, cap):
        return paired_window_idx(self._audio_key(i, cap)[2])

    @staticmethod
    def _h1(out, w: int):
        fin = out["mask"][w] & torch.isfinite(out["deaths"][w])
        return torch.stack([out["births"][w][fin], out["deaths"][w][fin]], dim=-1)

    @staticmethod
    def _h0(out, w: int):
        return out["h0_deaths"][w][out["h0_mask"][w]]

    # ---- answers --------------------------------------------------------

    def feature_rows(self, recs, K: int, resolution: float = 0.0):
        """(len(recs), 220) rows of the features stage; bars of persistence
        at most `resolution` left out (see `features.window_features`)."""
        sel = {}
        for i in recs:
            stem = self.st["index"][i][0].replace(".mat", "")
            nw = self.eeg_windows(i)
            sel[i] = [md5_window_sample(stem, band, nw, K, self.cfg["window_sample_seed"])
                      for band in BAND_NAMES]
        self.prepare(eeg=list(sel.items()))
        rows = []
        for i in recs:
            dg = self._eeg_dg(i, sel[i])
            f = self.q(F.window_features(dg, resolution)).reshape(
                len(BAND_NAMES), -1, 2, F.N_FEATURES)
            rows.append(F.feature_row(self.q(F.mean_std(f.flatten(-2))).reshape(
                len(BAND_NAMES), 2, F.N_FEATURES, 2)))
        return torch.stack(rows)

    def _audio_side(self, i: int, n_cap=None):
        """Own audio diagrams of recording i over the even selection of its
        first min(own, cap) windows: (diagrams, valid count, degen (5, K)
        numpy)."""
        key = self._audio_key(i, n_cap)
        self.prepare(audio=[(i, n_cap)])
        out = self._dg[key]
        n = key[2]
        degen = (out["n_pts"] < 3).reshape(len(BAND_NAMES), K_CMP).cpu().numpy()
        return out, min(n, K_CMP), degen

    def _requests(self, recs, redone):
        """The diagrams comparison_rows(recs) and control_rows(redone) ask
        for."""
        eeg, audio = [], []
        for i in recs:
            ne = self.eeg_windows(i)
            idx = self._audio_idx(i, ne)
            eeg.append((i, [idx] * len(BAND_NAMES)))
            audio.append((i, ne))
        for i in redone:
            eeg.append((i, [own_window_idx(self.eeg_windows(i))] * len(BAND_NAMES)))
            audio.append((i, None))
        for i in list(recs) + list(redone):
            if self.partner(i) is not None:
                audio.append((self.partner(i), None))
        return eeg, audio

    def _batched(self, fn, groups):
        """`fn` over the pairs of every group in one batch → one numpy array
        of costs a group."""
        flat = [p for g in groups for p in g]
        t = time.perf_counter()
        w = fn(flat, self.dtype, self.dev).cpu().numpy() if flat else np.zeros(0)
        self._tick("wasserstein", t)
        return np.split(w, np.cumsum([len(g) for g in groups])[:-1])

    @staticmethod
    def _h1_costs(pairs, dtype, device):
        return W.h1_pairs(W.sinkhorn_log, pairs, dtype, device)

    def comparison_rows(self, recs, redone=()):
        """{recording: (5, 3) [w_h0, w_h1, w_mismatched]} of the fused
        comparison pass (the mismatched entry NaN without a partner).  The
        diagrams of control_rows(redone) are worked out in the same batch."""
        eeg, audio = self._requests(recs, redone)
        self.prepare(eeg, audio)
        h0, h1, cells = [], [], []     # pairs a group; (recording, band, column)
        for i in recs:
            ne = self.eeg_windows(i)
            a_out, kmax, a_deg = self._audio_side(i, ne)
            e_out = self._eeg_dg(i, [self._audio_idx(i, ne)] * len(BAND_NAMES))
            j = self.partner(i)
            if j is not None:
                m_out, _, m_deg = self._audio_side(j)
                n_mis = min(ne, self.audio_windows(j), K_CMP)
            for bd in range(len(BAND_NAMES)):
                ks = [k for k in range(kmax) if not a_deg[bd, k]]
                w = bd * K_CMP
                h0.append([(self._h0(e_out, w + k), self._h0(a_out, w + k)) for k in ks])
                h1.append([(self._h1(e_out, w + k), self._h1(a_out, w + k)) for k in ks])
                cells.append((i, bd, 1))
                if j is not None:
                    h1.append([(self._h1(e_out, w + k), self._h1(m_out, w + k))
                               for k in range(n_mis) if not m_deg[bd, k]])
                    cells.append((i, bd, 2))
        vals = {i: np.full((len(BAND_NAMES), 3), np.nan) for i in recs}
        h0_cells = [c for c in cells if c[2] == 1]
        for (i, bd, _), w in zip(h0_cells, self._batched(W.h0_pairs, h0)):
            vals[i][bd, 0] = w.mean() if len(w) else 0.0
        for (i, bd, c), w in zip(cells, self._batched(self._h1_costs, h1)):
            vals[i][bd, c] = w.mean() if len(w) else 0.0
        return {i: self.q(torch.as_tensor(v)).numpy() for i, v in vals.items()}

    def _own_side(self, i: int):
        """Own-selection EEG of i (count, selection) and its own audio
        (diagrams, the non-degenerate windows a band, in order)."""
        e_idx = own_window_idx(self.eeg_windows(i))
        a_out, kmax, a_deg = self._audio_side(i)
        comp = [[k for k in range(kmax) if not a_deg[bd, k]] for bd in range(len(BAND_NAMES))]
        return len(e_idx), e_idx, a_out, comp

    def control_rows(self, recs):
        """{recording: (5, 2) [w_matched, w_mismatched]} by the control's
        exact pairing."""
        eeg, audio = self._requests((), recs)
        self.prepare(eeg, audio)
        groups, cells = [], []
        for i in recs:
            len_e, e_idx, a_out, comp = self._own_side(i)
            e_out = self._eeg_dg(i, [e_idx] * len(BAND_NAMES)) if len_e else None
            j = self.partner(i)
            m = self._own_side(j) if j is not None else None
            for bd in range(len(BAND_NAMES)):
                sides = [(a_out, comp[bd])] + ([(m[2], m[3][bd])] if m else [])
                for c, (o, cl) in enumerate(sides):
                    groups.append([(self._h1(e_out, bd * len_e + k),
                                    self._h1(o, bd * K_CMP + cl[k]))
                                   for k in range(min(len_e, len(cl)))])
                    cells.append((i, bd, c))
        vals = {i: np.full((len(BAND_NAMES), 2), np.nan) for i in recs}
        for (i, bd, c), w in zip(cells, self._batched(self._h1_costs, groups)):
            w = w[np.isfinite(w)]             # the reference's nanmean
            if len(w):
                vals[i][bd, c] = w.mean()
        return {i: self.q(torch.as_tensor(v)).numpy() for i, v in vals.items()}
