"""The runner's exact redo of overflowed recordings (port, CPU), forced at
tiny size: a features arena of 8 creators overflows every window, so every
recording's aggregate is recomputed through `_staged_feature_agg`, its bank
row is dropped and the comparison falls back to `comparison_program`; and a
recording whose fused rows carry the overflow flag has them recomputed by
`run_comparison` through `_staged_comparison_rows`.

Each is held against the same runner without the forced overflow.
Tolerances: redone features rtol 1e-5 / atol 1e-6 (same bars, float32 sums
in another order); the fallback batch's rows exactly equal to the bank
path's; redone comparison rows: integers exact, W_H0 rtol 1e-5, W_H1 rtol
2e-4 (un-tiered log-domain Sinkhorn against the tiered stabilized one;
worst observed 2.2e-5), Spearman r and p atol 1e-4."""
import dataclasses

import numpy as np
import pytest
import torch

from tda_eeg_audio_tpu_torch.config import DEFAULT_CONFIG, GOOD_ELECTRODES
from tda_eeg_audio_tpu_torch.io.device_store import build_from_dataset
from tda_eeg_audio_tpu_torch.models.study import StudyRunner
from torch_tiny_data import N_RS_MAX, T_AUDIO_PAD, T_EEG_PAD, TinyDataset

torch.set_num_threads(1)


def _runner(store, cfg, **kw):
    return StudyRunner(store, cfg, eeg_batch=4, verbose=False,
                       t_eeg_pad=T_EEG_PAD, t_audio_pad=T_AUDIO_PAD,
                       n_rs_max=N_RS_MAX, **kw)


@pytest.fixture(scope="module")
def wide():
    """One subject's slow and fast recording (6 and 7 windows) through the
    runner with arenas wide enough: the reference for both redo paths."""
    cfg = dataclasses.replace(DEFAULT_CONFIG, window_sec=0.2, fir_numtaps=101)
    ds = TinyDataset(cfg, n_subjects=1, n_windows={0: 6, 1: 7})
    store = build_from_dataset(ds, GOOD_ELECTRODES, T_EEG_PAD, T_AUDIO_PAD,
                               device="cpu")
    r = _runner(store, cfg)
    X = r.compute_feature_dataset()[0]
    rows = r.run_comparison(n_permutations=10)["detailed_rows"]
    assert r.redo_counts == dict(features=0, comparison=0, control_deviants=0)
    assert (r._bank_served, r._bank_fallback) == (1, 0)
    return dict(cfg=cfg, store=store, X=X, rows=rows)


def test_feature_overflow_is_redone_and_bank_falls_back(wide):
    r = _runner(wide["store"], wide["cfg"], feature_na_max=8)
    X, y, subjects, filenames, meta = r.compute_feature_dataset()
    # both recordings redone, at the redo's arena of 128 (wide enough here,
    # so nothing had to go on to the host engine)
    assert r.redo_counts["features"] == 2
    np.testing.assert_allclose(X, wide["X"], rtol=1e-5, atol=1e-6)
    assert r._eeg_bank["slot"] == {}            # truncated rows serve nothing
    rows = r.run_comparison(n_permutations=10)["detailed_rows"]
    assert (r._bank_served, r._bank_fallback) == (0, 1)
    assert rows == wide["rows"]                 # in-call path == bank path


def test_flagged_recording_is_redone_through_the_staged_path(wide):
    """One recording's rows flagged as overflowed after the fused pass:
    `run_comparison` recomputes them from exact diagrams with the un-tiered
    Sinkhorn and keeps the flag; the other recording's rows stay as they
    were."""
    r = _runner(wide["store"], wide["cfg"], eeg_bank=False)
    for row in r._fused_rows():
        if row["condition"] == "slow":
            row["overflow"] = True
    rows = r.run_comparison(n_permutations=10)["detailed_rows"]
    assert r.redo_counts["comparison"] == 1 and len(rows) == len(wide["rows"]) == 10
    for got, want in zip(rows, wide["rows"]):
        if want["condition"] == "fast":
            assert got == want
            continue
        assert got["overflow"] and not want["overflow"]
        for k, v in want.items():
            # w_mismatched stays the fused pass's: the control redoes
            # flagged recordings itself and never reads it
            if k in ("overflow", "w_mismatched"):
                continue
            if not isinstance(v, float):
                assert got[k] == v, k
            elif k == "wasserstein_h0":
                np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
            elif k == "wasserstein_h1":
                np.testing.assert_allclose(got[k], v, rtol=2e-4, err_msg=k)
                print(f"{got['band']}: w_h1 staged / fused − 1 = {got[k] / v - 1:.2e}")
            else:
                np.testing.assert_allclose(got[k], v, atol=1e-4, err_msg=k)
