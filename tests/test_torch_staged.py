"""The staged host backend against the reference package on the CPU.

  * `run_tda(backend="host")`: every window on the port's host engine,
    against the reference's `run_tda(backend="host")` and against the port's
    own kernel route (the plain reduction for CPU tensors).
  * The port's `StudyRunner(backend="host")` with
    `wasserstein_backend="host_exact"` against the reference's runner with
    the same settings, on the tiny in-memory dataset of
    `test_torch_runner.py` (4 subjects × {slow, fast}, one recording whose
    audio is one window step short, one that fails to load), staged once
    with the reference's `build_from_dataset` and carried over with
    `store_from_numpy`; 0.2 s windows, 101 taps, eeg_batch 4.

Tolerances: diagrams from the host engine equal bit for bit (both engines
reduce the same float32 distances); features rtol 1e-5 / atol 1e-6.  Runner:
X rtol 1e-4 / atol 1e-5; detailed rows, control rows and band statistics:
integers, strings and flags exact, floats rtol 1e-4 / atol 1e-5 (the exact
Wasserstein matching adds no error of its own: it equals the reference
engine's bit for bit on equal diagrams; the distances are computed by each
package's own device program, in float32).  Worst error / tolerance observed
(pytest -rP): X 0.219, detailed rows 0.235, control rows 0.015, control
statistics 0.006."""
import dataclasses

import numpy as np
import pytest
import torch

from tda_eeg_audio_tpu.config import (DEFAULT_CONFIG as JAX_CONFIG,
                                      GOOD_ELECTRODES)
from tda_eeg_audio_tpu.io import device_store as jstore
from tda_eeg_audio_tpu.models import homology_exec as jexec
from tda_eeg_audio_tpu.models import study as jstudy
from tda_eeg_audio_tpu_torch.convert import config_from_jax, store_from_numpy
from tda_eeg_audio_tpu_torch.models import homology_exec as texec
from tda_eeg_audio_tpu_torch.models import study as tstudy
from torch_tiny_data import N_RS_MAX, T_AUDIO_PAD, T_EEG_PAD, TinyDataset

torch.set_num_threads(1)

FAILS, SHORT = 5, 2
EXACT_KEYS = ("births", "deaths", "mask", "h0_deaths", "h0_mask", "n_comp",
              "n_essential", "fin_mask")


def _eeg_dms(n_windows=24, seed=0):
    """Correlation distances of smoothed random 47-channel windows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_windows, 47, 80))
    x = np.cumsum(x, axis=-1)[..., ::2]
    x -= x.mean(-1, keepdims=True)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    r = np.clip(x @ np.swapaxes(x, 1, 2), -1, 1)
    d = np.sqrt(np.clip(2 * (1 - r), 0, None)).astype(np.float32)
    d = np.maximum(d, np.swapaxes(d, 1, 2))
    d[:, np.arange(47), np.arange(47)] = 0
    return d


def _clouds(n_windows=16, n=24, seed=1):
    """Padded 3-D clouds (padding points beyond the threshold) and their
    valid-point counts, some below 3 (the degenerate sentinel)."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(0, 1, (n_windows, n, 3))
    d = np.sqrt(((p[:, :, None] - p[:, None]) ** 2).sum(-1)).astype(np.float32)
    n_pts = rng.integers(1, n + 1, n_windows).astype(np.int32)
    n_pts[:3] = (1, 2, n)
    pad = np.arange(n)[None] >= n_pts[:, None]
    d[pad[:, :, None] | pad[:, None, :]] = 9.0
    d[:, np.arange(n), np.arange(n)] = 0
    return d, n_pts


@pytest.mark.parametrize("kind", ["eeg", "clouds"])
def test_run_tda_host_matches_reference(kind):
    if kind == "eeg":
        dms, n_pts = _eeg_dms(), None
    else:
        dms, n_pts = _clouds()
    got = texec.run_tda(torch.as_tensor(dms), 2.0, n_pts=n_pts, backend="host")
    want = jexec.run_tda(dms, 2.0, backend="host", n_pts=n_pts)
    for k in EXACT_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(got["features"].numpy(), want["features"],
                               rtol=1e-5, atol=1e-6)
    assert not bool(got["redone"].any())


def test_run_tda_host_equals_the_kernel_route():
    """The host engine and the kernel route (plain reduction on the CPU)
    give the same diagrams on the same matrices; the host backend keeps
    max(na_max, 128) columns, the kernel route na_max."""
    dms = torch.as_tensor(_eeg_dms(8, seed=3))
    host = texec.run_tda(dms, 2.0, na_max=96, backend="host")
    dev = texec.run_tda(dms, 2.0, na_max=96, backend="auto")
    assert host["births"].shape[1] == 128 and dev["births"].shape[1] == 96
    assert not bool(host["mask"][:, 96:].any())
    assert torch.equal(host["mask"][:, :96], dev["mask"])
    for k in ("births", "deaths"):      # the kernel route leaves pad slots as is
        assert torch.equal(torch.where(dev["mask"], host[k][:, :96], 0.0),
                           torch.where(dev["mask"], dev[k], 0.0)), k
    for k in ("h0_deaths", "h0_mask", "n_comp", "n_essential"):
        assert torch.equal(host[k], dev[k]), k
    torch.testing.assert_close(host["features"], dev["features"], rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        texec.run_tda(dms, 2.0, backend="pallas")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both runners' staged study with exact Wasserstein, each run once."""
    jcfg = dataclasses.replace(JAX_CONFIG, window_sec=0.2, fir_numtaps=101,
                               wasserstein_backend="host_exact")
    tcfg = config_from_jax(dataclasses.asdict(jcfg))
    ds = TinyDataset(jcfg, n_windows={SHORT: 5}, one_step_short_audio=(SHORT,),
                     fails=(FAILS,))
    n_win_max = (T_EEG_PAD - jcfg.win_samples) // jcfg.step_samples + 1
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstudy, "T_EEG_PAD", T_EEG_PAD)
        mp.setattr(jstudy, "T_AUDIO_PAD", T_AUDIO_PAD)
        mp.setattr(jstudy, "N_RS_MAX", N_RS_MAX)
        mp.setattr(jstudy, "N_WIN_MAX", n_win_max)
        jst = jstore.build_from_dataset(ds, GOOD_ELECTRODES, T_EEG_PAD, T_AUDIO_PAD)
        jst.index = ds.index
        jr = jstudy.StudyRunner(jst, jcfg, eeg_batch=4, tda_chunk=64,
                                verbose=False, mesh=None, backend="host")
        jout = dict(features=jr.compute_feature_dataset(),
                    comparison=jr.run_comparison(n_permutations=100),
                    control=jr.run_control())
    tst = store_from_numpy(np.asarray(jst.eeg), np.asarray(jst.audio), jst.ns_e,
                           jst.ns_a, jst.metas, ds.index, device="cpu")
    tr = tstudy.StudyRunner(tst, tcfg, eeg_batch=4, verbose=False,
                            backend="host", t_eeg_pad=T_EEG_PAD,
                            t_audio_pad=T_AUDIO_PAD, n_rs_max=N_RS_MAX)
    redone0 = texec.run_tda.redone
    tout = dict(features=tr.compute_feature_dataset(),
                comparison=tr.run_comparison(n_permutations=100),
                control=tr.run_control())
    return dict(jr=jr, tr=tr, j=jout, t=tout, ds=ds,
                windows_redone=texec.run_tda.redone - redone0)


WORST = {}


def _same(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, (float, np.floating)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                   equal_nan=True, err_msg=path)
        if np.isfinite(want):
            kind = path.split(".")[0].split("[")[0]
            WORST[kind] = max(WORST.get(kind, 0.0),
                              abs(got - want) / (1e-5 + 1e-4 * abs(want)))
    else:
        assert got == want, (path, got, want)


def test_runner_takes_the_staged_path(runs):
    tr = runs["tr"]
    assert tr.backend == "host" and not tr.on_device and not tr._fused
    assert not tr.use_eeg_bank and tr._eeg_bank is None
    assert tr._fused_cache is None          # the fused pass never ran
    assert runs["windows_redone"] == 0


def test_staged_features_match_reference(runs):
    Xt, yt, st, ft, mt = runs["t"]["features"]
    Xj, yj, sj, fj, mj = runs["j"]["features"]
    assert Xt.shape == Xj.shape == (7, 220) and np.isfinite(Xt).all()
    np.testing.assert_allclose(Xt, Xj, rtol=1e-4, atol=1e-5)
    WORST["X"] = float((np.abs(Xt - Xj) / (1e-5 + 1e-4 * np.abs(Xj))).max())
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_array_equal(st, sj)
    assert ft == fj and mt == mj


def test_staged_comparison_rows_match_reference(runs):
    ct, cj = runs["t"]["comparison"], runs["j"]["comparison"]
    _same(ct["detailed_rows"], cj["detailed_rows"], "rows")
    _same(ct["band_results"], cj["band_results"], "band_results")
    for k in set(cj) - {"band_results", "detailed_rows"}:
        assert ct[k] == cj[k], k
    assert len(ct["detailed_rows"]) == 7 * 5
    assert all(np.isfinite(r["wasserstein_h1"]) and np.isfinite(r["wasserstein_h0"])
               for r in ct["detailed_rows"])


def test_exact_control_matches_reference(runs):
    _same(runs["t"]["control"], runs["j"]["control"], "control")
    for b in runs["t"]["control"].values():
        assert b["n"] == 3 and set(b["by_condition"]) == {"slow", "fast"}


def test_control_rows_exact_pairing(runs):
    """The staged control's rows themselves (per recording and band) against
    the reference's, mismatched partners and NaN for the failed one."""
    tr, jr = runs["tr"], runs["jr"]
    mis = {("bb01", "slow"): 1, ("bb01", "fast"): 0, ("bb02", "slow"): 3,
           ("bb02", "fast"): 2}
    idx = [0, 1, 2, 3]
    rows_t = tr._control_rows_exact(idx, mis, tr._mismatch_own_cache([0, 1, 2, 3]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstudy, "T_EEG_PAD", T_EEG_PAD)
        mp.setattr(jstudy, "T_AUDIO_PAD", T_AUDIO_PAD)
        mp.setattr(jstudy, "N_RS_MAX", N_RS_MAX)
        mp.setattr(jstudy, "N_WIN_MAX",
                   (T_EEG_PAD - jr.cfg.win_samples) // jr.cfg.step_samples + 1)
        rows_j = jr._control_rows_exact(idx, mis, jr._mismatch_own_cache([0, 1, 2, 3]))
    _same(rows_t, rows_j, "control_rows")
    assert len(rows_t) == 4 * 5
    print("worst error / tolerance by kind: "
          + str({k: round(v, 3) for k, v in sorted(WORST.items())}))
