"""The preprocessed/ and graphs/ artifacts and the .mat loader, against the
reference package on the CPU.

  * `eeg_window_program` / `eeg_distance_program` on a padded batch;
  * `StudyRunner.write_preprocessed` / `write_graphs` of both runners on the
    same recordings (the tiny in-memory dataset of `test_torch_runner.py`,
    staged with the reference's `build_from_dataset` and carried over with
    `store_from_numpy`; 0.2 s windows, 101 taps): the same directories and
    file names, arrays within tolerance, preprocessing_metadata.csv equal;
  * `io.matfiles` on `scipy.io.savemat` files (transposed EEG, stereo and
    mono audio): index and loaded arrays equal to the reference loader's,
    and the device store built from them equal to the reference's store;
  * `utils.validation` (validate_distance_matrix, matrix_diagnostics) on
    valid and broken matrices, against the reference's and the features
    program's device diagnostics.

Tolerances: windowed signals, correlations and distances rtol 1e-4 /
atol 1e-5 (FFT filtering in float32 on both sides; worst error / tolerance
observed: the graphs/ arrays of 0.2 s windows 0.536, the programs' 1 s
windows 0.083, the preprocessed/ windows 0.036); window masks, window times, audio, shapes, file names and
the CSV exact; loaded .mat arrays, issues and diagnostics exact."""
import csv
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tda_eeg_audio_tpu.config import (DEFAULT_CONFIG as JAX_CONFIG,
                                      GOOD_ELECTRODES)
from tda_eeg_audio_tpu.io import device_store as jstore
from tda_eeg_audio_tpu.io import matfiles as jmat
from tda_eeg_audio_tpu.models import programs as jprog
from tda_eeg_audio_tpu.models import study as jstudy
from tda_eeg_audio_tpu_torch.convert import config_from_jax, store_from_numpy
from tda_eeg_audio_tpu_torch.io import device_store as tstore
from tda_eeg_audio_tpu_torch.io import matfiles as tmat
from tda_eeg_audio_tpu_torch.models import programs as tprog
from tda_eeg_audio_tpu_torch.models import study as tstudy
from torch_tiny_data import N_RS_MAX, T_AUDIO_PAD, T_EEG_PAD, TinyDataset

torch.set_num_threads(1)

JCFG = dataclasses.replace(JAX_CONFIG, window_sec=0.2, fir_numtaps=101)
TCFG = config_from_jax(dataclasses.asdict(JCFG))
N_WIN_MAX = (T_EEG_PAD - JCFG.win_samples) // JCFG.step_samples + 1
WORST = {}


def _close(got, want, name):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=name)
    WORST[name] = max(WORST.get(name, 0.0), float(
        (np.abs(got - want) / (1e-5 + 1e-4 * np.abs(want))).max(initial=0.0)))


def test_window_and_distance_programs_match_reference():
    """1 s windows: over 0.2 s ones band-limited channels correlate near ±1
    and the two packages' FFT rounding shows at ~1e-5 in the correlations."""
    jcfg = dataclasses.replace(JCFG, window_sec=1.0)
    tcfg = config_from_jax(dataclasses.asdict(jcfg))
    T, n_win_max = 800, 10
    rng = np.random.default_rng(0)
    ns = np.array([T, 650, 300, 200])
    eeg = np.zeros((4, 47, T), np.float32)
    for i, n in enumerate(ns):
        eeg[i, :, :n] = rng.standard_normal((47, n))
    jw, jm = jprog.eeg_window_program(jnp.asarray(eeg), jnp.asarray(ns), jcfg,
                                      n_win_max)
    tw, tm = tprog.eeg_window_program(eeg, ns, tcfg, n_win_max, device="cpu")
    assert tuple(tw.shape) == (4, 5, n_win_max, 47, jcfg.win_samples)
    assert tm.sum(1).tolist() == [9, 7, 1, 0]
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    _close(tw.numpy(), np.asarray(jw), "windows")
    jd, jc, jm2 = jprog.eeg_distance_program(jnp.asarray(eeg), jnp.asarray(ns),
                                             jcfg, n_win_max)
    td, tc, tm2 = tprog.eeg_distance_program(eeg, ns, tcfg, n_win_max, device="cpu")
    np.testing.assert_array_equal(tm2.numpy(), np.asarray(jm2))
    valid = np.asarray(jm2)
    _close(tc.numpy()[valid[:, None].repeat(5, 1)],
           np.asarray(jc)[valid[:, None].repeat(5, 1)], "correlations")
    _close(td.numpy()[valid[:, None].repeat(5, 1)],
           np.asarray(jd)[valid[:, None].repeat(5, 1)], "distances")


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    ds = TinyDataset(JCFG, n_subjects=2, n_windows={1: 3}, fails=(3,))
    jdir, tdir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("torch")
    with pytest.MonkeyPatch.context() as mp:
        for k, v in dict(T_EEG_PAD=T_EEG_PAD, T_AUDIO_PAD=T_AUDIO_PAD,
                         N_RS_MAX=N_RS_MAX, N_WIN_MAX=N_WIN_MAX).items():
            mp.setattr(jstudy, k, v)
        jst = jstore.build_from_dataset(ds, GOOD_ELECTRODES, T_EEG_PAD, T_AUDIO_PAD)
        jst.index = ds.index
        jr = jstudy.StudyRunner(jst, JCFG, eeg_batch=3, verbose=False, mesh=None)
        jrows = jr.write_preprocessed(jdir / "preprocessed")
        jn = jr.write_graphs(jdir / "graphs")
    tst = store_from_numpy(np.asarray(jst.eeg), np.asarray(jst.audio), jst.ns_e,
                           jst.ns_a, jst.metas, ds.index, device="cpu")
    tr = tstudy.StudyRunner(tst, TCFG, eeg_batch=3, verbose=False,
                            t_eeg_pad=T_EEG_PAD, t_audio_pad=T_AUDIO_PAD,
                            n_rs_max=N_RS_MAX)
    trows = tr.write_preprocessed(tdir / "preprocessed")
    tn = tr.write_graphs(tdir / "graphs")
    return dict(jdir=jdir, tdir=tdir, jrows=jrows, trows=trows, jn=jn, tn=tn,
                n=len(ds))


def _files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


@pytest.mark.parametrize("stage", ["preprocessed", "graphs"])
def test_artifact_files_match_reference(written, stage):
    jroot, troot = written["jdir"] / stage, written["tdir"] / stage
    names = _files(troot)
    assert names == _files(jroot)
    assert len(names) == written["n"] * (7 if stage == "preprocessed" else 10) + (
        stage == "preprocessed")
    for name in names:
        if not name.endswith(".npy"):
            continue
        got, want = np.load(troot / name), np.load(jroot / name)
        assert got.shape == want.shape and got.dtype == want.dtype, name
        if name.endswith(("window_times.npy", "audio.npy")):
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            _close(got, want, stage)


def test_preprocessing_metadata_matches_reference(written):
    assert written["trows"] == written["jrows"]
    assert written["tn"] == written["jn"] == written["n"]
    with open(written["tdir"] / "preprocessed" / "preprocessing_metadata.csv") as ft, \
            open(written["jdir"] / "preprocessed" / "preprocessing_metadata.csv") as fj:
        rt, rj = list(csv.reader(ft)), list(csv.reader(fj))
    assert rt == rj and len(rt) == written["n"] + 1
    assert rt[0] == ["filename", "n_electrodes", "n_samples", "duration_sec",
                     "fs_eeg", "bands", "n_windows", "condition"]
    short = [r for r in written["trows"] if r["filename"] == "bb01_ut01.mat"
             and r["condition"] == "fast"][0]
    assert short["n_windows"] == 3
    print("worst error / tolerance: "
          + str({k: round(v, 4) for k, v in sorted(WORST.items())}))


def _write_mat_tree(root, transpose, stereo, seed=0):
    from scipy.io import savemat

    rng = np.random.default_rng(seed)
    for cond in ("slow", "fast"):
        (root / cond).mkdir(parents=True)
        for s, dur in ((1, 0.9), (2, 1.1)):
            n_e, n_a = int(round(250 * dur)), int(44100 * dur)
            eeg = rng.standard_normal((65, n_e))
            audio = rng.standard_normal((n_a, 2) if stereo else (n_a, 1))
            savemat(str(root / cond / f"bb{s:02d}_ut01.mat"), dict(
                subeeg=eeg.T if transpose else eeg, y=audio,
                Fs=np.array([[44100]])))


@pytest.mark.parametrize("transpose,stereo", [(True, True), (False, False)])
def test_mat_dataset_matches_reference(tmp_path, transpose, stereo):
    _write_mat_tree(tmp_path, transpose, stereo)
    td, jd = tmat.MatDataset(tmp_path), jmat.MatDataset(tmp_path)
    assert td.index == jd.index and len(td) == 4
    assert [s for _, s, _ in td.index] == ["bb01", "bb02", "bb01", "bb02"]
    for i in range(len(td)):
        got, want = td.load(i), jd.load(i)
        assert set(got) == set(want)
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                assert got[k].dtype == v.dtype == np.float64
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            else:
                assert got[k] == v, k
        assert got["eeg_raw"].shape[0] == 65 and got["fs_eeg"] == 250
        assert got["audio"].ndim == 1
    # staged into the device store, as the CLI does
    ts = tstore.build_from_dataset(td, GOOD_ELECTRODES, T_EEG_PAD, T_AUDIO_PAD,
                                   device="cpu")
    js = jstore.build_from_dataset(jd, GOOD_ELECTRODES, T_EEG_PAD, T_AUDIO_PAD)
    np.testing.assert_array_equal(ts.eeg.numpy(), np.asarray(js.eeg))
    np.testing.assert_array_equal(ts.audio.numpy(), np.asarray(js.audio))
    np.testing.assert_array_equal(ts.ns_e, js.ns_e)
    assert ts.index == jd.index


def _matrices():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 40))
    ok = np.sqrt(np.clip(2 * (1 - np.corrcoef(x)), 0, None)).astype(np.float32)
    np.fill_diagonal(ok, 0)
    out = dict(valid=ok)
    out["asymmetric"] = ok.copy()
    out["asymmetric"][0, 1] += 0.1
    out["negative"] = ok.copy()
    out["negative"][0, 2] = out["negative"][2, 0] = -0.3
    out["diagonal"] = ok + np.eye(6, dtype=np.float32) * 0.2
    out["nan"] = ok.copy()
    out["nan"][2, 3] = out["nan"][3, 2] = np.nan
    out["inf"] = ok.copy()
    out["inf"][1, 4] = out["inf"][4, 1] = np.inf
    out["not_square"] = ok[:, :5]
    out["not_2d"] = ok[None]
    return out


@pytest.mark.parametrize("kind", sorted(_matrices()))
def test_distance_matrix_validation_matches_reference(kind):
    """The reference's validate_distance_matrix, its diagnostics-vector form
    on the host, and the device program's diagnostics give the same issues."""
    from tda_eeg_audio_tpu.utils import validation as jval
    from tda_eeg_audio_tpu_torch.utils import validation as tval

    dm = _matrices()[kind]
    got = tval.validate_distance_matrix(dm)
    assert got == jval.validate_distance_matrix(dm)
    assert got[0] == (kind == "valid")
    if dm.ndim != 2 or dm.shape[0] != dm.shape[1]:
        return
    diag = tval.matrix_diagnostics(dm)
    np.testing.assert_array_equal(diag, jval.matrix_diagnostics(dm))
    np.testing.assert_array_equal(
        diag, tprog._dm_diagnostics(torch.as_tensor(dm)).numpy())
    assert tval.issues_from_diagnostics(diag) == got[1]
