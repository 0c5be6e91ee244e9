"""The runner's data-parallel mesh on the CPU: `StudyRunner(mesh=["cpu",
"cpu"])`, the port's counterpart of tests/test_sharding.py's sharded study
and tests/test_eeg_bank.py's sharded bank path, on 3 recordings of
`torch_tiny_data` (0.2 s windows, pads 600 / 97,020 / 560, 2 feature windows
a band), so that a batch of 2 leaves a last batch of 1, shorter than dp.

What is held, with the bank on and off:
  * X, labels and filenames of the two-shard runner equal the single-device
    runner's at the same `eeg_batch` bit for bit;
  * the two-shard runner's comparison rows equal bit for bit those of the
    single-device runner at the shard's batch (eeg_batch / dp): a shard's
    calls are that runner's calls.  At the same `eeg_batch` they agree
    within test_torch_runner.py's row tolerances (rtol 2e-4 for the H1
    Wasserstein values, else 1e-4, atol 1e-5), not bit for bit: on the CPU
    the single-device runner's own rows move with its batch at the float32
    rounding level (its reductions and the plain tiered Sinkhorn's chunk
    widths follow the batch's shape), and the two-shard runner runs batches
    of eeg_batch / dp;
  * the JAX runner on a two-device virtual CPU mesh gives X within
    test_torch_runner.py's X tolerance (rtol 1e-4, atol 1e-5);
  * `eeg_batch` rounds up to a multiple of dp as the JAX runner's does, and
    mesh="auto" is off without a card."""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tda_eeg_audio_tpu.config import DEFAULT_CONFIG as JAX_CONFIG, GOOD_ELECTRODES
from tda_eeg_audio_tpu.io import device_store as jstore
from tda_eeg_audio_tpu.models import study as jstudy
from tda_eeg_audio_tpu_torch.convert import config_from_jax, store_from_numpy
from tda_eeg_audio_tpu_torch.models import programs as tprog
from tda_eeg_audio_tpu_torch.models import study as tstudy
from torch_tiny_data import N_RS_MAX, T_AUDIO_PAD, T_EEG_PAD, TinyDataset

torch.set_num_threads(1)

JCFG = dataclasses.replace(JAX_CONFIG, window_sec=0.2, fir_numtaps=101,
                           wasserstein_backend="sinkhorn")
TCFG = config_from_jax(dataclasses.asdict(JCFG))
MESH = ["cpu", "cpu"]
K_FEAT = 2
H1_KEYS = ("wasserstein_h1", "w_mismatched")
# the runs: (name, eeg_batch, mesh)
RUNS = (("mesh", 2, MESH), ("single", 2, None), ("single_b1", 1, None))
PROGRAMS = ("eeg_feature_program", "audio_h1_program", "comparison_from_bank",
            "comparison_program")


@pytest.fixture(scope="module")
def stores():
    ds = TinyDataset(JCFG, n_subjects=2)
    ds.index = ds.index[:3]          # bb01 slow / fast, bb02 slow
    jst = jstore.build_from_dataset(ds, GOOD_ELECTRODES, T_EEG_PAD, T_AUDIO_PAD)
    jst.index = ds.index
    tst = store_from_numpy(np.asarray(jst.eeg), np.asarray(jst.audio), jst.ns_e,
                           jst.ns_a, jst.metas, ds.index, device="cpu")
    return jst, tst


def _runner(store, eeg_batch, mesh, bank=True):
    return tstudy.StudyRunner(store, TCFG, eeg_batch=eeg_batch, verbose=False,
                              eeg_bank=bank, t_eeg_pad=T_EEG_PAD,
                              t_audio_pad=T_AUDIO_PAD, n_rs_max=N_RS_MAX, mesh=mesh)


@pytest.fixture(scope="module")
def runs(stores):
    """Each run's features and comparison, with the bank on and off, and the
    batch sizes each program was called with."""
    _, tst = stores
    out = {}
    wrapped = {k: getattr(tprog, k) for k in PROGRAMS}
    for bank in (True, False):
        for name, batch, mesh in RUNS:
            calls = []

            def record(k):
                def call(*a, **kw):
                    batch = a[3] if k == "comparison_from_bank" else a[0]
                    calls.append((k, str(kw["device"]), int(batch.shape[0])))
                    return wrapped[k](*a, **kw)
                return call

            r = _runner(tst, batch, mesh, bank)
            with pytest.MonkeyPatch.context() as mp:
                for k in PROGRAMS:
                    mp.setattr(tprog, k, record(k))
                F = r.compute_feature_dataset(max_windows_per_band=K_FEAT)
                rows = r.run_comparison(n_permutations=10)["detailed_rows"]
            out[bank, name] = dict(runner=r, F=F, rows=rows, calls=calls)
    return out


@pytest.mark.parametrize("bank", [True, False], ids=["bank", "no_bank"])
def test_sharded_features_equal_single_device(runs, bank):
    (Xm, ym, sm, fm, mm), (Xs, ys, ss, fs, ms) = (runs[bank, k]["F"] for k in ("mesh", "single"))
    assert Xm.shape == (3, 220) and np.isfinite(Xm).all()
    np.testing.assert_array_equal(Xm, Xs)
    np.testing.assert_array_equal(ym, ys)
    np.testing.assert_array_equal(sm, ss)
    assert fm == fs and mm == ms
    np.testing.assert_array_equal(Xm, runs[bank, "single_b1"]["F"][0])


@pytest.mark.parametrize("bank", [True, False], ids=["bank", "no_bank"])
def test_shards_take_contiguous_slices(runs, bank):
    """Batches [2, 1] of 3 recordings: two shards of 1, then one (the other
    shard's slice is empty); the single-device runner calls with 2 then 1.
    With the bank, every comparison batch is served by it."""
    calls = runs[bank, "mesh"]["calls"]
    feats = [c for c in calls if c[0] == "eeg_feature_program"]
    assert feats == [("eeg_feature_program", "cpu", 1)] * 3
    cmp_name = "comparison_from_bank" if bank else "comparison_program"
    assert [c for c in calls if c[0] == cmp_name] == [(cmp_name, "cpu", 1)] * 3
    # the mismatch partners of (bb01, slow), (bb01, fast) and (bb02, fast):
    # recordings 0, 1 and 2, batches [2, 1] again
    assert [c for c in calls if c[0] == "audio_h1_program"] == \
        [("audio_h1_program", "cpu", 1)] * 3
    single = [c[2] for c in runs[bank, "single"]["calls"] if c[0] == "eeg_feature_program"]
    assert single == [2, 1]
    for k in ("mesh", "single"):
        r = runs[bank, k]["runner"]
        assert (r._bank_served, r._bank_fallback) == ((2, 0) if bank else (0, 0))


def _rows_equal(got, want):
    assert len(got) == len(want) == 15
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k, v in w.items():
            same = g[k] == v or (isinstance(v, float) and math.isnan(v)
                                 and math.isnan(g[k]))
            assert same, (w["filename"], w["condition"], w["band"], k, g[k], v)


@pytest.mark.parametrize("bank", [True, False], ids=["bank", "no_bank"])
def test_sharded_comparison_rows_equal_single_device(runs, bank):
    rows = runs[bank, "mesh"]["rows"]
    _rows_equal(rows, runs[bank, "single_b1"]["rows"])
    worst = 0.0
    for g, w in zip(rows, runs[bank, "single"]["rows"]):
        for k, v in w.items():
            if isinstance(v, float):
                rtol = 2e-4 if k in H1_KEYS else 1e-4
                np.testing.assert_allclose(g[k], v, rtol=rtol, atol=1e-5, equal_nan=True,
                                           err_msg=k)
                if np.isfinite(v):
                    worst = max(worst, abs(g[k] - v) / (1e-5 + rtol * abs(v)))
            else:
                assert g[k] == v, k
    print(f"rows at the same eeg_batch, bank {bank}: worst error / tolerance {worst:.3f}")


def test_sharded_X_matches_jax_runner_on_its_mesh(stores, runs):
    """The JAX runner's features stage dp-sharded over a two-device virtual
    CPU mesh (the bank off: X does not use it) against the port's two-shard
    runner's X."""
    jst, _ = stores
    n_win_max = (T_EEG_PAD - JCFG.win_samples) // JCFG.step_samples + 1
    with pytest.MonkeyPatch.context() as mp:
        for k, v in (("T_EEG_PAD", T_EEG_PAD), ("T_AUDIO_PAD", T_AUDIO_PAD),
                     ("N_RS_MAX", N_RS_MAX), ("N_WIN_MAX", n_win_max)):
            mp.setattr(jstudy, k, v)
        jr = jstudy.StudyRunner(jst, JCFG, eeg_batch=2, tda_chunk=64, verbose=False,
                                mesh=Mesh(np.array(jax.devices()[:2]), ("dp",)),
                                eeg_bank=False)
        Xj, yj, sj, fj, _ = jr.compute_feature_dataset(max_windows_per_band=K_FEAT)
    Xt, yt, st, ft, _ = runs[False, "mesh"]["F"]
    print("X vs the JAX runner on its mesh: worst error / tolerance "
          f"{float((np.abs(Xt - Xj) / (1e-5 + 1e-4 * np.abs(Xj))).max()):.3f}")
    np.testing.assert_allclose(Xt, Xj, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_array_equal(st, sj)
    assert list(ft) == list(fj)


@pytest.mark.parametrize("batch,dp", [(1, 2), (3, 2), (4, 2), (5, 3), (16, 4)])
def test_eeg_batch_rounds_up_as_jax(stores, batch, dp):
    jst, tst = stores
    r = _runner(tst, batch, ["cpu"] * dp)
    jr = jstudy.StudyRunner(jst, JCFG, eeg_batch=batch, verbose=False,
                            mesh=Mesh(np.array(jax.devices()[:dp]), ("dp",)))
    assert r.eeg_batch == jr.eeg_batch == -(-batch // dp) * dp
    assert _runner(tst, batch, None).eeg_batch == batch
    per = r.eeg_batch // dp
    idxs = list(range(r.eeg_batch - 1))      # one short of a full batch
    shards = list(r._shards(idxs))
    parts = [p for _, p, _ in shards]
    assert [i for p in parts for i in p] == idxs
    assert all(idxs[sl] == p for _, p, sl in shards)
    assert all(len(p) == per for p in parts[:-1]) and 0 < len(parts[-1]) <= per


def test_mesh_auto_is_off_without_a_card_and_bad_meshes_raise(stores):
    _, tst = stores
    assert not torch.cuda.is_available()
    assert _runner(tst, 2, "auto").mesh is None
    assert _runner(tst, 2, None).mesh is None
    assert _runner(tst, 2, MESH).mesh == [torch.device("cpu")] * 2
    with pytest.raises(RuntimeError):          # no fallback for a shard's card
        _runner(tst, 2, ["cpu", "cuda:0"])
    for bad in ("on", [], ["meta"]):
        with pytest.raises(ValueError):
            _runner(tst, 2, bad)
