"""The port's EEG programs with `filter_impl="iir_scan"` against the JAX
package on the CPU, at the tiny shape of tests/test_torch_slice.py (0.2 s
windows, 2 recordings of 134 / 146 samples, 12 windows, K = 5).

The JAX package's float32 associative scan is off scipy by up to ~5e-3 of
the delta band's range (tests/test_torch_iir.py), which moves delta's
correlation distances by ~3e-2 and toggles bars; so the JAX programs run
here with float64 inputs under `jax.enable_x64`, where its scan is exact to
~1e-11 and the port's float64 recurrence is the one to match.  Its H1 code
does not trace in float64, so the features are held against the JAX
package's `window_tda_features` and `aggregate_mean_std` (float32) on the
float64 program's distances.  The comparison's pair distances and the
runner's staged features path and preprocessed/ artifact are held to the
port's own programs.

Tolerances: distances and correlations atol 5e-5 (the port computes them in
float32 from its float32 bands: worst 1.3e-5, in delta, where distances
near 0 magnify the correlation's rounding); features rtol 1e-4 / atol 1e-5
as in test_torch_slice.py; window masks and overflow flags exact.  Worst
cases are printed (`pytest -rP`)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tda_eeg_audio_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from tda_eeg_audio_tpu.models import programs as jprog
from tda_eeg_audio_tpu.ops.features import aggregate_mean_std as j_agg
from tda_eeg_audio_tpu_torch.convert import config_from_jax
from tda_eeg_audio_tpu_torch.models import programs as tprog

# one intra-op thread: the correlation matmul's rounding then does not
# depend on the machine's load (see test_torch_slice.py)
torch.set_num_threads(1)

B, N_WIN_MAX, K = 2, 12, 5


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(JAX_CONFIG, window_sec=0.2, filter_impl="iir_scan")
    tcfg = config_from_jax(dataclasses.asdict(jcfg))
    assert tcfg.filter_impl == "iir_scan"
    win, step = jcfg.win_samples, jcfg.step_samples
    n_e = np.array([win + 7 * step, win + 8 * step], np.int32)
    T = win + (N_WIN_MAX - 1) * step
    rng = np.random.default_rng(0)
    eeg = np.zeros((B, 47, T), np.float32)
    for i, n in enumerate(n_e):
        eeg[i, :, :n] = rng.standard_normal((47, n))
    use_idx = np.zeros((B, 5, K), np.int32)
    for b in range(B):
        nw = (n_e[b] - win) // step + 1
        for bd in range(5):
            use_idx[b, bd] = rng.choice(nw, K, replace=False)
    use_mask = np.ones((B, 5, K), bool)
    use_mask[1, 2, 4] = False
    with jax.enable_x64(True):
        dist, corr, wmask = jprog.eeg_distance_program(
            jnp.asarray(eeg.astype(np.float64)), jnp.asarray(n_e), jcfg, N_WIN_MAX)
        ref = tuple(np.asarray(a) for a in (dist, corr, wmask))
    return dict(jcfg=jcfg, tcfg=tcfg, eeg=eeg, n_e=n_e, use_idx=use_idx,
                use_mask=use_mask, ref=ref)


def test_distance_program_matches_jax(tiny):
    dist, corr, wmask = tprog.eeg_distance_program(
        tiny["eeg"], tiny["n_e"], tiny["tcfg"], N_WIN_MAX, device="cpu")
    j_dist, j_corr, j_wmask = tiny["ref"]
    np.testing.assert_array_equal(wmask.numpy(), j_wmask)
    m = j_wmask                                       # valid windows
    for b, name in enumerate(("delta", "theta", "alpha", "beta", "gamma")):
        err = max(float(np.abs(dist.numpy()[:, b][m] - j_dist[:, b][m]).max()),
                  float(np.abs(corr.numpy()[:, b][m] - j_corr[:, b][m]).max()))
        print(f"{name}: distances / correlations differ by {err:.3g}")
        assert err < 5e-5, name


def test_window_program_bands_the_windows(tiny):
    """eeg_window_program's windows are the distance program's inputs: the
    correlation of its windows is the distance program's correlation."""
    from tda_eeg_audio_tpu_torch.ops.geometry import correlation_matrix

    wins, wmask = tprog.eeg_window_program(tiny["eeg"], tiny["n_e"], tiny["tcfg"],
                                           N_WIN_MAX, device="cpu")
    _, corr, _ = tprog.eeg_distance_program(tiny["eeg"], tiny["n_e"], tiny["tcfg"],
                                            N_WIN_MAX, device="cpu")
    assert wins.shape == (B, 5, N_WIN_MAX, 47, 50)
    torch.testing.assert_close(correlation_matrix(wins)[wmask[:, None].expand(-1, 5, -1)],
                               corr[wmask[:, None].expand(-1, 5, -1)], rtol=0, atol=0)


def test_feature_program_matches_jax(tiny):
    agg, ovf = tprog.eeg_feature_program(
        tiny["eeg"], tiny["n_e"], tiny["use_idx"], tiny["use_mask"], tiny["tcfg"],
        K=K, device="cpu")
    j_dist = tiny["ref"][0].astype(np.float32)
    sel = np.take_along_axis(j_dist, tiny["use_idx"][:, :, :, None, None], axis=2)
    f, out = jprog.window_tda_features(jnp.asarray(sel.reshape(-1, 47, 47)),
                                       thresh=tiny["jcfg"].max_edge_length)
    feats = np.asarray(f).reshape(B, 5, K, 22)
    want = np.asarray(j_agg(jnp.asarray(feats), jnp.asarray(tiny["use_mask"])))
    want = want.reshape(B, 5, 2, 11, 2)
    got = agg.numpy()
    ratio = float((np.abs(got - want) / (1e-5 + 1e-4 * np.abs(want))).max())
    print(f"features: largest error / tolerance {ratio:.3g}")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    j_ovf = np.asarray(out["overflow"]).reshape(B, 5, K)
    np.testing.assert_array_equal(ovf.numpy(), (j_ovf & tiny["use_mask"]).any((1, 2)))


def test_pair_distances_follow_the_distance_program(tiny):
    """The comparison's EEG side without the bank (`_pair_distance_program`)
    filters through the same IIR bank: its paired windows' distances are the
    distance program's at the same window indices."""
    rng = np.random.default_rng(7)
    idx = torch.as_tensor(rng.integers(0, 8, (B, K)))
    eeg = torch.as_tensor(tiny["eeg"])
    n_e = torch.as_tensor(tiny["n_e"]).long()
    pair, kmask, n_pair = tprog._pair_distance_program(
        eeg, n_e, idx, torch.tensor([K, 3]), tiny["tcfg"], K, N_WIN_MAX)
    dist, _, _ = tprog.eeg_distance_program(tiny["eeg"], tiny["n_e"], tiny["tcfg"],
                                            N_WIN_MAX, device="cpu")
    want = dist.gather(2, idx[:, None, :, None, None].expand(-1, 5, -1, 47, 47))
    torch.testing.assert_close(pair, want.reshape(B, 5 * K, 47, 47), rtol=0, atol=1e-6)
    assert kmask.tolist() == [[True] * K, [True] * 3 + [False] * (K - 3)]


def test_staged_runner_and_preprocessed_artifact_with_the_iir_bank(tmp_path):
    """The runner's staged features path (`backend="host"`: the distance
    program, then every window on the host engine) and its preprocessed/
    artifact with filter_impl="iir_scan": complete finite rows that differ
    from the FIR run's (the filter is applied), and written windows equal to
    eeg_window_program's on the same recording."""
    from tda_eeg_audio_tpu_torch.config import DEFAULT_CONFIG, GOOD_ELECTRODES
    from tda_eeg_audio_tpu_torch.io.device_store import build_from_dataset
    from tda_eeg_audio_tpu_torch.models.study import StudyRunner
    from torch_tiny_data import N_RS_MAX, T_AUDIO_PAD, T_EEG_PAD, TinyDataset

    def runner(impl):
        cfg = dataclasses.replace(DEFAULT_CONFIG, window_sec=0.2, fir_numtaps=101,
                                  filter_impl=impl)
        store = build_from_dataset(TinyDataset(cfg, n_subjects=2), GOOD_ELECTRODES,
                                   T_EEG_PAD, T_AUDIO_PAD, device="cpu")
        return StudyRunner(store, cfg, eeg_batch=4, verbose=False, backend="host",
                           t_eeg_pad=T_EEG_PAD, t_audio_pad=T_AUDIO_PAD,
                           n_rs_max=N_RS_MAX)

    iir = runner("iir_scan")
    X, y, subjects, filenames, _ = iir.compute_feature_dataset()
    assert X.shape == (4, 220) and np.isfinite(X).all()
    X_fir = runner("fir").compute_feature_dataset()[0]
    assert X_fir.shape == X.shape and not np.array_equal(X, X_fir)
    rows = iir.write_preprocessed(tmp_path)
    assert len(rows) == 4
    rec = TinyDataset(iir.cfg, n_subjects=2).load(0)
    eeg = np.zeros((1, 47, T_EEG_PAD), np.float32)
    n = rec["eeg_raw"].shape[1]
    eeg[0, :, :n] = rec["eeg_raw"][list(GOOD_ELECTRODES)]
    wins, wmask = tprog.eeg_window_program(eeg, np.array([n]), iir.cfg,
                                           iir.n_win_max, device="cpu")
    stem = rec["filename"].replace(".mat", "")
    got = np.load(tmp_path / rec["condition"] / stem / "delta.npy")
    np.testing.assert_array_equal(got, wins[0, 0, :int(wmask[0].sum())].numpy())
