"""The EDA stage against the reference package on the CPU: `welch_psd`
against the reference's and against `scipy.signal.welch`; `run_eda` on a
host dataset and on the device store against the reference's `run_eda`
(summary dict, eda_summary.json, file_inventory.csv, figure file names).

Tolerances: welch_psd rtol 1e-4 / atol 1e-9 against both (float32 FFTs;
worst relative error 2.6e-7 against JAX, 2.6e-7 against scipy's float64 on
the prefix of a masked recording); frequencies rtol 2e-7, one float32 ULP
(exact where k·fs/nperseg is an integer, as at the EDA's nperseg = fs).  run_eda: counts,
names, orders and the cluster order exact; powers, RMS and durations
rtol 1e-4 (worst error / tolerance observed 0.0006)."""
import json

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from scipy import signal as sps

from tda_eeg_audio_tpu.config import DEFAULT_CONFIG, GOOD_ELECTRODES
from tda_eeg_audio_tpu.io import device_store as jstore
from tda_eeg_audio_tpu.models import eda as jeda
from tda_eeg_audio_tpu.ops import signal as jsig
from tda_eeg_audio_tpu_torch.convert import store_from_numpy
from tda_eeg_audio_tpu_torch.models import eda as teda
from tda_eeg_audio_tpu_torch.ops import signal as tsig
from torch_tiny_data import T_AUDIO_PAD, T_EEG_PAD, TinyDataset

torch.set_num_threads(1)
WORST = {}


@pytest.mark.parametrize("nperseg,noverlap", [(250, None), (256, 100), (101, None)])
def test_welch_psd_matches_reference_and_scipy(nperseg, noverlap):
    rng = np.random.default_rng(nperseg)
    x = rng.standard_normal((3, 4, 1500)).astype(np.float32)
    n = np.array([1500, 900, 350])
    f_t, p_t = tsig.welch_psd(torch.as_tensor(x), fs=250.0, nperseg=nperseg,
                              noverlap=noverlap, n=torch.as_tensor(n)[:, None])
    f_j, p_j = jsig.welch_psd(jnp.asarray(x), fs=250.0, nperseg=nperseg,
                              noverlap=noverlap, n=jnp.asarray(n)[:, None])
    # float32 frequencies: k·fs/nperseg rounds alike where it is an integer
    # (the EDA's nperseg = fs), within an ULP elsewhere
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=2e-7, atol=0)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-4, atol=1e-9)
    for i, ni in enumerate(n):      # only whole segments inside the prefix count
        f_s, p_s = sps.welch(x[i, :, :ni].astype(np.float64), fs=250.0,
                             nperseg=nperseg, noverlap=noverlap)
        np.testing.assert_allclose(f_t.numpy(), f_s, rtol=2e-7, atol=0)
        np.testing.assert_allclose(p_t[i].numpy(), p_s, rtol=1e-4, atol=1e-9)
    # without lengths: every segment, as scipy on the whole signal
    _, p_all = tsig.welch_psd(torch.as_tensor(x[0]), fs=250.0, nperseg=nperseg,
                              noverlap=noverlap)
    np.testing.assert_allclose(p_all.numpy(), sps.welch(
        x[0].astype(np.float64), fs=250.0, nperseg=nperseg, noverlap=noverlap)[1],
        rtol=1e-4, atol=1e-9)


def test_welch_psd_refuses_a_signal_shorter_than_a_segment():
    with pytest.raises(ValueError):
        tsig.welch_psd(torch.zeros(2, 100), nperseg=250)


def _same(got, want, path=""):
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, (float, np.floating)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=0, err_msg=path)
        kind = path.split(".")[1].split("[")[0]
        WORST[kind] = max(WORST.get(kind, 0.0),
                          abs(got - want) / (1e-4 * abs(want) + 1e-300))
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("kind", ["host_dataset", "store"])
def test_run_eda_matches_reference(kind, tmp_path):
    ds = TinyDataset(DEFAULT_CONFIG, n_subjects=4, seed=2)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    if kind == "store":
        jds = jstore.build_from_dataset(ds, GOOD_ELECTRODES, T_EEG_PAD, T_AUDIO_PAD)
        jds.index = ds.index
        tds = store_from_numpy(np.asarray(jds.eeg), np.asarray(jds.audio),
                               jds.ns_e, jds.ns_a, jds.metas, ds.index, device="cpu")
    else:
        jds = tds = ds
    want = jeda.run_eda(jds, DEFAULT_CONFIG, results_dir=jdir, eeg_batch=3,
                        t_pad=T_EEG_PAD, verbose=False)
    got = teda.run_eda(tds, DEFAULT_CONFIG, results_dir=tdir, eeg_batch=3,
                       t_pad=T_EEG_PAD, verbose=False, device="cpu")
    _same(got, want, "eda")
    assert got["n_recordings"] == 8 and got["n_subjects"] == 4
    assert json.loads((tdir / "eda_summary.json").read_text()).keys() == \
        json.loads((jdir / "eda_summary.json").read_text()).keys()
    assert (tdir / "file_inventory.csv").read_text().splitlines()[0] == \
        (jdir / "file_inventory.csv").read_text().splitlines()[0]
    figs = sorted(str(p.relative_to(tdir)) for p in tdir.rglob("*.png"))
    assert figs == sorted(str(p.relative_to(jdir)) for p in jdir.rglob("*.png"))
    assert len(figs) == 4
    print(f"{kind}: worst error / tolerance "
          + str({k: round(v, 4) for k, v in sorted(WORST.items())}))
