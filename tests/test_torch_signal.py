"""Port parity: geometry and signal ops of `tda_eeg_audio_tpu_torch` against
the JAX reference on the same numpy inputs (CPU).

Tolerances: geometry atol 1e-5; filter designs exact; FFT/conv/matmul
filters rtol 1e-4 (float32, different FFT/summation order); Takens and τ
exact (index arithmetic and one threshold decision per window)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tda_eeg_audio_tpu.ops import geometry as jgeo
from tda_eeg_audio_tpu.ops import signal as jsig
from tda_eeg_audio_tpu_torch.oracle import signal_ref as ref
from tda_eeg_audio_tpu_torch.ops import geometry as tgeo
from tda_eeg_audio_tpu_torch.ops import signal as tsig

torch.set_num_threads(2)


def _t(x):
    return torch.as_tensor(np.array(x))


def test_geometry_matches_jax():
    rng = np.random.default_rng(5)
    w = rng.standard_normal((3, 47, 250)).astype(np.float32)
    w[1, 3] = 0.0                                  # zero-variance channel
    r_j = np.asarray(jgeo.correlation_matrix(jnp.asarray(w)))
    r_t = tgeo.correlation_matrix(_t(w)).numpy()
    np.testing.assert_allclose(r_t, r_j, atol=1e-5)
    for method in ("euclidean", "abs", "standard", "sqrt"):
        d_j = np.asarray(jgeo.correlation_to_distance(jnp.asarray(r_j), method))
        d_t = tgeo.correlation_to_distance(_t(r_j), method).numpy()
        np.testing.assert_allclose(d_t, d_j, atol=1e-5)
    pts = rng.random((2, 30, 3)).astype(np.float32)
    mask = np.ones((2, 30), bool)
    mask[1, 21:] = False
    p_j = np.asarray(jgeo.pairwise_distances(jnp.asarray(pts), jnp.asarray(mask), 3.0))
    p_t = tgeo.pairwise_distances(_t(pts), _t(mask), 3.0).numpy()
    np.testing.assert_allclose(p_t, p_j, atol=1e-5)


def test_filter_designs_exact():
    np.testing.assert_array_equal(tsig.design_band_fir_bank(250, 4, 1537),
                                  jsig.design_band_fir_bank(250, 4, 1537))
    np.testing.assert_array_equal(tsig.design_band_fir_bank(250, 4, 101),
                                  jsig.design_band_fir_bank(250, 4, 101))
    np.testing.assert_array_equal(tsig.design_envelope_lowpass(250),
                                  jsig.design_envelope_lowpass(250))
    np.testing.assert_array_equal(tsig.design_hilbert_fir(), jsig.design_hilbert_fir())
    h_t, up_t, down_t = tsig.design_resample_poly_filter(250, 44100)
    h_j, up_j, down_j = jsig.design_resample_poly_filter(250, 44100)
    assert (up_t, down_t) == (up_j, down_j)
    np.testing.assert_array_equal(h_t, h_j)


@pytest.mark.parametrize("T,numtaps", [(4000, 1537), (300, 801)])
def test_bandpass_bank_and_windows_match_jax(T, numtaps):
    """Includes a signal shorter than the odd extension (T < numtaps/2),
    where the extension is clipped and the output shortens."""
    rng = np.random.default_rng(0)
    t = np.arange(T) / 250.0
    x = sum(np.sin(2 * np.pi * f * t + rng.uniform(0, 6, (4, 1)))
            for f in (2, 6, 10.5, 22, 41))
    x = (x + 0.5 * rng.standard_normal((4, T))).astype(np.float32)
    bank = jsig.design_band_fir_bank(250, 4, numtaps)
    y_j = np.asarray(jsig.bandpass_bank(jnp.asarray(x), jnp.asarray(bank)))
    y_t = tsig.bandpass_bank(_t(x), _t(bank)).numpy()
    assert y_t.shape == y_j.shape
    np.testing.assert_allclose(y_t, y_j, rtol=1e-4, atol=1e-4 * np.abs(y_j).max())
    n_win = (y_j.shape[-1] - 60) // 15 + 3         # two windows past the end
    w_j = np.asarray(jsig.sliding_windows(jnp.asarray(y_j), n_win, 60, 15))
    w_t = tsig.sliding_windows(_t(y_j), n_win, 60, 15).numpy()
    np.testing.assert_array_equal(w_t, w_j)       # NaN past the end on both


def test_hilbert_envelope_matches_jax_and_scipy():
    rng = np.random.default_rng(2)
    t = np.arange(4000) / 250.0
    x = (1 + 0.6 * np.sin(2 * np.pi * 3.7 * t)) * np.sin(2 * np.pi * 37.0 * t)
    x = (x + 0.05 * rng.standard_normal(len(t)))[None].astype(np.float32)
    mask = np.ones_like(x)
    mask[:, 3500:] = 0.0
    lp, hb = jsig.design_envelope_lowpass(250), jsig.design_hilbert_fir()
    e_j = np.asarray(jsig.hilbert_envelope(jnp.asarray(x), jnp.asarray(lp),
                                           jnp.asarray(hb), jnp.asarray(mask)))
    e_t = tsig.hilbert_envelope(_t(x), _t(lp), _t(hb), _t(mask)).numpy()
    np.testing.assert_allclose(e_t, e_j, rtol=1e-4, atol=1e-4 * np.abs(e_j).max())
    env_ref = ref.compute_envelope(x[0, :3500].astype(np.float64), 250)
    sl = slice(500, 3000)
    assert np.corrcoef(e_t[0, sl], env_ref[sl])[0, 1] > 0.999


def test_resample_poly_matches_jax_and_scipy():
    rng = np.random.default_rng(1)
    n = 44100 * 3 + 1234
    x = rng.standard_normal(n)
    h, up, down = tsig.design_resample_poly_filter()
    n_pad = 44100 * 4
    xp = np.zeros((2, n_pad), np.float32)
    xp[0, :n] = x
    xp[1, : n // 2] = x[: n // 2]
    n_in = np.array([n, n // 2])
    n_out_max = int(np.ceil(n_pad * up / down))
    y_j, no_j = jsig.resample_poly_device(jnp.asarray(xp), jnp.asarray(n_in),
                                          n_out_max, h, up, down)
    y_t, no_t = tsig.resample_poly_device(_t(xp), _t(n_in), n_out_max, h, up, down)
    np.testing.assert_array_equal(no_t.numpy(), np.asarray(no_j))
    y_j, y_t = np.asarray(y_j), y_t.numpy()
    np.testing.assert_allclose(y_t, y_j, rtol=1e-4, atol=1e-4 * np.abs(y_j).max())
    y_ref = ref.resample_audio(x)
    assert int(no_t[0]) == len(y_ref)
    err = np.abs(y_t[0, : len(y_ref)] - y_ref).max() / np.abs(y_ref).max()
    assert err < 5e-4


def test_tau_and_takens_exact():
    rng = np.random.default_rng(3)
    t = np.arange(250) / 250.0
    wins = [np.sin(2 * np.pi * f * t) + 0.1 * rng.standard_normal(250)
            for f in (1.0, 3.0, 7.5, 20.0, 45.0)]
    wins += [rng.standard_normal(250) for _ in range(11)]
    wins = np.stack(wins).astype(np.float32).reshape(4, 4, 250)
    tau_j = np.asarray(jsig.autocorr_tau(jnp.asarray(wins), 125))
    tau_t = tsig.autocorr_tau(_t(wins), 125).numpy()
    np.testing.assert_array_equal(tau_t, tau_j)
    taus = np.array([[1, 5, 20, 60], [102, 2, 3, 124], [7, 1, 1, 1],
                     [125, 30, 9, 4]])
    p_j, m_j = jsig.takens_embed(jnp.asarray(wins), jnp.asarray(taus), 3, 2, 124)
    p_t, m_t = tsig.takens_embed(_t(wins), _t(taus), 3, 2, 124)
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    n_j = np.asarray(jsig.minmax_normalize_points(p_j, m_j))
    n_t = tsig.minmax_normalize_points(p_t, m_t).numpy()
    np.testing.assert_allclose(n_t, n_j, rtol=1e-6, atol=1e-6)
