"""The exact Butterworth filtfilt bank (`filter_impl="iir_scan"`) of the port
against the JAX package and scipy on the CPU, and the CUDA kernel's host
side.  The kernel itself runs on the card only (`test_kernel_matches_plain_on_card`,
chip_smoke.py phase 10).

Tolerances, relative to each band's largest |reference| value:
  * port vs scipy's float64 `sosfiltfilt`: 1e-5 (the port's float64
    recurrence rounds only its float32 output; worst ~5e-8);
  * port vs the JAX package: the JAX package's own float32 associative-scan
    error sets it — 1e-2 in delta (poles nearest the unit circle; 3.9e-3
    the worst here, 5.3e-3 over longer random walks) and 1e-4 in the other
    bands (theta 4.9e-5 the worst here).  The port is the closer of the two
    to scipy, so the two differ by about the JAX package's error; each worst
    case is printed (`pytest -rP`);
  * the odd extension's clipped source index (n ≤ edge), n = 0 and the
    zeros beyond n are held exactly where exactness is the contract."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal as sps

from tda_eeg_audio_tpu.ops import signal as jsig
from tda_eeg_audio_tpu_torch.ops import iir_cuda as tic
from tda_eeg_audio_tpu_torch.ops import signal as tsig

torch.set_num_threads(1)

BANDS = ("delta", "theta", "alpha", "beta", "gamma")
JAX_TOL = dict(delta=1e-2, theta=1e-4, alpha=1e-4, beta=1e-4, gamma=1e-4)
T = 1200
NS = np.array([1200, 731, 20, 0])          # full, ragged, n ≤ edge (27), empty


def _walk(rng, shape):
    """Random walk plus noise: the low-frequency power that stresses the
    delta band's poles."""
    return (np.cumsum(rng.standard_normal(shape), -1)
            + rng.standard_normal(shape)).astype(np.float32)


@pytest.fixture(scope="module")
def bank():
    rng = np.random.default_rng(0)
    x = _walk(rng, (len(NS), 3, T))
    x = np.where(np.arange(T)[None, None, :] < NS[:, None, None], x, 0.0).astype(np.float32)
    n = NS[:, None]
    got = tsig.bandpass_bank_iir_scan(torch.as_tensor(x), torch.as_tensor(n),
                                      250, 4).numpy()
    fn = jax.jit(jsig.bandpass_bank_iir_scan, static_argnums=(2, 3))
    ref = np.asarray(fn(jnp.asarray(x), jnp.asarray(n), 250, 4))
    return x, got, ref


def _rel(got, ref):
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def test_designs_equal_the_reference():
    for lo, hi in ((0.5, 4.0), (4.0, 8.0), (30.0, 50.0)):
        for a, b in zip(tsig.design_butter_sos(lo, hi, 250),
                        jsig.design_butter_sos(lo, hi, 250)):
            np.testing.assert_array_equal(a, b)
    sos, zi = tsig.design_butter_band_bank(250, 4)
    jsos, jzi = jsig.design_butter_band_bank(250, 4)
    assert sos.shape == (5, 4, 6) and zi.shape == (5, 4, 2)
    np.testing.assert_array_equal(sos, jsos)
    np.testing.assert_array_equal(zi, jzi)


def test_bank_matches_jax_within_its_scan_error(bank):
    x, got, ref = bank
    assert got.shape == ref.shape == (len(NS), 3, 5, T) and got.dtype == np.float32
    for b, name in enumerate(BANDS):
        rel = _rel(got[..., b, :], ref[..., b, :])
        print(f"{name}: port vs JAX {rel:.3g} of max|ref| (tolerance {JAX_TOL[name]:g})")
        assert rel < JAX_TOL[name], name


def test_bank_zero_beyond_n_and_short_series_follow_jax(bank):
    """Zeros beyond n everywhere (all zeros at n = 0); at n = 20 ≤ edge the
    extension reads past n (its source index clipped to T − 1, as the JAX
    package does) and the port still follows the JAX output."""
    x, got, ref = bank
    for i, n in enumerate(NS):
        assert np.all(got[i, ..., n:] == 0.0) and np.all(ref[i, ..., n:] == 0.0)
    for b, name in enumerate(BANDS):
        rel = _rel(got[2, :, b, :20], ref[2, :, b, :20])
        print(f"{name}, n = 20: port vs JAX {rel:.3g}")
        assert rel < JAX_TOL[name]


def test_bank_matches_scipy(bank):
    x, got, _ = bank
    sos, _ = tsig.design_butter_band_bank(250, 4)
    worst = 0.0
    for i, n in enumerate(NS):
        if n <= tsig.sos_edge(sos):        # scipy refuses signals this short
            continue
        for b in range(5):
            ref = sps.sosfiltfilt(sos[b], x[i, :, :n].astype(np.float64))
            worst = max(worst, _rel(got[i, :, b, :n], ref))
    print(f"port vs scipy float64: {worst:.3g}")
    assert worst < 1e-5


def test_full_length_matches_scipy():
    """At the study's full length (T_pad 5800), the bank and the single-band
    masked form against scipy's float64 sosfiltfilt, within 1e-5."""
    rng = np.random.default_rng(3)
    x = _walk(rng, (2, 5800))
    ns = np.array([5800, 4100])
    x[1, 4100:] = 0.0
    got = tsig.bandpass_bank_iir_scan(torch.as_tensor(x), torch.as_tensor(ns),
                                      250, 4).numpy()
    sos, zi = tsig.design_butter_band_bank(250, 4)
    worst = 0.0
    for i, n in enumerate(ns):
        for b in range(5):
            ref = sps.sosfiltfilt(sos[b], x[i, :n].astype(np.float64))
            worst = max(worst, _rel(got[i, b, :n], ref))
    one = tsig.sosfiltfilt_scan_masked(torch.as_tensor(x), torch.as_tensor(ns),
                                       sos[0], zi[0]).numpy()
    np.testing.assert_array_equal(one, got[:, 0])
    print(f"T 5800, port vs scipy float64: {worst:.3g}")
    assert worst < 1e-5


def test_masked_single_band_matches_jax():
    rng = np.random.default_rng(1)
    x = _walk(rng, (4, 600))
    ns = np.array([600, 433, 27, 0])
    sos, zi = tsig.design_butter_sos(4.0, 8.0, 250)
    got = tsig.sosfiltfilt_scan_masked(torch.as_tensor(x), torch.as_tensor(ns),
                                       sos, zi).numpy()
    ref = np.asarray(jax.jit(lambda a, m: jsig.sosfiltfilt_scan_masked(a, m, sos, zi))(
        jnp.asarray(x), jnp.asarray(ns)))
    rel = _rel(got, ref)
    print(f"theta, masked, port vs JAX {rel:.3g}")
    assert rel < JAX_TOL["theta"]
    assert np.all(got[3] == 0.0) and np.all(got[2, 27:] == 0.0)


def test_unmasked_forms_match_jax_and_scipy():
    rng = np.random.default_rng(2)
    x = _walk(rng, (3, 500))
    sos, zi = tsig.design_butter_sos(8.0, 13.0, 250)
    got = tsig.sosfiltfilt_scan(torch.as_tensor(x), sos, zi).numpy()
    ref = np.asarray(jax.jit(lambda a: jsig.sosfiltfilt_scan(a, sos, zi))(jnp.asarray(x)))
    assert got.shape == ref.shape == x.shape
    assert _rel(got, ref) < JAX_TOL["alpha"]
    assert _rel(got, sps.sosfiltfilt(sos, x.astype(np.float64))) < 1e-5
    bp = tsig.bandpass_iir_scan(torch.as_tensor(x), 250, 8.0, 13.0).numpy()
    np.testing.assert_array_equal(bp, got)
    # a band above Nyquist clamps to nothing: pass-through, as the reference
    xt = torch.as_tensor(x)
    assert tsig.bandpass_iir_scan(xt, 250, 130.0, 200.0) is xt


def test_sos_edge_is_scipys_padlen():
    """edge = 3·ntaps with ntaps reduced by first-order sections: an odd
    low-pass design has one (b2 = a2 = 0), and the unmasked form with that
    edge equals scipy's default padding."""
    sos_bank, _ = tsig.design_butter_band_bank(250, 4)
    assert tsig.sos_edge(sos_bank) == tsig.sos_edge(sos_bank[0]) == 27
    sos = sps.butter(3, 0.2, output="sos")
    assert tsig.sos_edge(sos) == 3 * (2 * 2 + 1 - 1)
    x = _walk(np.random.default_rng(4), (200,))
    got = tsig.sosfiltfilt_scan(torch.as_tensor(x), sos, sps.sosfilt_zi(sos)).numpy()
    assert _rel(got, sps.sosfiltfilt(sos, x.astype(np.float64))) < 1e-5
    mixed = np.stack([sos_bank[0][:3], np.concatenate([sos, sos[:1]])])
    with pytest.raises(ValueError):
        tsig.sos_edge(mixed)


def test_kernel_plan():
    """One thread per (series, band) in one-warp blocks; the float64 scratch
    holds T + 2·edge rows of every chain."""
    edge = tsig.sos_edge(tsig.design_butter_band_bank(250, 4)[0])
    plan = tic.kernel_plan(16 * 47, 5, 5800, edge, 4)
    assert plan == dict(threads=32, grid=118, chains=3760, text=5854,
                        scratch_bytes=5854 * 3760 * 8)
    assert tic.kernel_plan(2 * 47, 5, 5800, edge, 4)["grid"] == 15
    assert tic.kernel_plan(1, 5, 10, edge, 4)["grid"] == 1
    for bad in (0, tic.MAX_SECTIONS + 1):
        with pytest.raises(ValueError):
            tic.kernel_plan(10, 5, 100, edge, bad)
    # the source instantiates exactly the sections the plan accepts, and its
    # load-ahead and entry point are what the wrapper binds
    src = Path(tic.SRC).read_text()
    cases = [int(c) for c in re.findall(r"CASE\((\d+)\)", src)]
    assert cases == list(range(1, tic.MAX_SECTIONS + 1))
    assert 'extern "C" int sosfiltfilt_launch(' in src


def test_cuda_launcher_refuses_cpu_and_router_takes_plain():
    x = torch.zeros((2, 3, 100))
    sos, zi = tsig.design_butter_band_bank(250, 4)
    before = tic.sosfiltfilt_bank_cuda.launches
    with pytest.raises(ValueError):
        tic.sosfiltfilt_bank_cuda(x, 100, sos, zi, 27)
    out = tsig.bandpass_bank_iir_scan(x, torch.full((2, 1), 100), 250, 4)
    assert out.shape == (2, 3, 5, 100)
    assert tic.sosfiltfilt_bank_cuda.launches == before


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda)")
    rng = np.random.default_rng(5)
    x = torch.as_tensor(_walk(rng, (3, 47, 5800)), device="cuda")
    n = torch.tensor([[5800], [4100], [20]], device="cuda")
    x = torch.where(torch.arange(5800, device="cuda") < n[..., None], x, 0.0)
    sos, zi = tsig.design_butter_band_bank(250, 4)
    before = tic.sosfiltfilt_bank_cuda.launches
    got = tsig.bandpass_bank_iir_scan(x, n, 250, 4)
    assert tic.sosfiltfilt_bank_cuda.launches == before + 1
    ref = tsig.bandpass_bank_iir_plain(x, n, sos, zi)
    for b in range(5):
        assert _rel(got[..., b, :].cpu().numpy(), ref[..., b, :].cpu().numpy()) < 1e-6
    assert bool((got[1, ..., 4100:] == 0).all())
