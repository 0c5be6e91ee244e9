"""The port's exact host Wasserstein (`native.engine.wasserstein_batch`, the
`host_exact` backend, `csrc/wasserstein_host.cpp`) against the reference
package's native engine and its scipy-Hungarian oracle
(`oracle/wasserstein_ref.safe_wasserstein`, persim's semantics), on random,
tied, empty and non-prefix-masked diagrams.

Tolerances: against the reference engine, equal bit for bit (the same
float64 assignment; no multiply feeds an add, so no compiler contraction can
move a sum) — worst observed difference 0.0; against the oracle, rtol 1e-6
(the engine rounds its float64 total to float32) — worst observed relative
error 5.6e-8."""
import numpy as np
import pytest

from tda_eeg_audio_tpu.native import engine as jengine
from tda_eeg_audio_tpu_torch.oracle.wasserstein_ref import safe_wasserstein
from tda_eeg_audio_tpu_torch.native import engine as tengine


def _random(rng, N, K, p_valid, ties=False):
    b = rng.uniform(0, 1, (N, K))
    d = b + rng.uniform(0.01, 1, (N, K))
    if ties:        # few distinct values: equal costs everywhere
        b, d = np.round(b * 4) / 4, np.round(b * 4) / 4 + np.round(d - b + 0.5)
    m = rng.random((N, K)) < p_valid
    return b.astype(np.float32), d.astype(np.float32), m


def _cases():
    rng = np.random.default_rng(7)
    cases = {}
    cases["random"] = (*_random(rng, 60, 32, 0.5), *_random(rng, 60, 48, 0.4))
    cases["tied"] = (*_random(rng, 40, 16, 0.7, ties=True),
                     *_random(rng, 40, 16, 0.7, ties=True))
    b1, d1, m1, b2, d2, m2 = (*_random(rng, 12, 8, 0.6), *_random(rng, 12, 10, 0.6))
    m1[:4] = False              # empty left, then both empty, then empty right
    m2[2:6] = False
    cases["empty"] = (b1, d1, m1, b2, d2, m2)
    # valid bars scattered through the row, not a prefix
    b1, d1, m1, b2, d2, m2 = (*_random(rng, 30, 20, 0.3), *_random(rng, 30, 24, 0.3))
    m1[:, :5] = False
    m2[:, ::3] = False
    cases["non_prefix"] = (b1, d1, m1, b2, d2, m2)
    # the study's widths: EEG H0 (≤ 46 bars, births 0) against audio H0
    b1, d1, m1 = _random(rng, 8, 64, 0.7)
    b2, d2, m2 = _random(rng, 8, 128, 0.9)
    cases["h0_widths"] = (np.zeros_like(b1), d1, m1, np.zeros_like(b2), d2, m2)
    return cases


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_equals_the_reference_engine(name):
    args = CASES[name]
    got = tengine.wasserstein_batch(*args)
    want = jengine.wasserstein_batch(*args)
    assert got.dtype == np.float32 and got.shape == (args[0].shape[0],)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_the_persim_oracle(name):
    b1, d1, m1, b2, d2, m2 = CASES[name]
    got = tengine.wasserstein_batch(b1, d1, m1, b2, d2, m2, n_threads=2)
    want = np.array([safe_wasserstein(np.stack([b1[i][m1[i]], d1[i][m1[i]]], 1),
                                      np.stack([b2[i][m2[i]], d2[i][m2[i]]], 1))
                     for i in range(len(b1))])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    print(f"{name}: worst relative error "
          f"{float((np.abs(got - want) / np.maximum(np.abs(want), 1e-30)).max()):.3g}")


def test_empty_diagram_is_the_zero_point():
    """Both empty → 0; one empty → the other's own diagonal costs
    sum((d − b) / 2) through the (0, 0) sentinel, not 0."""
    b = np.array([[0.1, 0.2, 0.0]], np.float32)
    d = np.array([[0.5, 0.4, 0.0]], np.float32)
    m = np.array([[True, True, False]])
    none = np.zeros_like(m)
    assert tengine.wasserstein_batch(b, d, none, b, d, none)[0] == 0.0
    w = tengine.wasserstein_batch(b, d, m, b, d, none)[0]
    np.testing.assert_allclose(w, 0.5 * (0.4 + 0.2), rtol=1e-6)
    assert tengine.wasserstein_batch(b, d, m, b, d, m)[0] == 0.0


def test_rejects_mismatched_batches_and_accepts_none():
    b, d, m = _random(np.random.default_rng(0), 3, 4, 0.5)
    with pytest.raises(ValueError):
        tengine.wasserstein_batch(b, d, m, b[:2], d[:2], m[:2])
    out = tengine.wasserstein_batch(b[:0], d[:0], m[:0], b[:0], d[:0], m[:0])
    assert out.shape == (0,)
