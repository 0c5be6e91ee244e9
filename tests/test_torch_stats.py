"""The study's statistics in the port against the JAX reference on the same
numpy inputs (made from a seed): masked (5, n_max) batches as the runner's
`_masked_delta_batch` builds them — ties, zeros, a band with fewer than 5
valid entries, n ≤ 50 (exact Wilcoxon distribution) and n > 50 (normal
approximation).

Tolerances: W exact; Wilcoxon p rtol 1e-5 / atol 1e-7 (the port counts the
exact distribution in float64, the reference in float32: worst observed
relative difference 1.3e-7); BH-FDR reject flags exact, adjusted p rtol
1e-6; Cohen's d rtol 1e-5; the sign-flip exceedance count exact (its p
within one float32 ULP, rtol 2e-7) and the bootstrap CI rtol 1e-5, both on
draws taken from `jax.random` and fed to the port."""
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import scipy.stats as sps

from tda_eeg_audio_tpu.ops import stats as jstats
from tda_eeg_audio_tpu_torch.ops import stats as tstats

torch.set_num_threads(1)


def _masked_batch(n_max, seed, ties=False, zeros=False):
    """(5, n_max) float32 deltas + mask: bands of n_max, n_max − 3, 7 and 5
    valid entries and one placeholder band (a single True, as for a band
    with fewer than 5 subjects)."""
    rng = np.random.default_rng(seed)
    D = np.zeros((5, n_max), np.float32)
    M = np.zeros((5, n_max), bool)
    for b, n in enumerate((n_max, n_max - 3, 7, 5)):
        D[b, :n] = rng.standard_normal(n) * 0.3 + 0.1
        M[b, :n] = True
    M[4, 0] = True
    if ties:
        D[0, 3] = D[0, 1]
        D[1, 2] = -D[1, 0]
        D = np.round(D, 1)
    if zeros:
        D[0, 2] = 0.0
        D[2, 1] = 0.0
    return D, M


CASES = {"n9": (9, 0, False, False), "n9_ties": (9, 1, True, False),
         "n9_zeros": (9, 2, False, True), "n45": (45, 3, False, False),
         "n50": (50, 4, False, False), "n60": (60, 5, False, False),
         "n60_ties_zeros": (60, 6, True, True)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_wilcoxon_matches_reference(case):
    D, M = _masked_batch(*CASES[case])
    Wj, pj = jstats.wilcoxon(jnp.asarray(D), jnp.asarray(M))
    Wt, pt = tstats.wilcoxon(torch.as_tensor(D), torch.as_tensor(M))
    np.testing.assert_array_equal(Wt.numpy(), np.asarray(Wj))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-5, atol=1e-7)
    rel = np.abs(pt.numpy() - np.asarray(pj)) / np.maximum(np.asarray(pj), 1e-30)
    print(f"{case}: worst relative p difference {rel.max():.3g}")


def test_wilcoxon_exact_branch_matches_scipy():
    """float64 counting is at least as close to scipy as the reference."""
    D, M = _masked_batch(45, 7)
    _, pt = tstats.wilcoxon(torch.as_tensor(D), torch.as_tensor(M))
    _, pj = jstats.wilcoxon(jnp.asarray(D), jnp.asarray(M))
    for b in range(4):
        want = sps.wilcoxon(D[b][M[b]].astype(np.float64)).pvalue
        err_t = abs(float(pt[b]) - want)
        assert err_t <= 1e-6 * want + 1e-9
        assert err_t <= abs(float(np.asarray(pj)[b]) - want) + 1e-7 * want


def test_norm_sf_and_no_valid_entries():
    z = np.linspace(-6, 6, 41).astype(np.float32)
    np.testing.assert_allclose(tstats._norm_sf(torch.as_tensor(z)).numpy(),
                               np.asarray(jstats._norm_sf(jnp.asarray(z))),
                               rtol=1e-6, atol=1e-12)
    W, p = tstats.wilcoxon(torch.zeros((2, 6)), torch.zeros((2, 6), dtype=torch.bool))
    assert W.tolist() == [0.0, 0.0] and p.tolist() == [1.0, 1.0]


@pytest.mark.parametrize("pvals", [
    [0.01, 0.04, 0.03, 0.5, 0.2], [1.0, 1.0, 0.001, 1.0, 1.0],
    [0.02, 0.02, 0.02, 0.02, 0.02], [1.0] * 5, [0.049, 0.01, 1.0, 0.01, 0.03]],
    ids=["distinct", "insufficient_bands", "all_tied", "all_one", "tied_pair"])
def test_bh_fdr_matches_reference(pvals):
    p = np.asarray(pvals, np.float32)[None]
    rj, aj = jstats.bh_fdr(jnp.asarray(p), 0.05)
    rt, at = tstats.bh_fdr(torch.as_tensor(p), 0.05)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-6)


@pytest.mark.parametrize("n_max", [9, 45])
def test_sign_flip_and_cohens_d_match_reference(n_max):
    D, M = _masked_batch(n_max, 11)
    key = jax.random.key(42)
    n_perm = 1000
    pj = jstats.sign_flip_pvalue(jnp.asarray(D), jnp.asarray(M), key, n_perm)
    # the reference's draws, taken once and fed to the port
    signs = np.array(jax.random.rademacher(key, (n_perm,) + D.shape,
                                           dtype=jnp.float32))
    pt = tstats.sign_flip_pvalue(torch.as_tensor(D), torch.as_tensor(M),
                                 signs=signs)
    # the exceedance counts are equal; the final division differs by one
    # float32 ULP (XLA multiplies by the reciprocal), worst observed 8.4e-8
    np.testing.assert_array_equal(np.rint(pt.numpy() * (n_perm + 1)),
                                  np.rint(np.asarray(pj) * (n_perm + 1)))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=2e-7)
    dj = jstats.cohens_d_paired(jnp.asarray(D), jnp.asarray(M))
    dt = tstats.cohens_d_paired(torch.as_tensor(D), torch.as_tensor(M))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5)


def test_sign_flip_generator_is_reproducible():
    D, M = _masked_batch(12, 3)
    run = lambda: tstats.sign_flip_pvalue(  # noqa: E731
        torch.as_tensor(D), torch.as_tensor(M), 500,
        generator=torch.Generator().manual_seed(42))
    p = run()
    assert torch.equal(p, run())
    assert bool(((p > 0) & (p <= 1)).all())
    with pytest.raises(ValueError):
        tstats.sign_flip_pvalue(torch.as_tensor(D), torch.as_tensor(M), 10)


def test_bootstrap_mean_ci_matches_reference():
    rng = np.random.default_rng(5)
    v = rng.uniform(0.4, 0.9, (3, 30)).astype(np.float32)
    key = jax.random.key(7)
    bj, loj, hij = jstats.bootstrap_mean_ci(jnp.asarray(v), key, 400)
    idx = np.array(jax.random.randint(key, (400, 30), 0, 30))
    bt, lot, hit = tstats.bootstrap_mean_ci(torch.as_tensor(v), idx=idx)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-5)
    np.testing.assert_allclose(lot.numpy(), np.asarray(loj), rtol=1e-5)
    np.testing.assert_allclose(hit.numpy(), np.asarray(hij), rtol=1e-5)
    g = torch.Generator().manual_seed(1)
    _, lo, hi = tstats.bootstrap_mean_ci(torch.as_tensor(v), 200, generator=g)
    assert bool((lo < hi).all())


def _t_sf_data_bound(t, df):
    """`_t_sf` with the series' length read from the data (the largest ν),
    as it was before the bound became static."""
    t64 = t.to(torch.float64)
    nu = torch.round(df.to(torch.float64))
    th = torch.atan(t64.abs() / torch.sqrt(nu))
    s, c = torch.sin(th), torch.cos(th)
    c2 = c * c
    odd = torch.remainder(nu, 2) == 1
    term = torch.ones_like(t64)
    acc = torch.ones_like(t64)
    k_max = int(nu.max().item()) if nu.numel() else 0
    for k in range(1, k_max // 2 + 1):
        num = torch.where(odd, 2.0 * k, 2.0 * k - 1.0)
        den = torch.where(odd, 2.0 * k + 1.0, 2.0 * k)
        term = term * c2 * num / den
        last = torch.where(odd, nu - 3.0, nu - 2.0)
        acc = acc + torch.where(2.0 * k <= last, term, 0.0)
    a_odd = torch.where(nu == 1, 2.0 * th / math.pi,
                        2.0 / math.pi * (th + s * c * acc))
    a = torch.where(odd, a_odd, s * acc)
    p = 0.5 * (1.0 - a)
    return torch.where(t64 >= 0, p, 1.0 - p).to(t.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nu", range(1, 14))
def test_t_sf_static_bound_is_bit_for_bit_the_data_bound(nu, dtype):
    """The series' length from the static bound ν ≤ K − 2 = 13 of the
    comparison's K = 15 windows gives the bits of the length read from the
    data, for ν = 1…13 alone and mixed with every other ν, at t of both
    signs, ±0 and ±inf: the terms past an entry's own ν add exact zeros."""
    t = torch.tensor([-math.inf, -40.0, -3.7, -1.0, -1e-3, -0.0, 0.0, 1e-3, 0.5,
                      1.0, 2.2, 3.7, 12.0, 40.0, math.inf], dtype=dtype)
    df = torch.full_like(t, float(nu))
    assert torch.equal(tstats._t_sf(t, df, 13), _t_sf_data_bound(t, df))
    mixed = (torch.arange(t.numel()) % 13 + 1).to(dtype)
    mixed[0] = nu
    assert torch.equal(tstats._t_sf(t, mixed, 13), _t_sf_data_bound(t, mixed))
    assert torch.equal(tstats._t_sf(t, df, nu), _t_sf_data_bound(t, df))
