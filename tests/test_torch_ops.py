"""Port parity: diagram features, Wasserstein and Spearman statistics of
`tda_eeg_audio_tpu_torch` against the JAX reference (CPU).

Tolerances: features atol 1e-6; exact H0 Wasserstein atol 1e-6 plus rtol
1e-6 (its float32 prefix sums run in another order than XLA's reduce_window,
a few ULP at the W ≈ 10 of 46-vs-123-bar diagrams); tiered Sinkhorn
rtol 2e-4 (the ε ladder ends at ε = 1e-4 × the pair's cost scale, so one
float32 ULP in a dual potential — exp and matvec rounding differ between
the two frameworks — moves <P, D> by up to ~1e-4 relative); Spearman r and p atol 1e-5 (the port's
p-value is the closed-form integer-df Student t, the reference's the
regularized incomplete beta)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tda_eeg_audio_tpu.models import programs as jprog
from tda_eeg_audio_tpu.ops import features as jfeat
from tda_eeg_audio_tpu.ops import stats as jstats
from tda_eeg_audio_tpu.ops import wasserstein as jw
from tda_eeg_audio_tpu_torch.models import programs as tprog
from tda_eeg_audio_tpu_torch.ops import features as tfeat
from tda_eeg_audio_tpu_torch.ops import stats as tstats
from tda_eeg_audio_tpu_torch.ops import wasserstein as tw

torch.set_num_threads(1)    # fixed BLAS summation order (see test_torch_slice.py)


def _t(x):
    return torch.as_tensor(np.array(x))


def _diagrams(rng, N, K, max_bars):
    b = rng.uniform(0.0, 1.0, (N, K)).astype(np.float32)
    d = (b + rng.exponential(0.3, (N, K))).astype(np.float32)
    nb = rng.integers(0, max_bars + 1, N)
    m = np.arange(K)[None, :] < nb[:, None]
    perm = rng.permuted(np.tile(np.arange(K), (N, 1)), axis=1)
    m = np.take_along_axis(m, perm, 1)             # bars scattered in the row
    return b, d, m


def test_features_and_aggregate_match_jax():
    rng = np.random.default_rng(0)
    b, d, m = _diagrams(rng, 64, 32, 20)
    m[:3] = False                                  # empty diagrams
    m[3:6] = np.arange(32) == 0                    # single bars
    ness = rng.integers(0, 3, 64).astype(np.int32)
    f_j = np.asarray(jfeat.diagram_features(jnp.asarray(b), jnp.asarray(d),
                                            jnp.asarray(m), jnp.asarray(ness)))
    f_t = tfeat.diagram_features(_t(b), _t(d), _t(m), _t(ness)).numpy()
    np.testing.assert_allclose(f_t, f_j, atol=1e-6)
    x = rng.standard_normal((4, 5, 39, 22)).astype(np.float32)
    wm = rng.random((4, 5, 39)) < 0.7
    a_j = np.asarray(jfeat.aggregate_mean_std(jnp.asarray(x), jnp.asarray(wm)))
    a_t = tfeat.aggregate_mean_std(_t(x), _t(wm)).numpy()
    np.testing.assert_allclose(a_t, a_j, atol=1e-6)


def test_h0_wasserstein_exact_matches_jax():
    rng = np.random.default_rng(1)
    d1 = rng.exponential(0.5, (40, 46)).astype(np.float32)
    d2 = rng.exponential(0.5, (40, 123)).astype(np.float32)
    m1 = rng.random((40, 46)) < 0.8
    m2 = rng.random((40, 123)) < 0.6
    m1[0] = False                                  # empty side
    w_j = np.asarray(jw.wasserstein_h0_exact(jnp.asarray(d1), jnp.asarray(m1),
                                             jnp.asarray(d2), jnp.asarray(m2)))
    w_t = tw.wasserstein_h0_exact(_t(d1), _t(m1), _t(d2), _t(m2)).numpy()
    np.testing.assert_allclose(w_t, w_j, rtol=1e-6, atol=1e-6)


def _study_diagrams(rng, counts, K=96):
    """Study-shaped H1 diagrams (births 0.3-1.5, exponential persistence,
    as tests/test_wasserstein.py), bars scattered over the pad row."""
    N = len(counts)
    b = np.zeros((N, K), np.float32)
    d = np.zeros((N, K), np.float32)
    m = np.zeros((N, K), bool)
    for i, c in enumerate(counts):
        pos = rng.choice(K, size=c, replace=False)
        bb = rng.uniform(0.3, 1.5, c).astype(np.float32)
        m[i, pos] = True
        b[i, pos] = bb
        d[i, pos] = bb + rng.exponential(0.15, c).astype(np.float32)
    return b, d, m


@pytest.mark.parametrize("profile", ["sparse", "mixed"])
def test_tiered_sinkhorn_matches_jax(profile):
    """All pairs in the narrow (16+16)² tier, and a mixed batch whose dense
    pairs need the wider tiers and full width; empty diagrams take the
    [[0, 0]] sentinel."""
    rng = np.random.default_rng(2)
    N = 150
    if profile == "sparse":
        c1, c2 = rng.integers(0, 16, N), rng.integers(0, 16, N)
    else:
        c1 = np.concatenate([rng.integers(1, 15, N - 20), rng.integers(20, 38, 14),
                             rng.integers(60, 90, 4), [0, 0]])
        c2 = np.concatenate([rng.integers(1, 15, N - 20), rng.integers(20, 38, 14),
                             rng.integers(60, 90, 4), [3, 0]])
    args = (*_study_diagrams(rng, c1), *_study_diagrams(rng, c2))
    w_j = np.asarray(jprog._wass_sinkhorn_tiered(*(jnp.asarray(x) for x in args)))
    w_t = tprog._wass_sinkhorn_tiered(*(_t(x) for x in args)).numpy()
    # worst case, kept in PERF.md beside the tolerance (pytest -rP shows it)
    nz = w_j != 0
    print(f"tiered Sinkhorn {profile}: max rel err "
          f"{float(np.max(np.abs(w_t - w_j)[nz] / np.abs(w_j[nz]))):.3e}")
    np.testing.assert_allclose(w_t, w_j, rtol=2e-4)
    D = jw.build_cost_matrix(*(jnp.asarray(x[:8, :20]) for x in args))
    D_t = tw.build_cost_matrix(*(_t(x[:8, :20]) for x in args))
    np.testing.assert_array_equal(D_t.numpy(), np.asarray(D))


def test_spearman_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((200, 15)).astype(np.float32)
    y = (0.5 * x + rng.standard_normal((200, 15))).astype(np.float32)
    x[:20] = np.round(x[:20])                      # ties
    y[-10:] = -x[-10:]                             # r = -1
    valid = np.ones((200, 15), bool)
    for i in range(200):                           # n_valid 3..15: df 1..13
        valid[i, rng.permutation(15)[: i % 13]] = False
    r_j, p_j = jstats.spearmanr(jnp.asarray(x), jnp.asarray(y), jnp.asarray(valid))
    r_t, p_t = tstats.spearmanr(_t(x), _t(y), _t(valid))
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), atol=1e-5)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-5)
    rk_j = np.asarray(jstats._rankdata_avg(jnp.asarray(x), jnp.asarray(valid)))
    rk_t = tstats._rankdata_avg(_t(x), _t(valid)).numpy()
    np.testing.assert_array_equal(np.where(valid, rk_t, 0), np.where(valid, rk_j, 0))


def test_t_sf_closed_form_matches_scipy():
    from scipy import stats as sps

    t = np.linspace(0.0, 12.0, 49).astype(np.float32)
    for df in range(1, 16):
        got = tstats._t_sf(_t(t), torch.full_like(_t(t), float(df)), df).numpy()
        np.testing.assert_allclose(got, sps.t.sf(t, df), atol=1e-6)
