"""`ops/homology.py` of the port (Prim H0 diagram, the reference's distance
cleanup) against the JAX package on the CPU, on the cases of
tests/test_homology_device.py: correlation-distance clouds, two clusters
farther apart than the threshold, padded points, and ties with
zero-length merges.  Prim's sweep only selects and compares, so every
output is held exactly (deaths bit for bit)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tda_eeg_audio_tpu.ops import homology as jh
from tda_eeg_audio_tpu_torch.ops import homology as th

KEYS = ("deaths", "dmask", "n_essential", "n_zero")


def _same(dm, valid=None, thresh=2.0):
    got = th.h0_diagram(torch.as_tensor(dm),
                        None if valid is None else torch.as_tensor(valid), thresh)
    want = jh.h0_diagram(jnp.asarray(dm), None if valid is None else jnp.asarray(valid),
                         thresh=thresh)
    for k in KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert got["n_essential"].dtype == torch.int32
    return got


def _corr_dm(rng, n=23, t=100):
    x = rng.standard_normal((n, t))
    c = np.clip(np.corrcoef(x), -1.0, 1.0)
    dm = np.sqrt(np.maximum(2.0 * (1.0 - c), 0.0))
    np.fill_diagonal(dm, 0.0)
    return dm.astype(np.float32)


@pytest.mark.parametrize("trial", range(2))
def test_h0_matches_jax_on_correlation_clouds(trial):
    rng = np.random.default_rng(trial)
    dm = np.stack([_corr_dm(rng) for _ in range(3)])
    got = _same(dm)
    assert got["deaths"].shape == (3, 22) and bool(got["dmask"].all())
    # a batch of batches keeps its leading axes
    _same(dm.reshape(3, 1, 23, 23))


def test_h0_deaths_above_thresh_stay_essential():
    rng = np.random.default_rng(5)
    pts = np.vstack([rng.random((4, 2)), rng.random((5, 2)) + 10])
    dm = np.sqrt(((pts[:, None] - pts[None, :]) ** 2).sum(-1)).astype(np.float32)
    got = _same(dm[None], thresh=2.0)
    assert int(got["n_essential"][0]) == 2
    assert int(got["dmask"][0].sum()) == 7
    _same(dm[None], thresh=0.1)                       # most merges above thresh


def test_h0_padded_points_with_valid_mask():
    rng = np.random.default_rng(6)
    full = np.zeros((2, 12, 3))
    full[:, :7] = rng.random((2, 7, 3))
    dm = np.sqrt(((full[:, :, None] - full[:, None, :]) ** 2).sum(-1))
    valid = np.zeros((2, 12), bool)
    valid[0, :7] = True
    valid[1, 2:9] = True                               # root is not vertex 0
    dm[:, ~valid[0]] = 99.0
    got = _same(dm.astype(np.float32), valid)
    assert got["n_essential"].tolist() == [1, 1]
    # no valid point at all: nothing merges, the root component remains
    got = _same(dm[:1].astype(np.float32), np.zeros((1, 12), bool))
    assert not bool(got["dmask"].any()) and got["n_essential"].tolist() == [1]


def test_h0_zero_length_merges_and_ties():
    """Duplicated points merge at 0 (counted in n_zero, dropped from the
    diagram); tied frontier weights go to the lowest index, as argmin's."""
    pts = np.array([[0, 0], [0, 0], [1, 0], [2, 0], [2, 0], [3, 0], [1, 1]], float)
    dm = np.sqrt(((pts[:, None] - pts[None, :]) ** 2).sum(-1)).astype(np.float32)
    got = _same(dm[None])
    assert int(got["n_zero"][0]) == 2
    assert int(got["dmask"][0].sum()) == 4
    assert torch.isinf(got["deaths"][0][~got["dmask"][0]]).all()


def test_symmetrize_dm_matches_jax_and_the_reference_cleanup():
    rng = np.random.default_rng(1)
    dm = rng.random((2, 6, 6)).astype(np.float32) - 0.2
    got = th.symmetrize_dm(torch.as_tensor(dm)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jh.symmetrize_dm(jnp.asarray(dm))))
    exp = (dm[0] + dm[0].T) / 2
    np.fill_diagonal(exp, 0)
    np.testing.assert_allclose(got[0], np.maximum(exp, 0), atol=1e-6)
