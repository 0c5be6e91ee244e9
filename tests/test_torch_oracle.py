"""The port's copy of the host oracles (`tda_eeg_audio_tpu_torch/oracle/`):
each copied function against the reference package's on seeded inputs, the
self-consistency cases of `tests/test_oracle_persistence.py` run on the
copy, and the port's plain H0 and H1 diagrams held to the copy's
`rips_persistence_dm` directly, without JAX in between.

Tolerances: the copies equal the reference's exactly (the same numpy and
scipy code on the same inputs; their sources are equal too).  The port's
diagrams are float32 entries of the distance matrix, the oracle's the same
entries in float64, so the bar multisets agree within rtol 1e-6 (read: bit
for bit), and the counts of essential classes exactly."""
import inspect

import numpy as np
import pytest
import torch

from test_oracle_persistence import betti_direct, betti_from_dgms
from tda_eeg_audio_tpu.oracle import persistence as jpers
from tda_eeg_audio_tpu.oracle import signal_ref as jsref
from tda_eeg_audio_tpu.oracle import wasserstein_ref as jwref
from tda_eeg_audio_tpu_torch.oracle import persistence as tpers
from tda_eeg_audio_tpu_torch.oracle import signal_ref as tsref
from tda_eeg_audio_tpu_torch.oracle import wasserstein_ref as twref
from tda_eeg_audio_tpu_torch.ops import geometry
from tda_eeg_audio_tpu_torch.ops.homology import h0_diagram
from tda_eeg_audio_tpu_torch.ops.homology_h1 import h1_diagrams_plain

torch.set_num_threads(1)

MODULES = [(jpers, tpers), (jsref, tsref), (jwref, twref)]


def _functions(mod):
    return {k: v for k, v in vars(mod).items()
            if inspect.isfunction(v) and v.__module__ == mod.__name__}


@pytest.mark.parametrize("ref,port", MODULES, ids=["persistence", "signal_ref",
                                                   "wasserstein_ref"])
def test_copy_has_every_function_with_the_same_source(ref, port):
    want, got = _functions(ref), _functions(port)
    assert set(got) == set(want)
    for name, fn in want.items():
        assert inspect.getsource(got[name]) == inspect.getsource(fn), name


def _corr_dm(rng, n, T=60):
    r = np.corrcoef(rng.standard_normal((n, T)))
    dm = np.sqrt(np.maximum(2 * (1 - np.clip(r, -1, 1)), 0))
    np.fill_diagonal(dm, 0)
    return dm


def _diagram(rng):
    k = int(rng.integers(0, 9))
    b = rng.uniform(0.3, 1.5, k)
    return np.stack([b, b + rng.exponential(0.15, k)], 1)


def _signal_calls(rng):
    """(function name, args) of every signal_ref function on seeded data."""
    s = rng.standard_normal(2000)
    eeg = rng.standard_normal((5, 1000))
    return [
        ("compute_envelope", (s, 250.0)),
        ("bandpass_filter", (s, 250.0, 4.0, 8.0)),
        ("apply_bandpass_filter_sos", (eeg, 8.0, 13.0, 250.0)),
        ("resample_audio", (rng.standard_normal(44100),)),
        ("create_windows", (s, 250, 62)),
        ("create_sliding_windows", (eeg, 1.0, 0.75, 250.0)),
        ("compute_tau", (s[:250],)),
        ("takens_embedding", (s[:250], 3, 4, 2)),
        ("normalize_point_cloud", (rng.standard_normal((40, 3)),)),
        ("compute_correlation_matrix", (eeg[:, :250],)),
        ("correlation_to_distance", (np.corrcoef(eeg),)),
    ]


def _outputs_equal(a, b):
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _outputs_equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", [c[0] for c in _signal_calls(np.random.default_rng(0))])
def test_signal_ref_copy_equals_reference(name):
    args = dict(_signal_calls(np.random.default_rng(1)))[name]
    _outputs_equal(getattr(tsref, name)(*args), getattr(jsref, name)(*args))


@pytest.mark.parametrize("name", ["rips_persistence_dm", "rips_persistence_points",
                                  "h0_mst_deaths", "wasserstein", "safe_wasserstein",
                                  "persim_cost_matrix"])
def test_persistence_and_wasserstein_copies_equal_reference(name):
    rng = np.random.default_rng(2)
    if name in ("rips_persistence_dm", "h0_mst_deaths"):
        calls = [(_corr_dm(rng, 12), 1.3), (_corr_dm(rng, 14), 2.0)]
    elif name == "rips_persistence_points":
        calls = [(rng.random((13, 3)) * 2.0, 1, 1.0), (rng.random((10, 2)), 1, 2.0)]
    else:
        calls = [(_diagram(rng), _diagram(rng)) for _ in range(6)]
        calls.append((np.array([[0.2, np.inf], [0.3, 0.9]]), np.empty((0, 2))))
        if name == "persim_cost_matrix":
            calls = [c for c in calls if len(c[0]) and len(c[1])
                     and np.isfinite(c[0]).all()]
    mod_t, mod_j = (tpers, jpers) if name in _functions(tpers) else (twref, jwref)
    for args in calls:
        _outputs_equal(getattr(mod_t, name)(*args), getattr(mod_j, name)(*args))


# ---------------- tests/test_oracle_persistence.py's cases on the copy ----------------

def _square():
    pts = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], float)
    h0, h1 = tpers.rips_persistence_points(pts, thresh=2.0)
    deaths = np.sort(h0[:, 1])
    assert np.allclose(deaths[:3], 1.0) and np.isinf(deaths[3])
    assert h1.shape == (1, 2)
    assert np.isclose(h1[0, 0], 1.0) and np.isclose(h1[0, 1], np.sqrt(2))


def _circle():
    th = np.linspace(0, 2 * np.pi, 24, endpoint=False)
    _, h1 = tpers.rips_persistence_points(np.stack([np.cos(th), np.sin(th)], 1), thresh=2.0)
    prominent = h1[h1[:, 1] - h1[:, 0] > 0.1]
    assert len(prominent) == 1
    assert np.isclose(prominent[0, 0], 2 * np.sin(np.pi / 24), atol=1e-12)


def _truncation():
    rng = np.random.default_rng(0)
    a = rng.random((5, 2)) * 0.3
    dgms = tpers.rips_persistence_points(np.vstack([a, rng.random((5, 2)) * 0.3 + 10.0]),
                                         thresh=1.0)
    assert np.sum(~np.isfinite(dgms[0][:, 1])) == 2


def _betti_corr(trial):
    dm = _corr_dm(np.random.default_rng(trial), 11, T=40)
    dgms = tpers.rips_persistence_dm(dm, thresh=2.0)
    for t in [0.4, 0.9, 1.2, 1.4, 1.8]:
        assert betti_direct(dm, t) == betti_from_dgms(dgms, t)


def _betti_cloud(trial):
    pts = np.random.default_rng(10 + trial).random((13, 3)) * 2.0
    dgms = tpers.rips_persistence_points(pts, thresh=1.0)
    dm = np.sqrt(((pts[:, None] - pts[None, :]) ** 2).sum(-1))
    for t in [0.3, 0.6, 0.9, 0.99]:
        assert betti_direct(dm, t) == betti_from_dgms(dgms, t)


def _mst():
    from scipy.sparse.csgraph import minimum_spanning_tree

    pts = np.random.default_rng(3).random((20, 3))
    dm = np.sqrt(((pts[:, None] - pts[None, :]) ** 2).sum(-1))
    mst = minimum_spanning_tree(dm).toarray()
    mst_w = np.sort(mst[mst > 0])
    dgms = tpers.rips_persistence_dm(dm, thresh=2.0)
    assert np.allclose(np.sort(dgms[0][np.isfinite(dgms[0][:, 1]), 1]), mst_w)
    deaths, ncomp = tpers.h0_mst_deaths(dm, 2.0)
    assert np.allclose(np.sort(deaths), mst_w) and ncomp == 1


def _properties():
    h0, h1 = tpers.rips_persistence_dm(_corr_dm(np.random.default_rng(5), 15), thresh=2.0)
    assert np.all(h0[:, 0] == 0)
    assert np.all(h1[:, 1] > h1[:, 0]) and np.all(h1[:, 0] > 0)


ORACLE_CASES = {"square": _square, "circle": _circle, "truncation": _truncation,
                **{f"betti_corr_{t}": (lambda t=t: _betti_corr(t)) for t in range(3)},
                **{f"betti_cloud_{t}": (lambda t=t: _betti_cloud(t)) for t in range(2)},
                "mst": _mst, "properties": _properties}


@pytest.mark.parametrize("case", sorted(ORACLE_CASES))
def test_oracle_copy_cases(case):
    ORACLE_CASES[case]()


# ---------------- the port's plain diagrams against the copy ----------------

def _clouds(kind, n, seed=7):
    """(4, n, n) float32 distance matrices: Pearson distances of random
    windows ("generic"); points of a small integer grid, their distances /
    3, so that many edges tie ("tied"); Pearson distances of windows with
    NaN samples, one channel, three channels, all channels, and one
    channel constant besides ("nan")."""
    rng = np.random.default_rng(seed + n)
    if kind == "tied":
        grid = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"), -1).reshape(-1, 3)
        pts = np.stack([grid[rng.choice(len(grid), n, replace=False)] for _ in range(4)])
        d = np.sqrt(((pts[:, :, None] - pts[:, None]) ** 2).sum(-1)) / 3.0
        d[:, np.arange(n), np.arange(n)] = 0.0
        return torch.as_tensor(d.astype(np.float32))
    w = torch.as_tensor(rng.standard_normal((4, n, 50)).astype(np.float32))
    if kind == "nan":
        w[0, 4] = torch.nan
        w[1, :3] = torch.nan
        w[2] = torch.nan
        w[3, 5] = torch.nan
        w[3, 6] = 1.0
    return geometry.correlation_to_distance(geometry.correlation_matrix(w))


def _same_bars(got, want):
    """Two (k, 2) bar multisets equal within rtol 1e-6, inf deaths included."""
    got = np.asarray(sorted(map(tuple, np.asarray(got, np.float64))))
    want = np.asarray(sorted(map(tuple, np.asarray(want, np.float64))))
    assert got.shape == want.shape, (got, want)
    if len(want):
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("n", [24, 47])
@pytest.mark.parametrize("kind", ["generic", "tied", "nan"])
def test_plain_diagrams_equal_oracle(kind, n):
    """The port's plain H1 diagrams (`h1_diagrams_plain`, with its phase-1
    H0) and its Prim H0 (`h0_diagram`) against `rips_persistence_dm` on the
    same float32 distances, window by window, at thresh 2: H1 bars (finite
    and essential) as multisets, the finite H0 deaths, and the H0 classes
    alive at the threshold."""
    dm = _clouds(kind, n)
    thresh = 2.0
    h1 = h1_diagrams_plain(dm, n=n, thresh=thresh, na_max=128, h1_max=128)
    h0 = h0_diagram(dm, thresh=thresh)
    assert not h1["overflow"].any()
    for w in range(dm.shape[0]):
        o0, o1 = tpers.rips_persistence_dm(dm[w].double().numpy(), thresh=thresh)
        m = h1["mask"][w]
        _same_bars(torch.stack([h1["births"][w][m], h1["deaths"][w][m]], 1).numpy(), o1)
        assert int(h1["n_essential"][w]) == int(np.isinf(o1[:, 1]).sum())
        fin0 = o0[np.isfinite(o0[:, 1]), 1]
        for deaths, mask in ((h1["h0_deaths"][w], h1["h0_mask"][w]),
                             (h0["deaths"][w], h0["dmask"][w])):
            _same_bars(np.stack([np.zeros(int(mask.sum())), deaths[mask].numpy()], 1),
                       np.stack([np.zeros(len(fin0)), fin0], 1))
        assert int(h0["n_essential"][w]) == int(np.isinf(o0[:, 1]).sum())
