"""The exact redo of overflowed windows in the port (CPU): the port's own
host engine against the plain reduction, `run_tda`'s scatter-back against a
run whose arena and budget are wide enough, and `_features_from`'s
degenerate-cloud sentinel against the JAX reference.

Bars are compared exactly as sorted (birth, death) lists per window — the
engine and the reduction read the same float32 distances; features of a
redone window within rtol 1e-5 / atol 1e-6 (the two paths may hold the same
bars in another order, which moves float32 sums by an ULP)."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp  # noqa: F401  (the reference's _features_from needs jax)

from tda_eeg_audio_tpu.models import homology_exec as jexec
from tda_eeg_audio_tpu_torch.models import homology_exec as texec
from tda_eeg_audio_tpu_torch.models import programs as tprog
from tda_eeg_audio_tpu_torch.native import engine
from tda_eeg_audio_tpu_torch.ops.homology_h1 import h1_diagrams_plain

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def _clouds(n, B, seed, n_pts=None, thresh=2.0):
    """Correlation-distance matrices of B clouds of n smoothed random
    channels; points beyond n_pts[b] are padding at distance thresh + 1."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, n, 40 + 8))
    x = np.stack([x[..., i:i + 40] for i in range(8)]).mean(0)
    x -= x.mean(-1, keepdims=True)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    dm = np.sqrt(np.clip(2 * (1 - x @ x.transpose(0, 2, 1)), 0, None))
    dm = np.maximum(dm, dm.transpose(0, 2, 1)).astype(np.float32)
    if n_pts is not None:
        pad = np.arange(n)[None, :] >= np.asarray(n_pts)[:, None]
        dm[pad[:, :, None] | pad[:, None, :]] = thresh + 1.0
    dm[:, np.arange(n), np.arange(n)] = 0.0
    return dm


def _bars(b, d, m):
    return sorted(zip(np.asarray(b)[np.asarray(m)].tolist(),
                      np.asarray(d)[np.asarray(m)].tolist()))


@pytest.mark.parametrize("n,thresh,padded", [
    (12, 2.0, False), (20, 2.0, True), (31, 1.2, False), (47, 2.0, False),
    (47, 1.0, True)], ids=["n12", "n20_padded", "n31_cut", "n47", "n47_cut_padded"])
def test_host_engine_matches_plain_reduction(n, thresh, padded):
    B = 6
    n_pts = np.array([n, n - 1, n - 3, 3, 2, n]) if padded else None
    dm = _clouds(n, B, seed=n, n_pts=n_pts, thresh=thresh)
    host = engine.rips_persistence_batch(dm, thresh=thresh, max_bars=256)
    ref = h1_diagrams_plain(
        torch.as_tensor(dm), None if n_pts is None else torch.as_tensor(n_pts),
        n=n, thresh=thresh, na_max=128, h1_max=128)
    assert not bool(ref["overflow"].any()) and not host["overflow"].any()
    n_bars = 0
    for i in range(B):
        want = _bars(ref["births"][i], ref["deaths"][i], ref["mask"][i])
        assert _bars(host["births"][i], host["deaths"][i], host["mask"][i]) == want
        n_bars += len(want)
        h0_ref = np.sort(ref["h0_deaths"][i].numpy()[ref["h0_mask"][i].numpy()])
        h0_host = np.sort(host["h0_deaths"][i][host["h0_mask"][i]])
        np.testing.assert_array_equal(h0_host, h0_ref)
    np.testing.assert_array_equal(host["n_essential"], ref["n_essential"].numpy())
    np.testing.assert_array_equal(host["n_tree"], ref["n_tree"].numpy())
    assert n_bars > 0


def test_host_engine_flags_more_bars_than_columns():
    dm = _clouds(30, 2, seed=3)
    wide = engine.rips_persistence_batch(dm, max_bars=256)
    k = int(wide["mask"][0].sum())
    assert k > 4
    narrow = engine.rips_persistence_batch(dm, max_bars=4)
    assert narrow["overflow"].all() and narrow["mask"].sum(1).tolist() == [4, 4]
    np.testing.assert_array_equal(narrow["births"], wide["births"][:, :4])


def _assert_same_diagrams(got, want):
    B = want["births"].shape[0]
    for i in range(B):
        assert _bars(got["births"][i], got["deaths"][i], got["mask"][i]) == \
            _bars(want["births"][i], want["deaths"][i], want["mask"][i]), i
        np.testing.assert_array_equal(
            np.sort(got["h0_deaths"][i][got["h0_mask"][i]].numpy()),
            np.sort(want["h0_deaths"][i][want["h0_mask"][i]].numpy()))
    for k in ("n_essential", "n_comp"):
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    np.testing.assert_allclose(got["features"].numpy(), want["features"].numpy(),
                               rtol=1e-5, atol=1e-6)


def test_run_tda_redoes_arena_overflow():
    """na_max = 8: windows with more creators overflow and are recomputed on
    the host engine; windows with at most 8 bars equal the wide run."""
    n = 24
    n_pts = torch.tensor([24, 24, 20, 24, 2, 24, 12, 24])
    dm = torch.as_tensor(_clouds(n, 8, seed=1, n_pts=n_pts.numpy()))
    before = texec.run_tda.redone
    wide = texec.run_tda(dm, 2.0, n_pts=n_pts, na_max=96)
    assert texec.run_tda.redone == before and not bool(wide["redone"].any())
    tight = texec.run_tda(dm, 2.0, n_pts=n_pts, na_max=8)
    n_redone = int(tight["redone"].sum())
    assert 0 < n_redone < 8 and texec.run_tda.redone == before + n_redone
    few = wide["mask"].sum(1) <= 8
    assert bool(few.any()) and bool((~few).any())
    sel = torch.nonzero(few).squeeze(1)
    _assert_same_diagrams({k: v[sel] for k, v in tight.items()},
                          {k: v[sel] for k, v in wide.items()})
    # a redone window with more than 8 bars keeps its first 8 columns
    many = torch.nonzero(~few).squeeze(1)
    assert bool(tight["redone"][many].all())
    assert tight["mask"][many].sum(1).tolist() == [8] * len(many)
    np.testing.assert_array_equal(tight["n_essential"].numpy(),
                                  wide["n_essential"].numpy())


def test_run_tda_redoes_step_budget_overflow(monkeypatch):
    """With the routing floor lowered, a 6-step budget overflows most
    windows; the redo equals the run with the full budget bar for bar."""
    n = 24
    dm = torch.as_tensor(_clouds(n, 8, seed=2))
    wide = texec.run_tda(dm, 2.0, na_max=96)
    monkeypatch.setattr(tprog, "STEP_BUDGET_FLOOR", 1)
    tight = texec.run_tda(dm, 2.0, na_max=96, step_budget=6)
    assert 0 < int(tight["redone"].sum())
    _assert_same_diagrams(tight, wide)


def test_features_from_degenerate_sentinel_matches_reference():
    n = 24
    n_pts = np.array([24, 2, 1, 0, 10, 24], np.int32)
    dm = _clouds(n, 6, seed=5, n_pts=n_pts)
    raw = h1_diagrams_plain(torch.as_tensor(dm), torch.as_tensor(n_pts), n=n,
                            thresh=2.0, na_max=96, h1_max=96)
    keys = ("births", "deaths", "mask", "h0_deaths", "h0_mask", "n_essential",
            "n_tree")
    got = texec._features_from({k: raw[k] for k in keys}, n,
                               torch.as_tensor(n_pts))
    want = jexec._features_from({k: raw[k].numpy() for k in keys}, n, n_pts)
    for k in ("mask", "fin_mask", "h0_mask", "n_comp", "n_essential"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for k in ("births", "deaths", "h0_deaths"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    np.testing.assert_allclose(got["features"].numpy(), want["features"],
                               rtol=1e-5, atol=1e-6)
    # the sentinel: one (0, 0) bar in both dimensions, no essential class
    for i in (1, 2, 3):
        assert got["mask"][i].tolist() == [True] + [False] * 95
        assert got["h0_mask"][i].tolist() == [True] + [False] * (n - 2)
        assert int(got["n_comp"][i]) == 0 and int(got["n_essential"][i]) == 0


def test_engine_is_built_from_the_ports_own_source():
    so = engine.build()
    assert so == engine.library_path() and so.exists()
    assert so.parent == ROOT / "build" / "torch_native"
    assert so.name.startswith("librips_host_")
    assert engine.SRC == ROOT / "tda_eeg_audio_tpu_torch" / "csrc" / "rips_host.cpp"
    code = ("import sys, numpy as np\n"
            "from tda_eeg_audio_tpu_torch.native.engine import rips_persistence_batch\n"
            "dm = np.ones((1, 4, 4), np.float32) - np.eye(4, dtype=np.float32)\n"
            "out = rips_persistence_batch(dm)\n"
            "assert out['n_tree'][0] == 3\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'tda_eeg_audio_tpu' or m.startswith('tda_eeg_audio_tpu.')]\n"
            "print(','.join(bad))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == ""
