"""Port parity: exact H1 persistence of `tda_eeg_audio_tpu_torch` against the
JAX reference (CPU).

- `_phase1` (edge ranks, forest/H0, apparent sieve, creator list) is held
  bitwise, on random, padded (n_pts) and tied clouds;
- the plain PyTorch reduction is held against the JAX lockstep
  `h1_diagrams` and the Pallas kernel in interpret mode: births/deaths,
  n_essential and overflow exactly;
- the CUDA wrapper takes the plain path for CPU tensors and launches
  nothing; the kernel itself is checked on the card (marked `cuda`, and by
  chip_smoke.py)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from scipy.ndimage import uniform_filter1d

from tda_eeg_audio_tpu.ops import homology_h1 as jh1
from tda_eeg_audio_tpu.ops.homology_pallas import h1_diagrams_pallas
from tda_eeg_audio_tpu_torch.ops import homology_cuda as thc
from tda_eeg_audio_tpu_torch.ops import homology_h1 as th1

torch.set_num_threads(2)

PHASE1_KEYS = ("rank_mat", "na_list", "apparent_r", "vstar_r", "m_cx",
               "h0_deaths", "h0_mask", "n_tree", "iu_r", "ju_r", "ew_r",
               "overflow_na")
BAR_KEYS = ("births", "deaths", "mask", "n_essential", "overflow",
            "h0_deaths", "h0_mask", "n_tree")


def _eeg_like(rng, B, k, n, T=120, pad=9.0):
    """Correlation-distance clouds of k ≤ n smoothed channels, padded to n."""
    full = np.full((B, n, n), pad, np.float32)
    for b in range(B):
        X = uniform_filter1d(rng.standard_normal((k, T)), 12, axis=1)
        r = np.corrcoef(X)
        full[b, :k, :k] = np.sqrt(np.maximum(2 * (1 - np.clip(r, -1, 1)), 0))
        np.fill_diagonal(full[b], 0)
    return full


def _grid(n, B=2, seed=0):
    """Integer-grid clouds: many exactly tied float32 distances."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(B):
        pts = rng.integers(0, 4, (n, 3)).astype(np.float32)
        d = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1)) / 3.0
        np.fill_diagonal(d, 0)
        out.append(d)
    return np.stack(out).astype(np.float32)


CLOUDS = {
    "random47": lambda: (_eeg_like(np.random.default_rng(11), 3, 47, 47), None),
    "padded24": lambda: (_eeg_like(np.random.default_rng(7), 2, 20, 24),
                         np.array([20, 19], np.int32)),
    "tied18": lambda: (_grid(18), None),
}


@pytest.mark.parametrize("cloud", sorted(CLOUDS))
def test_phase1_bitwise(cloud):
    dms, n_pts = CLOUDS[cloud]()
    n = dms.shape[-1]
    if n_pts is not None:
        dms[1, 19, :] = dms[1, :, 19] = 9.0        # second cloud: 19 points
        dms[1, 19, 19] = 0.0
    ph_j = jh1._phase1(jnp.asarray(dms), n, 2.0, 64,
                       None if n_pts is None else jnp.asarray(n_pts))
    ph_t = th1._phase1(torch.as_tensor(dms), n, 2.0, 64,
                       None if n_pts is None else torch.as_tensor(n_pts))
    for k in PHASE1_KEYS:
        a, b = np.asarray(ph_j[k]), ph_t[k].numpy()
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(b, a, err_msg=k)


def test_tied_weights_rank_by_static_order():
    """Tied float32 weights rank in static (i, j) edge order, and the
    apparent partner is the FIRST qualifying vertex — both hazards of a
    non-stable sort or a non-first argmax."""
    dms = _grid(12, B=1, seed=3)
    ph = th1._phase1(torch.as_tensor(dms), 12, 2.0, 64)
    st = th1.static_tables(12)
    w = dms[0][st["iu"], st["ju"]]
    order = np.argsort(w, kind="stable")
    np.testing.assert_array_equal(ph["iu_r"][0].numpy(), st["iu"][order])
    np.testing.assert_array_equal(ph["ju_r"][0].numpy(), st["ju"][order])
    rank = ph["rank_mat"][0].numpy()
    for r in np.flatnonzero(ph["apparent_r"][0].numpy()):
        i, j = st["iu"][order[r]], st["ju"][order[r]]
        both = (rank[i] < r) & (rank[j] < r)
        assert ph["vstar_r"][0, r] == np.flatnonzero(both)[0]


def _bars(out, i):
    m = np.asarray(out["mask"][i])
    return np.stack([np.asarray(out["births"][i])[m],
                     np.asarray(out["deaths"][i])[m]], 1)


@pytest.mark.parametrize("case", ["circle18", "padded24", "random30", "eeg47"])
def test_plain_reduction_matches_jax_and_pallas(case):
    rng = np.random.default_rng(3)
    n_pts, kw = None, dict(na_max=64, h1_max=64, step_budget=2048)
    if case == "circle18":
        th = np.linspace(0, 2 * np.pi, 18, endpoint=False)
        pts = np.stack([np.cos(th), np.sin(th)], 1)
        dms = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))[None]
        thresh, g_cap = 1.0, 256
    elif case == "padded24":
        dms = _eeg_like(rng, 2, 20, 24)
        n_pts = np.array([20, 20], np.int32)
        thresh, g_cap = 2.0, 384
    elif case == "random30":
        pts = rng.standard_normal((2, 30, 3))
        dms = np.sqrt(((pts[:, :, None] - pts[:, None]) ** 2).sum(-1))
        thresh, g_cap = 2.0, 512
    else:
        dms = _eeg_like(rng, 2, 47, 47, T=250)
        thresh, g_cap, kw = 2.0, None, dict(na_max=128, h1_max=128, step_budget=4096)
    dms = dms.astype(np.float32)
    n = dms.shape[-1]
    np_j = None if n_pts is None else jnp.asarray(n_pts)
    np_t = None if n_pts is None else torch.as_tensor(n_pts)
    a = {k: np.asarray(v) for k, v in jh1.h1_diagrams(
        jnp.asarray(dms), np_j, n=n, thresh=thresh, **kw).items()}
    t = {k: v.numpy() for k, v in th1.h1_diagrams_plain(
        torch.as_tensor(dms), np_t, n=n, thresh=thresh, **kw).items()}
    refs = [a]
    if g_cap is not None:    # the Pallas kernel, interpreted (n ≤ 30 only)
        refs.append({k: np.asarray(v) for k, v in h1_diagrams_pallas(
            jnp.asarray(dms), np_j, n=n, thresh=thresh, g_cap=g_cap,
            interpret=True, **kw).items()})
    for ref in refs:
        for i in range(len(dms)):
            np.testing.assert_array_equal(_bars(t, i), _bars(ref, i))
        np.testing.assert_array_equal(t["n_essential"], ref["n_essential"])
        np.testing.assert_array_equal(t["overflow"], ref["overflow"])
        np.testing.assert_array_equal(t["h0_deaths"], ref["h0_deaths"])
    # same bars in the same slots as the lockstep (both compact visible
    # bars in creator order)
    for k in BAR_KEYS:
        np.testing.assert_array_equal(t[k][:, : a[k].shape[-1]] if t[k].ndim > 1
                                      else t[k], a[k], err_msg=k)
    assert int(t["steps"].max()) == int(a["steps"])   # lockstep = max chain


def test_step_budget_overflow_flags_like_jax():
    """A budget too small to finish flags exactly the windows JAX flags."""
    dms = _eeg_like(np.random.default_rng(5), 4, 30, 30)
    kw = dict(n=30, thresh=2.0, na_max=64, h1_max=64, step_budget=40)
    a = jh1.h1_diagrams(jnp.asarray(dms), **kw)
    t = th1.h1_diagrams_plain(torch.as_tensor(dms), **kw)
    np.testing.assert_array_equal(t["overflow"].numpy(), np.asarray(a["overflow"]))
    assert t["overflow"].any() and (t["steps"] <= 40).all()


def test_plain_reduction_counts_word_ops():
    """The optional work count changes no output, and lies between the
    coboundary loads of the finished creators and its per-step maximum."""
    dms = torch.as_tensor(_eeg_like(np.random.default_rng(4), 3, 24, 24))
    ins = th1.reduction_inputs(th1._phase1(dms, 24, 2.0, 64))
    pair, steps, ovf = th1.reduce_plain(*ins, n=24, step_budget=2048)
    work = torch.zeros(3, dtype=torch.int64)
    got = th1.reduce_plain(*ins, n=24, step_budget=2048, word_ops=work)
    for a, b in zip(got, (pair, steps, ovf)):
        assert torch.equal(a, b)
    n_fin = (pair >= 0).sum(dim=1) + (pair == th1.ESSENTIAL).sum(dim=1)
    hi = (ins[5].long() * 24 + 31) // 32
    assert (n_fin > 0).all() and not ovf.any()
    assert (work >= 24 * n_fin).all()
    assert (work <= 24 + steps.long() * (24 + hi)).all()


def test_cuda_wrapper_takes_plain_path_on_cpu():
    dms = torch.as_tensor(_eeg_like(np.random.default_rng(2), 2, 24, 24))
    before = thc.h1_diagrams_cuda.launches
    kw = dict(n=24, thresh=2.0, na_max=64, h1_max=64, step_budget=2048)
    got = thc.h1_diagrams_cuda(dms, **kw)
    want = th1.h1_diagrams_plain(dms, **kw)
    assert thc.h1_diagrams_cuda.launches == before
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # the launch site itself refuses CPU operands: no silent fallback
    ins = th1.reduction_inputs(th1._phase1(dms, 24, 2.0, 64))
    with pytest.raises(ValueError):
        thc.reduce_cuda(*ins, n=24, step_budget=2048)
    assert thc.h1_diagrams_cuda.launches == before


def _card_case(case):
    """Clouds on the card, n_pts, and the arguments of one kernel-vs-plain
    case: the main path's shapes, then what they do not reach."""
    from chip_smoke import ragged_clouds

    rng = np.random.default_rng(9)
    if case in ("n47", "n124", "single"):
        n, na = (124, 96) if case == "n124" else (47, 128)
        B = 1 if case == "single" else 8
        dms = torch.as_tensor(_eeg_like(rng, B, n - 3, n, T=250), device="cuda")
        n_pts = torch.full((B,), n - 3, dtype=torch.int32, device="cuda")
        return dms, n_pts, dict(n=n, na_max=na, h1_max=na, step_budget=8192)
    if case == "tied":
        dms = torch.as_tensor(_grid(18, B=16, seed=5), device="cuda")
        return dms, None, dict(n=18, na_max=64, h1_max=64, step_budget=2048)
    # more windows than resident blocks, windows without creators, padded
    # clouds, and a step budget that some windows exceed
    dms, n_pts = ragged_clouds("cuda")
    return dms, n_pts, dict(n=24, na_max=64, h1_max=64, step_budget=32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["n47", "n124", "ragged", "tied", "single"])
def test_kernel_matches_plain_on_card(case):
    """On a CUDA card: kernel and plain reduction agree bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda)")
    dms, n_pts, kw = _card_case(case)
    before = thc.h1_diagrams_cuda.launches
    got = thc.h1_diagrams_cuda(dms, n_pts, thresh=2.0, **kw)
    assert thc.h1_diagrams_cuda.launches == before + 1
    want = th1.h1_diagrams_plain(dms, n_pts, thresh=2.0, **kw)
    for k in want:
        assert torch.equal(got[k], want[k]), (case, k)
    if case == "ragged":
        assert 0 < int(got["overflow"].sum()) < len(dms)
        assert int((got["n_na"] == 0).sum()) > 0
