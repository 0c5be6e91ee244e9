"""The H1 phase-1 kernel's host side, on the CPU: its launch plan, the
launcher's checks, the route `h1_diagrams_cuda` takes, the premise of the
kernel's forest algorithm and the count its bound rests on.  The kernel
itself runs on the card only (the `cuda`-marked case here, chip_smoke.py's
phase 3b)."""
import numpy as np
import pytest
import torch
from scipy.ndimage import uniform_filter1d

from chip_smoke import grid_clouds, ragged_clouds
from tda_eeg_audio_tpu_torch.ops import homology_cuda as thc
from tda_eeg_audio_tpu_torch.ops import homology_h1 as th1
from tda_eeg_audio_tpu_torch.ops import phase1_cuda as P1

torch.set_num_threads(2)

PHASE1_KEYS = ("m_cx", "ew_r", "rank_mat", "iu_r", "ju_r", "vstar_r",
               "apparent_r", "na_list", "overflow_na", "h0_deaths", "h0_mask",
               "n_tree")


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
    return grid_clouds("cpu", B, n, seed).numpy()


def _with_nan(rng, n=16):
    """Windows past a recording's end read NaN: one all-NaN window, one with
    a NaN channel, one with NaN in a padded row only, one clean."""
    d = _eeg_like(rng, 4, n, n)
    d[0] = np.nan
    d[1, 3, :] = d[1, :, 3] = np.nan
    d[2, n - 1, :] = d[2, :, n - 1] = np.nan
    for x in d:
        np.fill_diagonal(x, 0)
    return d, np.array([n, n, n - 1, n], np.int32)


@pytest.mark.parametrize("n", [24, 47, 124, 128])
def test_kernel_plan_within_limits(n):
    m = n * (n - 1) // 2
    plan = P1.kernel_plan(n, 96)
    assert plan["m"] == m and plan["na_eff"] == min(96, m)
    # a thread per vertex (the forest's roots), whole warps
    assert plan["threads"] >= n and plan["threads"] % 32 == 0
    assert plan["threads"] == (128 if n <= 64 else 256)
    # the uint16 rank matrix, three uint8 arrays by rank, three int arrays
    # of the forest, 16-byte aligned, within a block's shared memory
    assert 2 * n * n + 3 * m + 12 * n <= plan["smem_bytes"] <= P1.SMEM_MAX
    assert plan["smem_bytes"] % 16 == 0
    assert P1.kernel_plan(n, 1)["smem_bytes"] == plan["smem_bytes"]


def test_kernel_plan_refuses_what_the_kernel_cannot_hold():
    assert P1.kernel_plan(12, 96)["na_eff"] == 66       # _phase1 slices to m
    assert P1.kernel_plan(124, 96)["smem_bytes"] < 60_000   # 4 blocks an SM
    for n, na in ((1, 96), (129, 96), (47, 0), (47, 129)):
        with pytest.raises(ValueError):
            P1.kernel_plan(n, na)


def _bad_inputs():
    dm = torch.zeros((3, 24, 24))
    return {
        "shape": (torch.zeros((3, 24, 25)), None, "must be"),
        "rank": (torch.zeros((24, 24)), None, "must be"),
        "dtype": (dm.double(), None, "float32"),
        "strided": (dm.transpose(1, 2), None, "contiguous"),
        "n_pts_shape": (dm, torch.zeros(2, dtype=torch.int32), "n_pts"),
        "n_pts_dtype": (dm, torch.zeros(3), "n_pts"),
        "cpu": (dm, torch.zeros(3, dtype=torch.int32), "CUDA"),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_launcher_refuses(case):
    """Every check runs before the library is built or loaded: a CPU
    tensor raises, there is no fallback to the plain version."""
    dm, n_pts, match = _bad_inputs()[case]
    before = P1.phase1_cuda.launches
    with pytest.raises(ValueError, match=match):
        P1.phase1_cuda(dm, 24, 2.0, 64, n_pts)
    assert P1.phase1_cuda.launches == before


def test_h1_diagrams_cuda_routes_phase1(monkeypatch):
    """A CPU tensor runs the plain `_phase1`; what a CUDA tensor runs per
    chunk (`diagrams_on_card`) calls the kernel's launcher, not `_phase1`."""
    dms = torch.as_tensor(_eeg_like(np.random.default_rng(2), 2, 24, 24))
    kw = dict(n=24, thresh=2.0, na_max=64, h1_max=64, step_budget=2048)
    plain_phase1 = th1._phase1
    calls = []

    def spy(*a, **k):
        calls.append("_phase1")
        return plain_phase1(*a, **k)

    def kernel(dm, n, thresh, na_max, n_pts=None):
        calls.append("phase1_cuda")
        return plain_phase1(dm, n, thresh, na_max, n_pts)

    monkeypatch.setattr(th1, "_phase1", spy)
    monkeypatch.setattr(thc, "phase1_cuda", kernel)
    want = th1.h1_diagrams_plain(dms, **kw)
    calls.clear()
    got = thc.h1_diagrams_cuda(dms, **kw)
    assert calls == ["_phase1"]
    calls.clear()
    monkeypatch.setattr(thc, "reduce_cuda", th1.reduce_plain)
    card = thc.diagrams_on_card(dms, None, **kw)
    assert calls == ["phase1_cuda"]
    for k in want:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(card[k], want[k]), k


def _kruskal(rank_mat, m_cx, n):
    """Kruskal by rank with union-find: the tree edges' ranks."""
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    iu, ju = np.triu_indices(n, 1)
    order = np.argsort(rank_mat[iu, ju])
    tree = set()
    for s in order:
        r = int(rank_mat[iu[s], ju[s]])
        if r >= m_cx:
            break
        a, b = find(iu[s]), find(ju[s])
        if a != b:
            parent[max(a, b)] = min(a, b)
            tree.add(r)
    return tree


def _kernel_forest(rank_mat, m_cx, n):
    """The kernel's rounds (`csrc/h1_phase1.cu`, step 3): every root hooks
    across its component's cheapest outgoing in-complex edge, a mutual pair
    keeps the smaller root, every vertex chases its root."""
    comp = np.arange(n)
    parent = np.arange(n)
    tree = set()
    while True:
        key = np.where((rank_mat < m_cx) & (comp[:, None] != comp[None, :]),
                       rank_mat, th1.BIG)
        best = key.min(axis=1)
        cbest = np.full(n, th1.BIG)
        np.minimum.at(cbest, comp, best)
        roots = [c for c in range(n) if comp[c] == c and cbest[c] < th1.BIG]
        if not roots:
            return tree
        for c in roots:
            e = int(cbest[c])
            tree.add(e)
            i, j = np.argwhere(rank_mat == e)[0]
            parent[c] = comp[j] if comp[i] == c else comp[i]
        parent = np.array([c if parent[c] != c and parent[parent[c]] == c
                           and c < parent[c] else parent[c] for c in range(n)])
        for v in range(n):
            x = comp[v]
            while parent[x] != x:
                x = parent[x]
            comp[v] = x


@pytest.mark.parametrize("cloud", ["random", "tied", "cut"])
def test_forest_is_unique(cloud):
    """The in-complex ranks are a strict total order, so the spanning
    forest is unique: the plain `_boruvka_forest`, Kruskal with union-find
    and the kernel's rounds give the same tree edges — the premise that lets
    the kernel use another forest algorithm than the plain version's."""
    rng = np.random.default_rng(21)
    thresh = 2.0
    if cloud == "tied":
        dm = _grid(18, B=4, seed=5)
    else:       # "cut": the complex stops at thresh 1.0, a few edges a vertex
        pts = rng.standard_normal((4, 30, 3))
        dm = np.sqrt(((pts[:, :, None] - pts[:, None]) ** 2).sum(-1)).astype(np.float32)
        thresh = 2.0 if cloud == "random" else 1.0
    n = dm.shape[-1]
    rk = th1._edge_ranks(torch.as_tensor(dm), n, thresh)
    tree_mat = th1._boruvka_forest(rk["key_mat"]).numpy()
    rank_mat, m_cx = rk["rank_mat"].numpy(), rk["m_cx"].numpy()
    if cloud == "cut":
        assert (m_cx < n * (n - 1) // 2).all() and (m_cx > 0).all()
    for b in range(len(dm)):
        plain = {int(r) for r in rank_mat[b][np.triu(tree_mat[b], 1)]}
        kruskal = _kruskal(rank_mat[b], int(m_cx[b]), n)
        assert plain == kruskal
        assert _kernel_forest(rank_mat[b], int(m_cx[b]), n) == kruskal


@pytest.mark.parametrize("cloud", ["eeg", "tied", "ragged"])
def test_sieve_compares_against_brute_force(cloud):
    """The bound's operation count: the sieve's compares, edge by edge and
    vertex by vertex until the first hit, against `sieve_compares`."""
    n_pts = None
    if cloud == "eeg":
        dm = torch.as_tensor(_eeg_like(np.random.default_rng(4), 3, 24, 24))
    elif cloud == "tied":
        dm = torch.as_tensor(_grid(18, B=3, seed=2))
    else:
        dm, n_pts = ragged_clouds("cpu", n_windows=6, seed=4)
    n = dm.shape[-1]
    ph = th1._phase1(dm, n, 2.0, 64, n_pts)
    rank = ph["rank_mat"].numpy()
    iu, ju = ph["iu_r"].numpy(), ph["ju_r"].numpy()
    want = np.zeros(len(dm), np.int64)
    for b in range(len(dm)):
        for r in range(ph["m"]):
            for v in range(n):
                want[b] += 2
                if rank[b, iu[b, r], v] < r and rank[b, ju[b, r], v] < r:
                    break
    assert np.array_equal(P1.sieve_compares(ph["vstar_r"], n).numpy(), want)
    assert (want > 0).all()


def _card_case(case):
    rng = np.random.default_rng(9)
    if case in ("n47", "n124"):
        n = 47 if case == "n47" else 124
        dm = _eeg_like(rng, 8, n - 3, n, T=250)
        return dm, np.full(8, n - 3, np.int32), n, 96
    if case == "tied":
        return _grid(18, B=16, seed=5), None, 18, 64
    if case == "nan":
        d, n_pts = _with_nan(rng)
        return d, n_pts, 16, 64
    dm, n_pts = ragged_clouds("cpu", n_windows=600)
    return dm.numpy(), n_pts.numpy(), 24, 64


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["n47", "n124", "ragged", "tied", "nan"])
def test_kernel_matches_phase1_on_card(case):
    """On a CUDA card: the kernel's dict equals `_phase1`'s bit for bit on
    every key (floats compared as their bits)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda)")
    dm, n_pts, n, na = _card_case(case)
    dm = torch.as_tensor(dm, device="cuda")
    n_pts = None if n_pts is None else torch.as_tensor(n_pts, device="cuda")
    before = P1.phase1_cuda.launches
    got = P1.phase1_cuda(dm, n, 2.0, na, n_pts)
    assert P1.phase1_cuda.launches == before + 1
    want = th1._phase1(dm, n, 2.0, na, n_pts)
    assert got["m"] == want["m"]
    for k in PHASE1_KEYS:
        a, b = got[k], want[k]
        assert a.dtype == b.dtype and a.shape == b.shape, (case, k)
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), (case, k)
