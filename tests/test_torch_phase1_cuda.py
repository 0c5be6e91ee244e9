"""The H1 phase-1 kernel's host side, on the CPU: its launch plan, the
launcher's checks, the route `h1_diagrams_cuda` takes, the premises of the
kernel's sort (a numpy model of its key and bitonic passes gives JAX's and
the plain version's edge order) and of its forest algorithm, and the count
its bound rests on.  The kernel itself runs on the card only (the
`cuda`-marked cases here, chip_smoke.py's phase 3b)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import uniform_filter1d

from chip_smoke import grid_clouds, ragged_clouds, signed_zero_windows
from tda_eeg_audio_tpu.ops import homology_h1 as jh1
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
    assert plan["threads"] == (128 if n <= 64 else 512)
    # the sort: a thread per 16 edges
    assert plan["threads"] * P1.SEG >= m
    # uint64 keys, one spare per 16, overlaid by the uint16 rank matrix
    # (rows 16-byte multiples, an odd number of them) and the uint8 flags;
    # uint16 (i << 7 | j) by rank; the forest's uint8 roots, four int arrays
    # of it and its tree edges; 16-byte aligned, within a block's shared
    # memory
    ns = P1.row_stride(n)
    assert ns >= n and ns % 8 == 0 and (ns // 8) % 2 == 1 and ns < n + 16
    assert (max(8 * (m + m // 16), 2 * n * ns + m) + 2 * m + ns + 16 * n
            <= plan["smem_bytes"] <= P1.SMEM_MAX)
    assert plan["smem_bytes"] % 16 == 0
    assert P1.kernel_plan(n, 1)["smem_bytes"] == plan["smem_bytes"]


def test_kernel_plan_refuses_what_the_kernel_cannot_hold():
    assert P1.kernel_plan(12, 96)["na_eff"] == 66       # _phase1 slices to m
    # the rank matrix and flags overlay the sort's keys: 82,480 B at
    # n = 124, so shared memory holds the 2 blocks an SM that the registers
    # of 512 threads allow (233,472 B an SM, 1,024 reserved a block)
    assert P1.kernel_plan(124, 96)["smem_bytes"] == 82_480
    assert 2 * (82_480 + 1024) <= 233_472
    assert all(P1.kernel_plan(n, 96)["smem_bytes"] <= P1.SMEM_MAX
               for n in range(2, P1.MAX_N + 1))
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


NAN_KEY = 0xFFC00000


def _model_key(w):
    """`csrc/h1_phase1.cu::sort_key`: −0.0 as +0.0, every NaN one key above
    +inf, then the sign-flip twiddle; float32 → uint32."""
    u = np.asarray(w, np.float32).view(np.uint32).copy()
    u[u == 0x80000000] = 0
    key = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)
    return np.where(np.isnan(w), np.uint32(NAN_KEY), key)


def _model_merge_sort(c):
    """The kernel's `merge_sort`, with its index arithmetic: a bitonic
    network sorts each segment of 16 (positions past m read as a key above
    all; each block size k starts with the flip, e against e ^ (k − 1), then
    halves strides), then runs of L = 16, 32, ... merge pairwise, each
    segment's 16 outputs from the split its binary search finds on the merge
    path.  c: (m,) uint64 composite keys; returns them sorted."""
    m, S = len(c), P1.SEG
    NONE = np.uint64(2**64 - 1)
    nseg = -(-m // S)
    seg = np.full((nseg, S), NONE, np.uint64)
    seg.reshape(-1)[:m] = c

    def swap(a, b):
        lo, hi = np.minimum(seg[:, a], seg[:, b]), np.maximum(seg[:, a], seg[:, b])
        seg[:, a], seg[:, b] = lo, hi

    for k in (2, 4, 8, 16):
        for e in range(S):
            if e & (k // 2) == 0:
                swap(e, e ^ (k - 1))
        j = k // 4
        while j:
            for e in range(S):
                if e & j == 0:
                    swap(e, e + j)
            j //= 2
    buf = seg.reshape(-1)[:m].copy()
    L = S
    while L < m:
        out = np.empty_like(buf)
        for s0 in range(0, m, S):
            a0 = s0 // (2 * L) * (2 * L)
            d = s0 - a0
            la, lb = min(L, m - a0), max(0, min(L, m - a0 - L))
            b0 = a0 + L
            lo, hi = max(0, d - lb), min(d, la)
            while lo < hi:
                mid = (lo + hi) // 2
                if buf[a0 + mid] < buf[b0 + d - 1 - mid]:
                    lo = mid + 1
                else:
                    hi = mid
            ia, ib = lo, d - lo
            for e in range(min(S, m - s0)):
                ha = buf[a0 + ia] if ia < la else NONE
                hb = buf[b0 + ib] if ib < lb else NONE
                if ha < hb:
                    out[s0 + e], ia = ha, ia + 1
                else:
                    out[s0 + e], ib = hb, ib + 1
        buf = out
        L *= 2
    return buf


def _model_order(dm):
    """The kernel's edge order of each window: static edge index by rank
    (B, m) int64 and ew_r read from dm at each rank's (i, j)."""
    B, n, _ = dm.shape
    iu, ju = np.triu_indices(n, 1)
    m = len(iu)
    order = np.empty((B, m), np.int64)
    for b in range(B):
        c = (_model_key(dm[b][iu, ju]).astype(np.uint64) << np.uint64(16)) \
            | (iu << 7 | ju).astype(np.uint64)
        ij = (_model_merge_sort(c) & np.uint64(0xFFFF)).astype(np.int64)
        i, j = ij >> 7, ij & 127
        order[b] = i * n - i * (i + 1) // 2 + j - i - 1
    rows = np.arange(B)[:, None]
    return order, dm[rows, iu[order], ju[order]]


def _special(n, B=2, seed=0):
    """Symmetric windows of quarter-step weights (exact positive ties) with
    −0.0 and +0.0, +NaN and −NaN and +inf sprinkled over the edges."""
    rng = np.random.default_rng(seed + n)
    d = (rng.integers(0, 12, (B, n, n)) / 4.0).astype(np.float32)
    pick = rng.random((B, n, n))
    d[pick < 0.15] = -0.0
    d[(pick >= 0.15) & (pick < 0.25)] = 0.0
    d[(pick >= 0.25) & (pick < 0.29)] = np.nan
    d[(pick >= 0.29) & (pick < 0.31)] = np.uint32(0xFFC00000).view(np.float32)
    d[(pick >= 0.31) & (pick < 0.34)] = np.inf
    up = np.triu(np.ones((n, n), bool), 1)
    d = np.where(up, d, d.transpose(0, 2, 1))           # mirror, bits and all
    d[:, np.arange(n), np.arange(n)] = 0.0
    return d.astype(np.float32)


@pytest.mark.parametrize("n", [2, 24, 47, 124, 128])
def test_sort_order_matches_jax_and_plain(n):
    """The kernel's key and merge sort (numpy model) give the permutation of
    JAX's stable `_sort_with_payload` and of the plain `_phase1`'s
    `torch.sort(stable=True)` on the CPU, and ew_r with the same bits, on
    windows with ±0.0 ties, ±NaN, +inf and exact ties; the last segment of
    16 is partial at every n here (at n = 2 one edge and 15 keys above
    NaN's), and n = 128 merges 9 levels of runs."""
    dm = _special(n)
    iu, ju = np.triu_indices(n, 1)
    w = dm[:, iu, ju]
    assert (w.view(np.uint32) == 0x80000000).any() and (w.view(np.uint32) == 0).any() \
        or n == 2
    order, ew_r = _model_order(dm)
    iota = jnp.broadcast_to(jnp.arange(w.shape[1], dtype=jnp.int32), w.shape)
    ew_j, order_j = jh1._sort_with_payload(jnp.asarray(w), iota)
    rk = th1._edge_ranks(torch.as_tensor(dm), n, 2.0)
    np.testing.assert_array_equal(order, np.asarray(order_j))
    np.testing.assert_array_equal(order, rk["e_sort"].numpy())
    np.testing.assert_array_equal(ew_r.view(np.int32), np.asarray(ew_j).view(np.int32))
    np.testing.assert_array_equal(ew_r.view(np.int32), rk["ew_r"].numpy().view(np.int32))


def test_sort_key_is_a_total_order_of_weights():
    """−0.0 and +0.0 share a key, every NaN (either sign, any payload) the
    one key above +inf, and finite keys follow the float order."""
    x = np.array([-np.inf, -3.5, -1e-30, -0.0, 0.0, 1e-45, 0.25, 2.0, 3e38, np.inf],
                 np.float32)
    k = _model_key(x)
    assert (np.diff(k.astype(np.int64)) >= 0).all() and k[3] == k[4]
    assert len(set(k.tolist())) == len(x) - 1
    nans = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFFFFFFF],
                    np.uint32).view(np.float32)
    assert (_model_key(nans) == NAN_KEY).all() and NAN_KEY > k[-1]


def test_phase1_signed_zero_bits_match_jax():
    """On windows with −0.0 and +0.0 weights and ±NaN channels
    (chip_smoke.py's `signed_zero` case, made on the CPU) the plain `_phase1`
    equals JAX's bit for bit on every key: its H0 deaths sort is stable, as
    `jnp.sort` is, so tied ±0.0 tree weights keep rank order."""
    d = signed_zero_windows(torch.as_tensor(_eeg_like(np.random.default_rng(3),
                                                      16, 47, 47)), 16)
    ph_t = th1._phase1(d, 47, 2.0, 96)
    ph_j = jh1._phase1(jnp.asarray(d.numpy()), 47, 2.0, 96)
    h0 = ph_t["h0_deaths"].numpy().view(np.uint32)
    assert ((h0 == 0x80000000).any(1) & (h0 == 0).any(1)).any()   # both signs tied
    for k in PHASE1_KEYS:
        a, b = ph_t[k].numpy(), np.asarray(ph_j[k])
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=k)


def _sort_nan_sign_first(x, dim=-1, stable=False):
    """A stable sort that puts a NaN with its sign bit set first, the rest in
    the CPU's order: what the card's `torch.sort(stable=True)` does."""
    neg_nan = x.isnan() & (x.view(torch.int32) < 0)
    first = _cpu_sort(torch.where(neg_nan, -math.inf, x), dim=dim, stable=True).indices
    group = neg_nan.gather(dim, first).logical_not().to(torch.uint8)
    second = _cpu_sort(group, dim=dim, stable=True).indices
    idx = first.gather(dim, second)
    return torch.return_types.sort((x.gather(dim, idx), idx))


_cpu_sort = torch.sort


def test_plain_sort_keeps_bits_and_jax_order_whatever_the_nan_sign(monkeypatch):
    """On windows with ±0.0 ties and +NaN / −NaN channels (chip_smoke.py's
    `signed_zero` case), the plain `_edge_ranks` gives JAX's
    `_sort_with_payload` order and ew_r keeps the input's bits (−NaN stays
    0xFFC00000, −0.0 stays −0.0) — also under a sort that puts a NaN with
    its sign bit first, as the card's does: the plain version sorts a key
    with every NaN made the one +NaN."""
    d = signed_zero_windows(torch.as_tensor(_eeg_like(np.random.default_rng(4),
                                                      16, 47, 47)), 16)
    iu, ju = np.triu_indices(47, 1)
    w = d.numpy()[:, iu, ju]
    assert (w.view(np.uint32) == 0xFFC00000).any() and (w.view(np.uint32) == 0x7FC00000).any()
    iota = jnp.broadcast_to(jnp.arange(w.shape[1], dtype=jnp.int32), w.shape)
    _, order_j = jh1._sort_with_payload(jnp.asarray(w), iota)
    for sort in (_cpu_sort, _sort_nan_sign_first):
        monkeypatch.setattr(torch, "sort", sort)
        rk = th1._edge_ranks(d, 47, 2.0)
        monkeypatch.setattr(torch, "sort", _cpu_sort)
        e_sort = rk["e_sort"].numpy()
        np.testing.assert_array_equal(e_sort, np.asarray(order_j), err_msg=sort.__name__)
        bits = rk["ew_r"].numpy().view(np.uint32)
        np.testing.assert_array_equal(bits, np.take_along_axis(w, e_sort, 1).view(np.uint32))
        assert (bits == 0xFFC00000).any() and (bits == 0x80000000).any()
    # the card-like sort does put −NaN first on the raw weights
    raw = _sort_nan_sign_first(torch.as_tensor(w)).indices.numpy()
    assert not np.array_equal(raw, np.asarray(order_j))


def _both_below(x, y, rr):
    """`csrc/h1_phase1.cu::both_below` on uint32 arrays."""
    m32 = np.uint32(0x80008000)
    return ~((x | m32) - rr) & ~((y | m32) - rr) & m32


def test_both_below_compares_two_ranks_at_once():
    """Two 16-bit ranks packed in a word, all below 0x8000 (the rank matrix's
    0x7FFF stands for absent), against r in both halves: bit 15 / bit 31
    set exactly where both words' low / high ranks are below r."""
    rng = np.random.default_rng(6)
    lo_x, hi_x, lo_y, hi_y = rng.integers(0, 0x8000, (4, 200_000)).astype(np.uint32)
    r = rng.integers(0, 8128, 200_000).astype(np.uint32)
    r[:4] = [0, 0, 8127, 8127]
    lo_x[:4] = hi_x[:4] = lo_y[:4] = hi_y[:4] = [0, 0x7FFF, 8126, 8127]
    h = _both_below(lo_x | hi_x << 16, lo_y | hi_y << 16, r * np.uint32(0x10001))
    np.testing.assert_array_equal((h & 0x8000) != 0, (lo_x < r) & (lo_y < r))
    np.testing.assert_array_equal((h & 0x80000000) != 0, (hi_x < r) & (hi_y < r))
    assert (h & ~np.uint32(0x80008000)).max() == 0


@pytest.mark.parametrize("cloud", ["eeg", "tied", "ragged"])
def test_sieve_eight_at_a_time_and_tree_edges(cloud):
    """The kernel's sieve (numpy model): rows of the uint16 rank matrix
    `row_stride(n)` apart, absent and padding 0x7FFF, 8 vertices a step by
    `both_below`, the first hit's half picked from its word — gives the
    plain vstar of every edge; and every tree edge (Kruskal) has none, so
    the kernel skips their scans."""
    n_pts = None
    if cloud == "eeg":
        dm = torch.as_tensor(_eeg_like(np.random.default_rng(4), 3, 47, 47))
    elif cloud == "tied":
        dm = torch.as_tensor(_grid(18, B=3, seed=2))
    else:
        dm, n_pts = ragged_clouds("cpu", n_windows=6, seed=4)
    n = dm.shape[-1]
    ph = th1._phase1(dm, n, 2.0, 64, n_pts)
    rank = ph["rank_mat"].numpy()
    ns = P1.row_stride(n)
    R = np.full(rank.shape[:2] + (ns,), 0x7FFF, np.uint32)
    R[:, :, :n] = np.where(rank >= th1.BIG, 0x7FFF, rank)
    W = R[:, :, 0::2] | R[:, :, 1::2] << 16                     # (B, n, ns / 2)
    iu, ju = ph["iu_r"].numpy(), ph["ju_r"].numpy()
    B, m = iu.shape
    rr = (np.arange(m, dtype=np.uint32) * np.uint32(0x10001))[None, :, None]
    bi = np.arange(B)[:, None]
    h = _both_below(W[bi, iu], W[bi, ju], rr)                    # (B, m, ns / 2)
    vs = np.full((B, m), -1)
    for v0 in range(0, n, 8):
        for q in range(4):
            w = h[:, :, v0 // 2 + q]
            hit = (vs < 0) & (w != 0)
            vs[hit] = v0 + 2 * q + np.where(w[hit] & 0x8000, 0, 1)
    np.testing.assert_array_equal(vs, ph["vstar_r"].numpy())
    m_cx = ph["m_cx"].numpy()
    for b in range(B):
        tree = sorted(_kruskal(rank[b], int(m_cx[b]), n))
        assert (vs[b, tree] == -1).all()


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
    if case == "signed_zero":
        d = signed_zero_windows(torch.as_tensor(_eeg_like(rng, 8, 47, 47)), 8)
        return d.numpy(), None, 47, 96
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


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["signed_zero", "nan"])
def test_kernel_matches_cpu_phase1_on_card(case):
    """On a CUDA card: the kernel's dict equals `_phase1` run on the CPU bit
    for bit on every key, on windows with tied -0.0 / +0.0 weights and ±NaN
    channels, and with NaN windows: the CPU's (and JAX's) edge order is the
    reference, not the card's own sort."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda)")
    dm, n_pts, n, na = _card_case(case)
    want = th1._phase1(torch.as_tensor(dm), n, 2.0, na,
                       None if n_pts is None else torch.as_tensor(n_pts))
    got = P1.phase1_cuda(torch.as_tensor(dm, device="cuda"), n, 2.0, na,
                         None if n_pts is None else torch.as_tensor(n_pts, device="cuda"))
    for k in PHASE1_KEYS:
        a, b = got[k].cpu(), want[k]
        assert a.dtype == b.dtype and a.shape == b.shape, (case, k)
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), (case, k)


@pytest.mark.cuda
def test_plain_phase1_on_card_equals_cpu():
    """On a CUDA card: the plain `_phase1` on the card equals the CPU's bit
    for bit on every key of chip_smoke.py's `signed_zero` windows (±0.0
    ties, −0.0 diagonals, +NaN and −NaN channels): its edge order does not
    depend on the device's sort."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda)")
    d = signed_zero_windows(torch.as_tensor(_eeg_like(np.random.default_rng(12),
                                                      256, 47, 47)))
    want = th1._phase1(d, 47, 2.0, 128)
    got = th1._phase1(d.to("cuda"), 47, 2.0, 128)
    assert got["m"] == want["m"]
    for k in PHASE1_KEYS:
        a, b = got[k].cpu(), want[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), k


@pytest.mark.cuda
@pytest.mark.parametrize("threads", [96, 160, 256])
def test_kernel_bits_do_not_depend_on_block_size(threads, monkeypatch):
    """On a CUDA card: blocks of another thread count than `kernel_plan`'s
    (a multiple of 32, one thread or more per vertex and per 16 edges) give
    `_phase1`'s bits too, on 512 windows at n = 47: a barrier missing
    between two parts of the kernel shows up here as a difference."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda)")
    dm = torch.as_tensor(_eeg_like(np.random.default_rng(11), 512, 44, 47, T=250),
                         device="cuda")
    plan = P1.kernel_plan
    monkeypatch.setattr(P1, "kernel_plan",
                        lambda n, na: dict(plan(n, na), threads=threads))
    got = P1.phase1_cuda(dm, 47, 2.0, 96)
    want = th1._phase1(dm, 47, 2.0, 96)
    for k in PHASE1_KEYS:
        a, b = got[k], want[k]
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), (threads, k)


@pytest.mark.cuda
@pytest.mark.parametrize("n_pts_dtype", [torch.int32, torch.int64])
def test_launcher_is_one_kernel_on_card(n_pts_dtype):
    """On a CUDA card: a call of `phase1_cuda` runs one kernel on the card,
    the phase-1 kernel, and nothing in front of it (no sort, gather or
    conversion of n_pts, which it reads as int32 or int64)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda)")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dm, n_pts, n, na = _card_case("n124")
    dm = torch.as_tensor(dm, device="cuda")
    n_pts = torch.as_tensor(n_pts, device="cuda").to(n_pts_dtype)
    P1.phase1_cuda(dm, n, 2.0, na, n_pts)           # build and load first
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        P1.phase1_cuda(dm, n, 2.0, na, n_pts)
        torch.cuda.synchronize()
    on_card = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(on_card) == 1 and "h1_phase1_kernel" in on_card[0], on_card
