"""The exact H0 Wasserstein DP: the port's plain loop against the JAX
package on the CPU, a numpy model of the CUDA kernel's arithmetic, the
router and the launcher's host side.  The kernel itself runs on the card
only (the `cuda`-marked tests, chip_smoke.py's phase 13).

Shapes: the main path's (46, 123) (a comparison batch's EEG and audio H0
pads) and the staged path's (64, 128), with all-pad sides and tied deaths.
Tolerance against JAX: rtol and atol 1e-6 — the only float sum is cumw =
cumsum(bcol / 2), which torch's CPU cumsum accumulates in float64 and
rounds a prefix at a time, and XLA in another order.  The kernel's model
sorts each side by the kernel's bitonic network of keys, sums cumw by the
kernel's warp scan where every partial sum is exact in float64
(`scan_is_exact`, whose premise the `cumw` tests check: there the scan's
prefixes are torch's CPU cumsum's) and in column order elsewhere, and takes
every other float32 operation of the plain loop in the same order (a min
has no rounding), so it equals the plain loop bit for bit."""
import fractions
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tda_eeg_audio_tpu.ops import wasserstein as jw
from tda_eeg_audio_tpu_torch.ops import cuda_build
from tda_eeg_audio_tpu_torch.ops import wasserstein as tw
from tda_eeg_audio_tpu_torch.ops import wasserstein_h0_cuda as th0

torch.set_num_threads(1)

SHAPES = {"main": (46, 123), "staged": (64, 128)}


def _h0_pairs(K1, K2, n=40, seed=1):
    """Deaths (exponential, as H0 bars of correlation windows) with ~70 % of
    the slots valid; an all-pad side 1, an all-pad side 2, both all-pad, one
    bar against one, and tied deaths (values rounded to 1/8, and equal runs
    across the two sides)."""
    rng = np.random.default_rng(seed)
    d1 = rng.exponential(0.5, (n, K1)).astype(np.float32)
    d2 = rng.exponential(0.5, (n, K2)).astype(np.float32)
    m1 = rng.random((n, K1)) < 0.7
    m2 = rng.random((n, K2)) < 0.7
    m1[0] = False
    m2[1] = False
    m1[2] = m2[2] = False
    m1[3] = np.arange(K1) == 5
    m2[3] = np.arange(K2) == 9
    d1[4:8] = np.round(d1[4:8] * 8) / 8
    d2[4:8] = np.round(d2[4:8] * 8) / 8
    d2[6, :K1] = d1[6]
    d1[7, : K1 // 2] = 0.25
    return d1, m1, d2, m2


def _t(x):
    return torch.as_tensor(np.array(x))


def _sort_key(v):
    """The kernel's key: the float's bits made monotone, -0.0 as +0.0,
    every NaN the one +NaN above +inf."""
    v = np.where(v == 0, np.float32(0), v).astype(np.float32)
    u = np.where(np.isnan(v), np.uint32(0x7FC00000), v.view(np.uint32))
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def _key_value(k):
    """The value of a sort key (the kernel's key_value)."""
    k = np.asarray(k, np.uint32)
    return np.where(k & 0x80000000, k & 0x7FFFFFFF, ~k).astype(np.uint32).view(np.float32)


def _bitonic(keys):
    """The kernel's bitonic network over the next power of two ≥ K slots,
    slots past K holding the largest key: each slot s keeps the min or the
    max of itself and s ^ j, by stage k and distance j."""
    K = len(keys)
    n = 1 << max(K - 1, 0).bit_length()
    v = np.full(n, 0xFFFFFFFF, np.uint32)
    v[:K] = keys
    s = np.arange(n)
    k = 2
    while k <= n:
        j = k >> 1
        while j:
            o = v[s ^ j]
            keep_min = ((s & k) == 0) == ((s & j) == 0)
            v = np.where(keep_min, np.minimum(v, o), np.maximum(v, o))
            j >>= 1
        k <<= 1
    return v[:K]


def _cumw_sequential(b):
    """cumsum([0, b] / 2) as torch's CPU cumsum takes it: float64 sums in
    column order, each prefix rounded once."""
    f32 = np.float32
    cw = np.empty(len(b) + 1, np.float32)
    acc = 0.0
    for j in range(len(b) + 1):
        acc += float(b[j - 1] / f32(2)) if j else 0.0
        cw[j] = f32(acc)
    return cw


def _scan64(b, lanes=32, cols=th0.COLS):
    """The kernel's warp scan of cumw before rounding: lane l sums its
    columns 5 l + [0, 5) of [0, b] / 2 in float64 in order, a Kogge-Stone
    scan over the lanes' totals, then each column's float64 prefix."""
    col = np.zeros(lanes * cols)
    col[1:len(b) + 1] = (np.asarray(b, np.float32) / np.float32(2)).astype(np.float64)
    part = np.cumsum(col.reshape(lanes, cols), axis=1)
    tot = part[:, -1].copy()
    o = 1
    while o < lanes:
        tot = tot + np.concatenate([np.zeros(o), tot[:-o]])
        o <<= 1
    before = np.concatenate([[0.0], tot[:-1]])
    return (before[:, None] + part).reshape(-1)[:len(b) + 1]


def _cumw_scan(b):
    """cumw as the kernel's warp scan gives it: `_scan64` rounded once."""
    return _scan64(b).astype(np.float32)


def _kernel_model(d1, m1, d2, m2):
    """numpy model of csrc/wasserstein_h0.cu, one pair at a time: each side
    sorted by the bitonic network of its keys and read back as values, cumw
    by the warp scan where `scan_is_exact` holds and in column order
    elsewhere, and per row the float32 operations of the plain loop, the
    prefix min over five columns a lane, then over the lanes."""
    out = np.empty(d1.shape[0], np.float32)
    f32 = np.float32
    for p in range(d1.shape[0]):
        a, b = (_key_value(_bitonic(_sort_key(np.where(m, d, f32(0)))))
                for d, m in ((d1[p], m1[p]), (d2[p], m2[p])))
        K2 = len(b)
        bcol = np.concatenate([[f32(0)], b]).astype(np.float32)
        exact = th0.scan_is_exact(b / f32(2))
        cw = _cumw_scan(b) if exact else _cumw_sequential(b)
        lanes = -(-(K2 + 1) // 5)
        row = cw.copy()
        for ai in a:
            half = ai / f32(2)
            prev = np.concatenate([[f32(0)], row[:-1]]).astype(np.float32)
            term2 = (row + half).astype(np.float32)
            term1 = (prev + np.abs(ai - bcol)).astype(np.float32)
            c = np.minimum(term1, term2)
            c[0] = term2[0]
            x = (c - cw).astype(np.float32)
            pad = np.full(5 * lanes, np.inf, np.float32)
            pad[:K2 + 1] = x
            local = np.minimum.accumulate(pad.reshape(lanes, 5), axis=1)
            before = np.concatenate([[np.inf], np.minimum.accumulate(local[:, -1])[:-1]])
            cm = np.minimum(before[:, None], local).reshape(-1)[:K2 + 1]
            row = (cw + cm.astype(np.float32)).astype(np.float32)
        out[p] = row[K2]
    return out


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_matches_jax(shape):
    d1, m1, d2, m2 = _h0_pairs(*SHAPES[shape])
    want = np.asarray(jw.wasserstein_h0_exact(*(jnp.asarray(x) for x in (d1, m1, d2, m2))))
    got = tw.wasserstein_h0_exact_plain(*(_t(x) for x in (d1, m1, d2, m2))).numpy()
    err = np.abs(got - want) / (1e-6 + 1e-6 * np.abs(want))
    print(f"plain vs JAX at {SHAPES[shape]}: worst error / tolerance {err.max():.3f}")
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # an empty side costs the other side's sum of d / 2; both empty cost 0
    np.testing.assert_allclose(got[0], (d2[0] * m2[0]).sum() / 2, rtol=1e-6)
    np.testing.assert_allclose(got[1], (d1[1] * m1[1]).sum() / 2, rtol=1e-6)
    assert got[2] == 0.0


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernel_model_equals_plain_and_matches_jax(shape):
    """Premise of the kernel's design: its order of operations gives the
    plain loop's bits on the CPU, and JAX's values within 1e-6."""
    d1, m1, d2, m2 = _h0_pairs(*SHAPES[shape], n=16)
    got = _kernel_model(d1, m1, d2, m2)
    plain = tw.wasserstein_h0_exact_plain(*(_t(x) for x in (d1, m1, d2, m2))).numpy()
    want = np.asarray(jw.wasserstein_h0_exact(*(jnp.asarray(x) for x in (d1, m1, d2, m2))))
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_sort_key_orders_values_as_torch_does():
    """The rank sort's key orders values as torch.sort and jnp.sort do: -0.0
    and +0.0 tied, every NaN last."""
    v = np.array([0.5, -0.0, np.nan, 0.0, -np.nan, np.inf, -1.0, 0.5, 1e-38, -np.inf],
                 np.float32)
    k = _sort_key(v)
    order = np.argsort(k, kind="stable")
    ref = torch.sort(torch.as_tensor(v), stable=True).values.numpy()
    np.testing.assert_array_equal(v[order], ref)
    assert k[1] == k[3] and k[2] == k[4] and k[2] > k[5]


@pytest.mark.parametrize("K", [1, 2, 3, 5, 46, 64, 123, 128])
def test_bitonic_network_sorts_as_torch(K):
    """The kernel's register sort: its bitonic network over the next power
    of two ≥ K slots (pad keys last) orders the keys, and the values read
    back from them are torch.sort's (-0.0 read back as +0.0, which equals
    it; every NaN last)."""
    rng = np.random.default_rng(K)
    v = rng.exponential(0.5, K).astype(np.float32)
    v[rng.random(K) < 0.2] = 0.0
    v[rng.random(K) < 0.1] = -0.0
    v[rng.random(K) < 0.05] = np.nan
    v[: K // 4] = np.round(v[: K // 4] * 4) / 4           # ties
    keys = _bitonic(_sort_key(v))
    np.testing.assert_array_equal(keys, np.sort(_sort_key(v)))
    ref = torch.sort(torch.as_tensor(v)).values.numpy()
    np.testing.assert_array_equal(_key_value(keys), ref)


def _spread_halves(spread, K2=128, all_ones=True, seed=0):
    """K2 - 1 sorted deaths whose halves lie in the binade 2^(E_hi − 127) and
    one death whose half lies `spread` binades below, mantissas all ones
    (the worst case for exactness) or random."""
    rng = np.random.default_rng(seed)
    e_hi = 127
    mant = np.full(K2, 0x7FFFFF, np.uint32) if all_ones else \
        rng.integers(0, 1 << 23, K2).astype(np.uint32)
    exps = np.full(K2, e_hi, np.uint32)
    exps[0] = e_hi - spread
    halves = ((exps << 23) | mant).view(np.float32)
    return np.sort(halves * np.float32(2))


CUMW_CASES = ["main", "staged", "boundary", "boundary_random", "spread", "one_past"]


@pytest.mark.parametrize("case", CUMW_CASES)
def test_cumw_scan_premise(case):
    """Premise of the kernel's cumw: where `scan_is_exact` holds (the halves'
    exponents span at most 29 − ceil(log2 K2) binades), every float64 sum
    the warp scan forms is exact — it equals the exact rational sum — so
    its prefixes are torch's CPU cumsum's bit for bit; on the study-shaped
    and staged pairs it holds for every pair.  One binade past the bound a
    sum can be inexact, and a 1e-9 death beside deaths of ~1 spans ~30
    binades: there the kernel takes the sequential sum, and its model still
    equals the plain loop."""
    if case in SHAPES:
        d1, m1, d2, m2 = _h0_pairs(*SHAPES[case], n=300 if case == "main" else 40)
        bs = [np.sort(np.where(m, d, np.float32(0))) for d, m in zip(d2, m2)]
        assert all(th0.scan_is_exact(b / np.float32(2)) for b in bs)
        for b in bs:
            np.testing.assert_array_equal(_cumw_scan(b), _cumw_sequential(b))
            plain = torch.cumsum(torch.cat([torch.zeros(1), torch.as_tensor(b)]) / 2.0, 0)
            np.testing.assert_array_equal(_cumw_scan(b), plain.numpy())
        return
    if case == "spread":
        d1, m1, d2, m2 = _h0_pairs(46, 123, n=8, seed=5)
        d2[:, 0], m2[:, 0] = np.float32(1e-9), True
        d2[:, 1:], m2[:, 1:] = np.float32(1.0) + d2[:, 1:] % 1, True
        for d in d2:
            assert not th0.scan_is_exact(np.sort(d) / np.float32(2))
        plain = tw.wasserstein_h0_exact_plain(*(_t(x) for x in (d1, m1, d2, m2))).numpy()
        np.testing.assert_array_equal(_kernel_model(d1, m1, d2, m2), plain)
        return
    spread = 29 - 7 + (case == "one_past")
    b = _spread_halves(spread, all_ones=case != "boundary_random")
    halves = (b / np.float32(2)).astype(np.float64)
    exact = np.cumsum([fractions.Fraction(0)] + [fractions.Fraction(float(h)) for h in halves])
    if case == "one_past":             # the exact prefixes need more than 53 bits
        assert not th0.scan_is_exact(b / np.float32(2))
        assert any(fractions.Fraction(float(x)) != x for x in exact)
        return
    assert th0.scan_is_exact(b / np.float32(2))
    np.testing.assert_array_equal([fractions.Fraction(float(x)) for x in _scan64(b)], exact)
    np.testing.assert_array_equal(_cumw_scan(b), _cumw_sequential(b))


def test_router_takes_plain_on_cpu_and_launcher_refuses_cpu():
    args = [_t(x) for x in _h0_pairs(*SHAPES["main"], n=8)]
    before = th0.wasserstein_h0_cuda.launches
    np.testing.assert_array_equal(tw.wasserstein_h0_exact(*args).numpy(),
                                  tw.wasserstein_h0_exact_plain(*args).numpy())
    with pytest.raises(ValueError):
        th0.wasserstein_h0_cuda(*args)
    assert th0.wasserstein_h0_cuda.launches == before


def _no_nvcc():
    raise RuntimeError("nvcc not found")


def test_router_never_falls_back_off_the_cpu(tmp_path):
    """A tensor that is not on the CPU goes to the launcher, which raises
    for anything but a CUDA tensor (here the meta device: no card needed);
    and without nvcc the library does not load: no route to the plain loop
    remains."""
    args = [torch.empty(4, k, dtype=dt, device="meta")
            for k, dt in ((46, torch.float32), (46, torch.bool), (123, torch.float32),
                          (123, torch.bool))]
    with pytest.raises(ValueError, match="CUDA"):
        tw.wasserstein_h0_exact(*args)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_build, "_libs", {})
        mp.setattr(cuda_build, "_nvcc", _no_nvcc)
        mp.setattr(cuda_build, "BUILD_DIR", tmp_path)
        with pytest.raises(RuntimeError, match="nvcc"):
            cuda_build.load(th0.SRC, th0.SIGNATURES)


@pytest.mark.parametrize("K1,K2", [(46, 123), (64, 128), (1, 1), (128, 128)])
def test_kernel_plan_within_limits(K1, K2):
    """One warp a pair covers every column of a row (5 a lane) and fits an
    H100's block: threads, shared memory, registers at the launch bound."""
    plan = th0.kernel_plan(4800, K1, K2)
    assert plan["threads"] == 32 * plan["pairs_per_block"] <= 1024
    assert plan["grid"] * plan["pairs_per_block"] >= 4800
    assert 32 * plan["columns_per_lane"] >= K2 + 1
    assert plan["smem_bytes"] == th0.WARPS * 4 * (3 * th0.MAX_K + 1) <= cuda_build.SMEM_LIMIT
    assert 32 * plan["sort_keys_per_lane"] == th0.MAX_K
    assert plan["sort_steps"] == tuple(sum(range(1, (1 << max(k - 1, 0).bit_length())
                                                 .bit_length())) for k in (K1, K2))
    assert plan["threads"] * 255 <= cuda_build.REGS_PER_SM
    for bad in ((0, 5), (5, 0), (129, 5), (5, 129)):
        with pytest.raises(ValueError):
            th0.kernel_plan(1, *bad)


class _FakeLib:
    def __init__(self, report):
        self.report = report

    def wasserstein_h0_layout(self, out):
        arr = (ctypes.c_int * len(th0.LAYOUT_FIELDS)).from_address(out)
        for i, k in enumerate(th0.LAYOUT_FIELDS):
            arr[i] = self.report[k]
        return 0


def test_launcher_raises_when_the_library_disagrees_with_the_plan():
    plan = th0.kernel_plan(1, 1, 1)
    good = dict(threads=plan["threads"], pairs_per_block=plan["pairs_per_block"],
                smem_bytes=plan["smem_bytes"], registers=40, local_bytes=0, occupancy=12)
    assert th0.check_layout(_FakeLib(good)) == good
    for change in (dict(threads=256), dict(pairs_per_block=8), dict(smem_bytes=0),
                   dict(registers=600), dict(occupancy=0)):
        with pytest.raises(RuntimeError, match="disagree"):
            th0.check_layout(_FakeLib(dict(good, **change)))


def _card_cases():
    cases = {k: _h0_pairs(*v, n=300) for k, v in SHAPES.items()}
    d1, m1, d2, m2 = _h0_pairs(46, 123, n=64, seed=3)
    d1[::3, 0] = np.nan                     # NaN deaths (valid slots)
    cases["nan"] = (d1, m1, d2, m2)
    d1, m1, d2, m2 = _h0_pairs(46, 123, n=64, seed=4)
    d2[::2, 0], m2[::2, 0] = np.float32(1e-9), True     # cumw in column order
    cases["spread"] = (d1, m1, d2, m2)
    return cases


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """On a CUDA card: one launch a call, bit for bit equal to the plain loop
    on the CPU (NaN where it is NaN), within 1e-6 of the card's plain loop
    (its cumsum sums in another order), and the same from strided rows;
    `spread` pairs (a 1e-9 death beside deaths of ~1) take lane 0's
    sequential cumw, the others the warp scan."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda)")
    print(f"layout: {th0.layout_report()}")
    for name, args in _card_cases().items():
        xs = [torch.as_tensor(x, device="cuda") for x in args]
        before = th0.wasserstein_h0_cuda.launches
        got = tw.wasserstein_h0_exact(*xs)
        assert th0.wasserstein_h0_cuda.launches == before + 1
        cpu = tw.wasserstein_h0_exact_plain(*(_t(x) for x in args)).numpy()
        card = tw.wasserstein_h0_exact_plain(*xs).cpu().numpy()
        got = got.cpu().numpy()
        np.testing.assert_array_equal(got, cpu, err_msg=name)
        np.testing.assert_allclose(got, card, rtol=1e-6, atol=1e-6, err_msg=name)
        wide = [torch.cat([x, x], dim=1)[:, :x.shape[1]] for x in xs]
        np.testing.assert_array_equal(tw.wasserstein_h0_exact(*wide).cpu().numpy(), got)
