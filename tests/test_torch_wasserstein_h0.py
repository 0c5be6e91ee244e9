"""The exact H0 Wasserstein DP: the port's plain loop against the JAX
package on the CPU, a numpy model of the CUDA kernel's arithmetic, the
router and the launcher's host side.  The kernel itself runs on the card
only (the `cuda`-marked tests, chip_smoke.py's phase 13).

Shapes: the main path's (46, 123) (a comparison batch's EEG and audio H0
pads) and the staged path's (64, 128), with all-pad sides and tied deaths.
Tolerance against JAX: rtol and atol 1e-6 — the only float sum is cumw =
cumsum(bcol / 2), which torch's CPU cumsum accumulates in float64 and
rounds a prefix at a time, and XLA in another order.  The kernel's model
sums cumw as torch's CPU cumsum does, and takes every other float32
operation of the plain loop in the same order (a min has no rounding), so
it equals the plain loop bit for bit."""
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


def _kernel_model(d1, m1, d2, m2):
    """numpy model of csrc/wasserstein_h0.cu, one pair at a time: the rank
    sort of each side, cumw summed in float64 in column order and rounded
    once a prefix, and per row the float32 operations of the plain loop, the
    prefix min over five columns a lane, then over the lanes."""
    out = np.empty(d1.shape[0], np.float32)
    f32 = np.float32
    for p in range(d1.shape[0]):
        sides = []
        for d, m in ((d1[p], m1[p]), (d2[p], m2[p])):
            v = np.where(m, d, f32(0)).astype(np.float32)
            k = _sort_key(v)
            idx = np.arange(len(v))
            rank = [(k < k[s]).sum() + ((k == k[s]) & (idx < s)).sum() for s in idx]
            srt = np.empty_like(v)
            srt[rank] = v
            sides.append(srt)
        a, b = sides
        K2 = len(b)
        bcol = np.concatenate([[f32(0)], b]).astype(np.float32)
        cw = np.empty(K2 + 1, np.float32)
        acc = 0.0
        for j in range(K2 + 1):
            acc += float(bcol[j] / f32(2)) if j else 0.0
            cw[j] = f32(acc)
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
        mp.setattr(th0, "_libs", {})
        mp.setattr(cuda_build, "_nvcc", _no_nvcc)
        mp.setattr(cuda_build, "BUILD_DIR", tmp_path)
        with pytest.raises(RuntimeError, match="nvcc"):
            th0._load()


@pytest.mark.parametrize("K1,K2", [(46, 123), (64, 128), (1, 1), (128, 128)])
def test_kernel_plan_within_limits(K1, K2):
    """One warp a pair covers every column of a row (5 a lane) and fits an
    H100's block: threads, shared memory, registers at the launch bound."""
    plan = th0.kernel_plan(4800, K1, K2)
    assert plan["threads"] == 32 * plan["pairs_per_block"] <= 1024
    assert plan["grid"] * plan["pairs_per_block"] >= 4800
    assert 32 * plan["columns_per_lane"] >= K2 + 1
    assert plan["smem_bytes"] == th0.WARPS * 4 * (4 * th0.MAX_K + 1) <= cuda_build.SMEM_LIMIT
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
    return cases


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """On a CUDA card: one launch a call, bit for bit equal to the plain loop
    on the CPU (NaN where it is NaN), within 1e-6 of the card's plain loop
    (its cumsum sums in another order), and the same from strided rows."""
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
