"""The un-tiered log-domain H1 Sinkhorn of the staged path and the control's
exact redo: the port's plain `sinkhorn_cost` and `StudyRunner._wass_chunks`
against the JAX package on the CPU, the premises of the CUDA kernel's design
(each pair at its own width; a torch model of its arithmetic), the router
and the launcher's host side.  The kernel itself runs on the card only (the
`cuda`-marked tests, chip_smoke.py's phase 13).

Tolerances: the plain version against JAX rtol 1e-4 — the ladder ends at
ε = 1e-4 × the pair's cost scale, so a float32 rounding of a dual moves
<P, D> by ~1e-5 of its value on these pairs (1.7e-5 read against JAX); the
own width against the full pad rtol 1e-4 (only the summation order
differs); the kernel's model within 2e-4 of the plain float32 version and
1e-4 of a float64 run of the plain version (chip_smoke.py's gates).  Each
worst case is printed (`pytest -rP`)."""
import ctypes
import dataclasses
import inspect
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ops import _study_diagrams
from tda_eeg_audio_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from tda_eeg_audio_tpu.models import study as jstudy
from tda_eeg_audio_tpu.ops import wasserstein as jw
from tda_eeg_audio_tpu_torch.config import DEFAULT_CONFIG
from tda_eeg_audio_tpu_torch.models import programs as tprog
from tda_eeg_audio_tpu_torch.models import study as tstudy
from tda_eeg_audio_tpu_torch.ops import cuda_build
from tda_eeg_audio_tpu_torch.ops import sinkhorn_log_cuda as tsl
from tda_eeg_audio_tpu_torch.ops import wasserstein as tw

torch.set_num_threads(1)


def _pairs(K, counts1, counts2, seed=4):
    """Study-shaped pairs (births 0.3–1.5, exponential persistence) with the
    given bar counts, scattered over K-slot rows; pair 0 has two empty
    sides, and the last pair is one diagram against itself with a
    duplicated bar (coincident bars)."""
    rng = np.random.default_rng(seed)
    b1, d1, m1 = _study_diagrams(rng, counts1, K)
    b2, d2, m2 = _study_diagrams(rng, counts2, K)
    b2[-1], d2[-1], m2[-1] = b1[-1], d1[-1], m1[-1]
    free = np.flatnonzero(~m1[-1])
    if len(free):
        src = np.flatnonzero(m1[-1])[0]
        for b, d, m in ((b1, d1, m1), (b2, d2, m2)):
            b[-1, free[0]], d[-1, free[0]], m[-1, free[0]] = b[-1, src], d[-1, src], True
    return b1, d1, m1, b2, d2, m2


# bar counts per side: empty sides (both, either), one bar, up to the pad
CASES = {
    8: ([0, 0, 3, 1, 8, 5, 2, 7] * 3, [0, 4, 0, 1, 8, 6, 3, 5] * 3),
    40: ([0, 0, 12, 1, 40, 25, 7, 30, 19, 3, 33, 40, 16, 22, 9, 12],
         [0, 15, 0, 1, 40, 18, 35, 11, 24, 3, 28, 5, 38, 20, 13, 12]),
    128: ([0, 60, 0, 128, 90, 17, 45, 70], [0, 0, 80, 128, 33, 100, 52, 70]),
}


def _t(x):
    return torch.as_tensor(np.array(x))


def _plain(args, dtype=torch.float32):
    t = [_t(x) for x in args]
    if dtype != torch.float32:
        t = [x.to(dtype) if x.is_floating_point() else x for x in t]
    return tw.sinkhorn_cost_pairs(*t).double().numpy()


def _worst(got, ref):
    nz = ref != 0
    return float(np.max(np.abs(got - ref)[nz] / np.abs(ref[nz])))


@pytest.mark.parametrize("K", sorted(CASES))
def test_plain_sinkhorn_matches_jax(K):
    args = _pairs(K, *CASES[K])
    want = np.asarray(jw.sinkhorn_cost(jw.build_cost_matrix(
        *(jnp.asarray(x) for x in args))))
    got = tw.sinkhorn_cost(tw.build_cost_matrix(*(_t(x) for x in args))).numpy()
    print(f"plain sinkhorn_cost vs JAX at K = {K}: max rel err {_worst(got, want):.3e}")
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # two empty sides cost 0, a diagram against itself ~0, and an empty side
    # the other side's sum of (d - b) / 2
    assert got[0] == 0.0 and got[-1] < 1e-3 * got.max()
    b1, d1, m1, b2, d2, m2 = args
    half = ((d1[1] - b1[1]) * m1[1]).sum() / 2 + ((d2[1] - b2[1]) * m2[1]).sum() / 2
    assert min(m1[1].sum(), m2[1].sum()) == 0
    np.testing.assert_allclose(got[1], half, rtol=1e-4)


def test_wass_chunks_matches_jax_runner():
    """`StudyRunner._wass_chunks` under wasserstein_backend="sinkhorn", the
    port's (the router: the plain version in 512-pair pieces) against the
    JAX runner's (512-pair XLA calls), over 600 pairs: two pieces.  rtol
    2e-4, the float32 floor of the ladder (as the tiered Sinkhorn's tests):
    over 600 pairs of 0–8 bars each float32 version sits up to 1.7e-4 from
    a float64 run, in other pairs."""
    rng = np.random.default_rng(9)
    c1, c2 = rng.integers(0, 9, 600), rng.integers(0, 9, 600)
    c1[:3], c2[:3] = (0, 0, 4), (0, 5, 0)
    args = _pairs(8, c1, c2)
    jr = SimpleNamespace(cfg=dataclasses.replace(JAX_CONFIG, wasserstein_backend="sinkhorn"))
    tr = SimpleNamespace(cfg=dataclasses.replace(DEFAULT_CONFIG, wasserstein_backend="sinkhorn"))
    want = jstudy.StudyRunner._wass_chunks(jr, *args)
    got = tstudy.StudyRunner._wass_chunks(tr, *(_t(x) for x in args)).numpy()
    print(f"_wass_chunks vs the JAX runner's (600 pairs): max rel err {_worst(got, want):.3e}")
    assert got.shape == (600,) and tw.SINKHORN_CHUNK < 600
    np.testing.assert_allclose(got, want, rtol=2e-4)


@pytest.mark.parametrize("K", [40, 128])
def test_own_width_equals_full_pad(K):
    """Premise of the kernel's design: each pair at its own width (its valid
    bars only, n1 + n2) costs what it costs at the pad width; pad rows and
    columns are zero-cost pad↔pad matches whose entries in real rows
    underflow to exactly 0."""
    args = _pairs(K, *CASES[K])
    full = _plain(args)
    t = [_t(x) for x in args]
    b1, d1, m1 = tprog._compact_rows(*t[:3])
    b2, d2, m2 = tprog._compact_rows(*t[3:])
    own = np.empty(len(full))
    for p in range(len(full)):
        n1, n2 = max(int(m1[p].sum()), 1), max(int(m2[p].sum()), 1)
        own[p] = tw.sinkhorn_cost(tw.build_cost_matrix(
            b1[p:p + 1, :n1], d1[p:p + 1, :n1], m1[p:p + 1, :n1],
            b2[p:p + 1, :n2], d2[p:p + 1, :n2], m2[p:p + 1, :n2]))[0]
    print(f"own width vs pad width {K}: max rel err {_worst(own, full):.3e}")
    np.testing.assert_allclose(own, full, rtol=1e-4)


def _nanmax(a, b):
    return torch.where(torch.isnan(a) | (a > b), a, b)


def _kernel_model(b1, d1, m1, b2, d2, m2, chunk=tsl.CHUNK):
    """torch model of csrc/sinkhorn_log.cu, vectorised over pairs: the bars
    compacted to the front as float64 (the [[0, 0]] sentinel for an empty
    side), the cost matrix at each pair's own width in the kernel's layout
    (rows [side-1 bars | side-2 helpers], columns [side-2 bars | side-1
    slots], each block padded to a multiple of the chunk with entries of
    exponent -inf, which add nothing), float64 duals, and each half-step's
    logsumexp online in chunks: the chunk's max rescales the float64 sum by
    expf, the chunk's expf terms summed in float32 in order."""
    K1, K2 = b1.shape[1], b2.shape[1]
    sides = []
    for b, d, m in ((b1, d1, m1), (b2, d2, m2)):
        b, d, m = tprog._compact_rows(b, d, m)
        n = m.sum(1)
        b, d = torch.where(m, b, 0.0).double(), torch.where(m, d, 0.0).double()
        m = m.clone()
        m[:, 0] |= n == 0
        sides.append((b, d, 0.5 * (d - b), m, torch.clamp(n, min=1)))
    (b1, d1, h1, m1, n1), (b2, d2, h2, m2, n2) = sides
    A1 = -(-int(n1.max()) // chunk) * chunk
    A2 = -(-int(n2.max()) // chunk) * chunk
    b1, d1, h1, m1 = (x[:, :A1] for x in (b1, d1, h1, m1))
    b2, d2, h2, m2 = (x[:, :A2] for x in (b2, d2, h2, m2))
    if A1 > K1:
        b1, d1, h1, m1 = (torch.nn.functional.pad(x, (0, A1 - K1)) for x in (b1, d1, h1, m1))
    if A2 > K2:
        b2, d2, h2, m2 = (torch.nn.functional.pad(x, (0, A2 - K2)) for x in (b2, d2, h2, m2))
    N = b1.shape[0]
    dul = _nanmax((b1[:, :, None] - b2[:, None, :]).abs(), (d1[:, :, None] - d2[:, None, :]).abs())
    vv = m1[:, :, None] & m2[:, None, :]
    zero = torch.zeros((), dtype=torch.float64)
    blocker = torch.where(vv, dul, zero).amax(dim=(1, 2))
    h1max = torch.where(m1, h1, -torch.inf).amax(dim=1)
    h1max = torch.where(n1 < K1, _nanmax(h1max, zero), h1max)
    blocker2 = _nanmax(blocker, h1max)
    real = lambda x: x < 1e8   # noqa: E731
    top = torch.stack([torch.where(vv & real(dul), dul, zero).amax(dim=(1, 2)),
                       torch.where(m1 & real(h1), h1, zero).amax(dim=1),
                       torch.where(m2 & real(h2), h2, zero).amax(dim=1)]).amax(0)
    scale = torch.clamp(top.float(), min=1e-9)
    big_m = (1e3 * scale).double()
    eye1 = torch.arange(A1)[:, None] == torch.arange(A1)[None, :]
    eye2 = torch.arange(A2)[:, None] == torch.arange(A2)[None, :]
    tr = torch.where(eye1, h1[:, :, None], blocker[:, None, None])
    bl = torch.where(eye2, h2[:, None, :], blocker2[:, None, None])
    D = torch.cat([torch.cat([dul, tr], 2),
                   torch.cat([bl, torch.zeros(N, A2, A1, dtype=torch.float64)], 2)], 1)
    rows = torch.cat([m1, m2], 1)
    cols = torch.cat([m2, m1], 1)
    valid = rows[:, :, None] & cols[:, None, :]
    Dm = torch.where(real(D), D, big_m[:, None, None])

    def lse(x):                          # (N, rows, entries) → (N, rows)
        m = torch.full(x.shape[:2], -torch.inf, dtype=torch.float64)
        s = torch.zeros(x.shape[:2], dtype=torch.float64)
        for e0 in range(0, x.shape[2], chunk):
            xc = x[:, :, e0:e0 + chunk]
            cm = xc.amax(-1)
            up = cm > m
            s = torch.where(up, s * torch.exp((m - cm).float()).double(), s)
            m = torch.where(up, cm, m)
            cs = torch.zeros(x.shape[:2], dtype=torch.float32)
            for q in range(chunk):
                cs = cs + torch.exp((xc[:, :, q] - m).float())
            s = s + cs.double()
        return m + torch.log(s)

    f = torch.zeros(N, A1 + A2, dtype=torch.float64)
    g = torch.zeros(N, A2 + A1, dtype=torch.float64)
    for eps_rel in tsl.eps_ladder():
        eps = (torch.tensor(eps_rel) * scale).double()[:, None]
        for _ in range(tsl.ITERS):
            x = torch.where(valid, (g[:, None, :] - Dm) / eps[:, :, None], -torch.inf)
            f = torch.where(rows, -eps * lse(x), 0.0)
            x = torch.where(valid, (f[:, :, None] - Dm) / eps[:, :, None], -torch.inf)
            g = torch.where(cols, -eps * lse(x.transpose(1, 2)), 0.0)
    inv_lo = 1.0 / (torch.tensor(tsl.EPS_LO, dtype=torch.float32) * scale).double()
    P = torch.exp(((f[:, :, None] + g[:, None, :] - D) * inv_lo[:, None, None]).float())
    keep = valid & real(D)
    return torch.where(keep, P.double() * D, zero).sum(dim=(1, 2))


@pytest.mark.parametrize("K", [40, 128])
def test_kernel_arithmetic_keeps_both_gates(K):
    """Premise of the kernel's arithmetic, before the card: its model stays
    within 2e-4 of the plain float32 version and within 1e-4 of a float64
    run of it (chip_smoke.py's phase 13 gates)."""
    args = _pairs(K, *CASES[K])
    got = _kernel_model(*(_t(x) for x in args)).numpy()
    plain, f64 = _plain(args), _plain(args, torch.float64)
    print(f"kernel model at K = {K}: max rel err vs plain {_worst(got, plain):.3e}, "
          f"vs float64 {_worst(got, f64):.3e}; plain vs float64 {_worst(plain, f64):.3e}")
    np.testing.assert_allclose(got, plain, rtol=2e-4)
    np.testing.assert_allclose(got, f64, rtol=1e-4)
    assert got[0] == 0.0


def test_ladder_is_sinkhorn_costs():
    """The launcher runs the ladder of `sinkhorn_cost`'s defaults, rounded
    to float32 as the plain version multiplies it into a float32 scale."""
    defaults = inspect.signature(tw.sinkhorn_cost).parameters
    assert (tsl.EPS_HI, tsl.EPS_LO, tsl.STEPS, tsl.ITERS) == tuple(
        defaults[k].default for k in ("eps_hi", "eps_lo", "steps", "iters"))
    assert tsl.HALF_STEPS == 480
    ladder = tsl.eps_ladder()
    assert ladder.dtype == np.float32 and ladder.shape == (6,)
    assert ladder[0] == np.float32(3e-2) and ladder[-1] == np.float32(1e-4)


def test_router_takes_plain_on_cpu_and_launcher_refuses_cpu():
    args = [_t(x) for x in _pairs(8, *CASES[8])]
    before = tsl.sinkhorn_log_cuda.launches
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tw, "SINKHORN_CHUNK", 5)
        got = tw.sinkhorn_cost_pairs(*args)
    np.testing.assert_array_equal(got.numpy(), tw.sinkhorn_cost(tw.build_cost_matrix(
        *args)).numpy())
    assert tw.sinkhorn_cost_pairs(*(x[:0] for x in args)).shape == (0,)
    with pytest.raises(ValueError):
        tsl.sinkhorn_log_cuda(*args)
    assert tsl.sinkhorn_log_cuda.launches == before


def _no_nvcc():
    raise RuntimeError("nvcc not found")


def test_router_never_falls_back_off_the_cpu(tmp_path):
    """A tensor that is not on the CPU goes to the launcher, which raises
    for anything but a CUDA tensor (the meta device: no card needed); and
    without nvcc the library does not load."""
    args = [torch.empty(4, 128, dtype=dt, device="meta")
            for dt in (torch.float32, torch.float32, torch.bool) * 2]
    with pytest.raises(ValueError, match="CUDA"):
        tw.sinkhorn_cost_pairs(*args)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsl, "_libs", {})
        mp.setattr(cuda_build, "_nvcc", _no_nvcc)
        mp.setattr(cuda_build, "BUILD_DIR", tmp_path)
        with pytest.raises(RuntimeError, match="nvcc"):
            tsl._load()


@pytest.mark.parametrize("K1,K2", [(128, 128), (1, 1), (64, 128)])
def test_kernel_plan_within_limits(K1, K2):
    plan = tsl.kernel_plan(1650, K1, K2)
    assert plan["grid"] == 1650 and plan["threads"] <= 1024
    assert plan["threads"] * plan["max_rows_per_thread"] >= K1 + K2
    assert plan["smem_bytes"] <= cuda_build.SMEM_LIMIT and plan["threads"] * 255 <= cuda_build.REGS_PER_SM
    for bad in ((0, 5), (5, 129)):
        with pytest.raises(ValueError):
            tsl.kernel_plan(1, *bad)


class _FakeLib:
    def __init__(self, report):
        self.report = report

    def sinkhorn_log_layout(self, out):
        arr = (ctypes.c_int * len(tsl.LAYOUT_FIELDS)).from_address(out)
        for i, k in enumerate(tsl.LAYOUT_FIELDS):
            arr[i] = self.report[k]
        return 0


def test_launcher_raises_when_the_library_disagrees_with_the_plan():
    plan = tsl.kernel_plan(1, 1, 1)
    good = dict(threads=plan["threads"], smem_bytes=plan["smem_bytes"], registers=90,
                local_bytes=0, occupancy=4)
    assert tsl.check_layout(_FakeLib(good)) == good
    for change in (dict(threads=256), dict(smem_bytes=4096), dict(registers=600),
                   dict(occupancy=0)):
        with pytest.raises(RuntimeError, match="disagree"):
            tsl.check_layout(_FakeLib(dict(good, **change)))


def _nan_birth_pairs():
    """K = 40 pairs whose side-1 bars have NaN births in every fourth pair:
    each of those bars costs 1e3 × the scale against everything, so the
    result hangs on exponents (g − Dm) / ε of ~1e7, where float32 keeps no
    fraction."""
    b1, d1, m1, b2, d2, m2 = _pairs(40, *CASES[40])
    b1[::4, :] = np.where(m1[::4], np.nan, b1[::4])
    return b1, d1, m1, b2, d2, m2


def test_nan_birth_pairs_reference_rounds_as_float32():
    """Which side JAX takes on NaN-birth pairs: its float32 `sinkhorn_cost`
    rounds as the port's plain float32 version does (within 1e-4), and both
    sit far (~10 %) from a float64 run there, which the kernel's model
    (float64 duals and exponents) follows within 1e-4.  So on such pairs
    the card test holds the kernel to the float64 run only."""
    args = _nan_birth_pairs()
    nanb = np.zeros(len(args[0]), bool)
    nanb[::4] = args[2][::4].any(1)
    want = np.asarray(jw.sinkhorn_cost(jw.build_cost_matrix(
        *(jnp.asarray(x) for x in args)))).astype(np.float64)
    plain, f64 = _plain(args), _plain(args, torch.float64)
    model = _kernel_model(*(_t(x) for x in args)).numpy()
    print(f"NaN-birth pairs: JAX vs plain {_worst(want, plain):.3e}, plain vs float64 "
          f"{_worst(plain[nanb], f64[nanb]):.3e} (other pairs "
          f"{_worst(plain[~nanb], f64[~nanb]):.3e}), model vs float64 "
          f"{_worst(model, f64):.3e}")
    for x in (want, plain, model):
        np.testing.assert_array_equal(np.isfinite(x), np.isfinite(f64))
    np.testing.assert_allclose(want, plain, rtol=1e-4)
    np.testing.assert_allclose(model, f64, rtol=1e-4)
    assert _worst(plain[nanb], f64[nanb]) > 1e-2
    np.testing.assert_allclose(plain[~nanb], f64[~nanb], rtol=1e-4)


def _card_cases():
    cases = {f"K{K}": _pairs(K, *CASES[K]) for K in sorted(CASES)}
    cases["nan_births"] = _nan_birth_pairs()
    return cases


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """On a CUDA card: one launch a call, no host synchronisation, NaN
    exactly where the plain version has NaN, within 1e-4 of a float64 run
    of the plain version, and within 2e-4 of the plain float32 version on
    every pair where that version is itself within 1e-4 of its float64 run.
    Where it is not (pairs of a few bars, NaN births: float32 rounding of
    the plain version, which JAX's shares), the float64 gate alone holds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda)")
    print(f"layout: {tsl.layout_report()}")
    for name, args in _card_cases().items():
        xs = [torch.as_tensor(x, device="cuda") for x in args]
        before = tsl.sinkhorn_log_cuda.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = tw.sinkhorn_cost_pairs(*xs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert tsl.sinkhorn_log_cuda.launches == before + 1
        ref = tw.sinkhorn_cost(tw.build_cost_matrix(*xs)).double().cpu().numpy()
        f64 = tw.sinkhorn_cost(tw.build_cost_matrix(
            *(x.double() if x.is_floating_point() else x for x in xs))).cpu().numpy()
        got = got.double().cpu().numpy()
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
        np.testing.assert_allclose(got, f64, rtol=1e-4, err_msg=name)
        fin = np.isfinite(ref)
        sound = fin & (np.abs(ref - f64) <= 1e-4 * np.abs(f64))
        print(f"kernel vs plain {name}: max rel err {_worst(got[sound], ref[sound]):.3e} "
              f"on {sound.sum()} of {fin.sum()} pairs (all: {_worst(got[fin], ref[fin]):.3e}), "
              f"vs float64 {_worst(got[fin], f64[fin]):.3e}; plain vs float64 "
              f"{_worst(ref[fin], f64[fin]):.3e}")
        np.testing.assert_allclose(got[sound], ref[sound], rtol=2e-4, err_msg=name)
