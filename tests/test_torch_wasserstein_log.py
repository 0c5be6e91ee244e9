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
from tda_eeg_audio_tpu_torch.models.homology_exec import run_tda
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


M0 = -1e300                  # a lane's running max before its first entry


def _exp32(x):
    """expf of the exponent rounded to float32, back in float64."""
    return torch.exp(x.float()).double()


def _lse_lanes(x, L, chunk=tsl.CHUNK):
    """(N, R, E) float64 exponents (-inf: no entry) → (N, R), each line's
    logsumexp as the kernel takes it at L lanes: lane l walks entries l, l +
    L, l + 2L, … online in chunks (the chunk's max rescales the float64 sum
    by expf when it exceeds the running max, the chunk's expf terms summed in
    float32 in order), then the lanes' (max, sum) merged by xor 1, 2, 4 in
    that order: m = max, s = s_a e^(m_a − m) + s_b e^(m_b − m)."""
    N, R, E = x.shape
    per = -(-E // (L * chunk)) * chunk
    x = torch.nn.functional.pad(x, (0, per * L - E), value=-torch.inf).view(N, R, per, L)
    m = torch.full((N, R, L), M0, dtype=torch.float64)
    s = torch.zeros((N, R, L), dtype=torch.float64)
    for k0 in range(0, per, chunk):
        xc = x[:, :, k0:k0 + chunk]
        cm = xc.amax(2)
        up = cm > m
        s = torch.where(up, s * _exp32(m - cm), s)
        m = torch.where(up, cm, m)
        cs = torch.zeros((N, R, L), dtype=torch.float32)
        for q in range(chunk):
            cs = cs + torch.exp((xc[:, :, q] - m).float())
        s = s + cs.double()
    lane, o = torch.arange(L), 1
    while o < L:
        mo, so = m[..., lane ^ o], s[..., lane ^ o]
        mm = torch.maximum(m, mo)
        s = s * _exp32(m - mm) + so * _exp32(mo - mm)
        m, o = mm, 2 * o
    return m[..., 0] + torch.log(s[..., 0])


def _kernel_model(b1, d1, m1, b2, d2, m2):
    """torch model of csrc/sinkhorn_log.cu: the bars compacted to the front as
    float64 (the [[0, 0]] sentinel for an empty side), each pair's cost
    matrix at its own width S = n1 + n2 in the kernel's layout (rows [side-1
    bars | side-2 helpers], columns [side-2 bars | side-1 slots]), the duals
    float64 in units of the rung's ε (rescaled when the rung changes), and
    each half-step's logsumexp split over the pair's `tsl.lanes(S)` lanes
    (`_lse_lanes`)."""
    K1 = b1.shape[1]
    sides = []
    for b, d, m in ((b1, d1, m1), (b2, d2, m2)):
        b, d, m = tprog._compact_rows(b, d, m)
        b, d = torch.where(m, b, 0.0).double(), torch.where(m, d, 0.0).double()
        sides.append((b, d, 0.5 * (d - b), torch.clamp(m.sum(1), min=1)))
    (b1, d1, h1, n1), (b2, d2, h2, n2) = sides
    v1 = torch.arange(b1.shape[1])[None] < n1[:, None]
    v2 = torch.arange(b2.shape[1])[None] < n2[:, None]
    dul = _nanmax((b1[:, :, None] - b2[:, None, :]).abs(), (d1[:, :, None] - d2[:, None, :]).abs())
    vv = v1[:, :, None] & v2[:, None, :]
    zero = torch.zeros((), dtype=torch.float64)
    blocker = torch.where(vv, dul, zero).amax(dim=(1, 2))
    h1max = torch.where(v1, h1, -torch.inf).amax(dim=1)
    h1max = torch.where(n1 < K1, _nanmax(h1max, zero), h1max)
    blocker2 = _nanmax(blocker, h1max)
    real = lambda x: x < 1e8   # noqa: E731
    top = torch.stack([torch.where(vv & real(dul), dul, zero).amax(dim=(1, 2)),
                       torch.where(v1 & real(h1), h1, zero).amax(dim=1),
                       torch.where(v2 & real(h2), h2, zero).amax(dim=1)]).amax(0)
    scale = torch.clamp(top.float(), min=1e-9)
    big_m = (1e3 * scale).double()
    N, S = b1.shape[0], n1 + n2
    W = int(S.max())
    D = torch.zeros(N, W, W, dtype=torch.float64)
    valid = torch.zeros(N, W, W, dtype=torch.bool)
    helper_slot = torch.zeros(N, W, W, dtype=torch.bool)
    for p in range(N):
        a, c, w = int(n1[p]), int(n2[p]), int(S[p])
        tr = torch.where(torch.eye(a, dtype=torch.bool), h1[p, :a, None].expand(a, a), blocker[p])
        bl = torch.where(torch.eye(c, dtype=torch.bool), h2[p, None, :c].expand(c, c),
                         blocker2[p])
        D[p, :w, :w] = torch.cat([torch.cat([dul[p, :a, :c], tr], 1),
                                  torch.cat([bl, torch.zeros(c, a, dtype=torch.float64)], 1)], 0)
        valid[p, :w, :w] = True
        helper_slot[p, a:w, c:w] = True
    Dm = torch.where(real(D), D, big_m[:, None, None])
    lines = torch.arange(W)[None] < S[:, None]
    by_lanes = {}
    for p, w in enumerate(S.tolist()):
        by_lanes.setdefault(tsl.lanes(w), []).append(p)

    def lse(x):                          # (N, lines, entries) → (N, lines)
        out = torch.empty(x.shape[:2], dtype=torch.float64)
        for L, idx in by_lanes.items():
            out[idx] = _lse_lanes(x[idx], L)
        return out

    F = torch.zeros(N, W, dtype=torch.float64)
    G = torch.zeros(N, W, dtype=torch.float64)
    eps_prev = None
    for eps_rel in tsl.eps_ladder():
        eps = (torch.tensor(eps_rel) * scale).double()
        inv = (1.0 / eps)[:, None, None]
        if eps_prev is not None:
            r = (eps_prev * (1.0 / eps))[:, None]
            F, G = F * r, G * r
        for _ in range(tsl.ITERS):
            F = torch.where(lines, -lse(torch.where(valid, G[:, None, :] - Dm * inv, -torch.inf)),
                            0.0)
            G = torch.where(lines, -lse(torch.where(valid, F[:, :, None] - Dm * inv,
                                                    -torch.inf).transpose(1, 2)), 0.0)
        eps_prev = eps
    inv_lo = 1.0 / (torch.tensor(tsl.EPS_LO, dtype=torch.float32) * scale).double()
    r = (eps_prev * inv_lo)[:, None, None]
    P = _exp32((F[:, :, None] + G[:, None, :]) * r - Dm * inv_lo[:, None, None])
    keep = valid & real(D) & ~helper_slot
    return torch.where(keep, P * Dm, zero).sum(dim=(1, 2))


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
        mp.setattr(cuda_build, "_libs", {})
        mp.setattr(cuda_build, "_nvcc", _no_nvcc)
        mp.setattr(cuda_build, "BUILD_DIR", tmp_path)
        with pytest.raises(RuntimeError, match="nvcc"):
            cuda_build.load(tsl.SRC, tsl.SIGNATURES)


@pytest.mark.parametrize("K1,K2", [(128, 128), (1, 1), (64, 128)])
def test_kernel_plan_within_limits(K1, K2):
    plan = tsl.kernel_plan(1650, K1, K2)
    assert plan["grid"] == 1650 and plan["threads"] <= 1024
    assert plan["threads"] * plan["max_rows_per_thread"] >= K1 + K2
    assert plan["smem_bytes"] <= cuda_build.SMEM_LIMIT and plan["threads"] * 255 <= cuda_build.REGS_PER_SM
    for bad in ((0, 5), (5, 129)):
        with pytest.raises(ValueError):
            tsl.kernel_plan(1, *bad)


# own widths S = n1 + n2 at the lanes' boundaries, and the lanes a line there
LANE_CASES = {2: 8, 32: 8, 33: 4, 64: 4, 65: 2, 128: 2, 129: 1, 256: 1}


def _lane_of(lane, L, apart):
    """csrc's lane_of within a warp: (line, l) of a lane, the L lanes of a
    line side by side or 32 / L apart."""
    per = 32 // L
    return (lane % per, lane // per) if apart else (lane // L, lane % L)


@pytest.mark.parametrize("S", sorted(LANE_CASES))
def test_kernel_plan_lanes_at_boundaries(S):
    """The lanes a line at each boundary of S (the largest power of two with
    S × L ≤ THREADS, at most 8), the entries a lane walks, and the table's
    row stride: for every n2 at that L, each half-warp's 16 addresses of a
    64-bit table load differ mod 16 doubles in the row pass (lines read
    along a table row) and in the column pass (along a column), with the
    lanes placed as the kernel places them."""
    L = tsl.lanes(S)
    assert L == LANE_CASES[S]
    assert S * L <= tsl.THREADS and (L == 8 or 2 * L * S > tsl.THREADS)
    K1 = S // 2
    plan = tsl.kernel_plan(7, K1, S - K1)
    assert plan["max_entries_per_lane"] == -(-S // L) and plan["threads"] == tsl.THREADS
    assert tsl.lanes(S) == next(l for top, l in plan["lane_bounds"] if S <= top)
    for n2 in range(1, min(S, tsl.MAX_K) + 1):
        P = tsl.table_pitch(n2, L)
        assert n2 <= P < n2 + 8
        for row, apart in ((True, L == 8), (False, L in (2, 8))):
            for half in (range(16), range(16, 32)):
                addr = set()
                for lane in half:
                    g, l = _lane_of(lane, L, apart)
                    addr.add((g * P + l if row else l * P + g) % 16)
                assert len(addr) == 16, (S, n2, P, row)


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
    for change in (dict(threads=128), dict(smem_bytes=4096), dict(registers=600),
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


def _nan_window_dms(n=24, seed=21):
    """(30, n, n) distance matrices of the pipeline's NaN cases and of
    generic windows: Pearson distances of EEG-like windows (10 plain, 5 with
    one NaN channel, 5 all NaN), and the Takens clouds of a short envelope's
    10 windows, the last 4 of which run past its end into the NaN fill of
    `sliding_windows` (the reference's fill-mode gather)."""
    from tda_eeg_audio_tpu_torch.ops import geometry, signal

    rng = np.random.default_rng(seed)
    w = torch.as_tensor(rng.standard_normal((20, n, 50)).astype(np.float32))
    w[10:15, 3] = torch.nan
    w[15:20] = torch.nan
    eeg = geometry.correlation_to_distance(geometry.correlation_matrix(w))
    env = torch.as_tensor(rng.standard_normal((1, 160)).astype(np.float32))
    wins = signal.sliding_windows(env, 10, 50, 12)[0]          # 6..9 past 160
    pts, pmask = signal.takens_embed(wins, torch.full((10,), 2), 3, 2, n)
    dm = geometry.pairwise_distances(signal.minmax_normalize_points(pts, pmask),
                                     pmask, pad_value=3.0)
    return torch.cat([eeg, dm]).contiguous()


@pytest.mark.parametrize("route", ["device", "redo", "host"])
def test_no_visible_nan_birth_reaches_wass_chunks(route):
    """Can the pipeline hand `_wass_chunks` a NaN birth?  The diagrams of
    NaN windows and of a short envelope's NaN-filled windows, by the device
    route (`run_tda` → the plain diagrams, as CPU tensors take them), with
    the overflowed windows redone on the host engine, and by the host
    engine alone, then `StudyRunner._h1_padded`: no slot with m True has a
    non-finite birth or death (a visible bar needs death > birth, false for
    NaN), and every masked slot reaches it as (0, 0).  On the device route
    an all-NaN window leaves NaN births in its masked slots (the creator
    list is empty and its slots gather the window's first, NaN weight)."""
    dms = _nan_window_dms()
    kw = dict(device={}, redo=dict(na_max=2), host=dict(backend="host"))[route]
    out = run_tda(dms, 2.0, **kw)
    if route == "redo":
        assert out["redone"].any() and not out["redone"].all()
    raw_b, raw_d, raw_m = out["births"], out["deaths"], out["mask"]
    assert torch.isfinite(raw_b[raw_m]).all()
    assert torch.isnan(raw_b[~raw_m]).any() == (route != "host")
    b, d, m = tstudy.StudyRunner._h1_padded(out)
    assert b.shape == (30, tstudy.K_H1) and m.any() and not m.all()
    assert torch.isfinite(b[m]).all() and torch.isfinite(d[m]).all()
    assert (d[m] > b[m]).all()
    assert (b[~m] == 0).all() and (d[~m] == 0).all()


def test_masked_nan_births_are_inert():
    """NaN births in masked slots leave the plain version and the kernel's
    model exactly where they are with those births set to 0: the cost
    matrix selects a masked slot's values away, and the kernel (as its
    model) reads the bars of valid slots only."""
    b1, d1, m1, b2, d2, m2 = _pairs(40, *CASES[40])
    zero = (np.where(m1, b1, 0.0), d1, m1, np.where(m2, b2, 0.0), d2, m2)
    nan = (np.where(m1, b1, np.nan), d1, m1, np.where(m2, b2, np.nan), d2, m2)
    assert np.isnan(nan[0]).any() and np.isnan(nan[3]).any()
    assert torch.equal(tw.build_cost_matrix(*map(_t, nan)),
                       tw.build_cost_matrix(*map(_t, zero)))
    np.testing.assert_array_equal(_plain(nan), _plain(zero))
    np.testing.assert_array_equal(_plain(nan, torch.float64), _plain(zero, torch.float64))
    np.testing.assert_array_equal(_kernel_model(*map(_t, nan)).numpy(),
                                  _kernel_model(*map(_t, zero)).numpy())


def _card_cases():
    cases = {f"K{K}": _pairs(K, *CASES[K]) for K in sorted(CASES)}
    cases["nan_births"] = _nan_birth_pairs()
    # a pair at each lanes' boundary of S (both sides at 1 bar or more)
    c1 = [max(S // 2, 1) for S in sorted(LANE_CASES)]
    cases["lane_bounds"] = _pairs(128, c1, [S - c for S, c in zip(sorted(LANE_CASES), c1)])
    return cases


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """On a CUDA card: one launch a call, no host synchronisation, NaN
    exactly where the plain version has NaN, within 1e-4 of a float64 run
    of the plain version, and within 2e-4 of the plain float32 version on
    every pair where that version is itself within 1e-4 of its float64 run.
    Where it is not (pairs of a few bars, NaN births: float32 rounding of
    the plain version, which JAX's shares), the float64 gate alone holds.
    `lane_bounds` puts a pair at each boundary of S, so every lane count
    (8, 4, 2, 1) and both cost routes (the table, the bars) run."""
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
