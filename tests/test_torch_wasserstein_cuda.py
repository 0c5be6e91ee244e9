"""The tiered H1 Sinkhorn kernel's host side on the CPU, and the premises of
its design: each pair may run at its own tier width, where the JAX package
and the plain version run a whole 128-pair chunk at the width of its
widest pair; and the kernel's float32 summation order (each thread's tile of
Kt, then shuffles that halve the values, then the warps in order) keeps
both of chip_smoke.py's gates, modelled lane by lane here.  The kernel
itself runs on the card only (the `cuda`-marked tests, chip_smoke.py's
phase 4b).

Tolerance: rtol 2e-4, as `test_torch_ops.py::test_tiered_sinkhorn_matches_jax`
— the ε ladder ends at ε = 1e-4 × the pair's cost scale, so one float32 ULP
in a dual potential moves <P, D> by up to ~1e-4 relative, and the width
changes the order of the matvec sums.  Each worst case is printed
(`pytest -rP`)."""
import ctypes
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ops import _study_diagrams
from tda_eeg_audio_tpu.models import programs as jprog
from tda_eeg_audio_tpu_torch.models import programs as tprog
from tda_eeg_audio_tpu_torch.ops import cuda_build
from tda_eeg_audio_tpu_torch.ops import wasserstein as tw
from tda_eeg_audio_tpu_torch.ops import wasserstein_cuda as twc

torch.set_num_threads(1)

N = 150          # two 128-pair chunks in the plain version, the second padded


def _counts(profile, rng):
    """Bar counts per side: `sparse` and `mixed` as in test_torch_ops.py; in
    `dense_in_sparse` one 70-bar pair sorts into the first chunk with 127
    sparse pairs, which the plain version then runs at width 80."""
    if profile == "mixed":
        c1 = np.concatenate([rng.integers(1, 15, N - 20), rng.integers(20, 38, 14),
                             rng.integers(60, 90, 4), [0, 0]])
        c2 = np.concatenate([rng.integers(1, 15, N - 20), rng.integers(20, 38, 14),
                             rng.integers(60, 90, 4), [3, 0]])
        return c1, c2
    c1, c2 = rng.integers(0, 16, N), rng.integers(0, 16, N)
    if profile == "dense_in_sparse":
        c1[5] = 70
    return c1, c2


def _pairs(profile, seed=2):
    rng = np.random.default_rng(seed)
    c1, c2 = _counts(profile, rng)
    return (*_study_diagrams(rng, c1), *_study_diagrams(rng, c2))


def _per_pair_plain(b1, d1, m1, b2, d2, m2):
    """The plain cost matrix and Sinkhorn at each pair's own class width
    (`pair_width` of its larger side's bar count): what the kernel does."""
    b1, d1, m1 = tprog._compact_rows(b1, d1, m1)
    b2, d2, m2 = tprog._compact_rows(b2, d2, m2)
    widths = np.array([twc.pair_width(int(c))
                       for c in torch.maximum(m1.sum(1), m2.sum(1))])
    out = torch.empty(b1.shape[0])
    for w in np.unique(widths):
        idx = torch.as_tensor(np.flatnonzero(widths == w))
        out[idx] = tw.sinkhorn_cost_stab(tw.build_cost_matrix(
            *(x[idx, :w] for x in (b1, d1, m1, b2, d2, m2))))
    return out.numpy(), widths


def _worst(got, ref):
    nz = ref != 0
    return float(np.max(np.abs(got - ref)[nz] / np.abs(ref[nz])))


@pytest.mark.parametrize("profile", ["sparse", "mixed", "dense_in_sparse"])
def test_per_pair_width_matches_jax_chunk_tiers(profile):
    """The width premise: at its own tier width each pair's cost equals the
    JAX package's, whose chunks run at their widest pair's tier."""
    args = _pairs(profile)
    w_j = np.asarray(jprog._wass_sinkhorn_tiered(*(jnp.asarray(x) for x in args)))
    t_args = [torch.as_tensor(x) for x in args]
    w_p, widths = _per_pair_plain(*t_args)
    w_c = tprog.wass_sinkhorn_tiered_plain(*t_args).numpy()
    # the width alone (same framework) moves less than the framework does
    print(f"per-pair widths {profile}: "
          f"{ {int(w): int(n) for w, n in zip(*np.unique(widths, return_counts=True))} }"
          f", max rel err vs JAX {_worst(w_p, w_j):.3e}, vs the port's chunk "
          f"tiers {_worst(w_p, w_c):.3e}")
    np.testing.assert_allclose(w_p, w_j, rtol=2e-4)
    np.testing.assert_allclose(w_p, w_c, rtol=2e-4)
    if profile == "dense_in_sparse":
        # the premise is exercised: sparse pairs that the chunked versions
        # run at width 80 beside the 70-bar pair run at 16 here
        assert (widths == 16).sum() == N - 1 and (widths == 80).sum() == 1


@pytest.mark.parametrize("n_sms", [114, 132, 144])
def test_kernel_plan_within_limits(n_sms):
    """The plan at the comparison's pad width on cards of 114 (H100 PCIe),
    132 (H100 SXM) and 144 SMs: the H100's limits, a persistent grid."""
    plan = twc.kernel_plan(96, n_sms)
    assert [c["width"] for c in plan] == list(tw.W_TIERS) + [96]
    assert [c["S"] for c in plan] == [32, 80, 160, 192]
    for c in plan:
        assert c["smem_bytes"] <= 232_448 and c["threads"] <= 1024
        assert c["blocks_per_sm"] * (c["smem_bytes"] + 1024) <= 233_472
        # whole warps; a pair's group holds its S columns' sums (a thread
        # each) unless it is one warp
        assert c["threads"] % 32 == 0
        assert c["warps_per_pair"] == 1 or 32 * c["warps_per_pair"] >= c["S"]
        # a persistent grid, whatever the number of pairs
        assert c["grid"] == c["blocks_per_sm"] * n_sms
    # the narrow class: one warp a pair, several pairs a block, no block barrier
    assert plan[0]["warps_per_pair"] == 1 and plan[0]["pairs_per_block"] > 1
    assert plan[2]["grid"] == n_sms            # one S = 160 pair an SM
    # one bucketing launch, then one a class
    assert twc.launches_per_call(96) == 5 and twc.launches_per_call(12) == 2
    # a narrower pad needs only the classes that hold it
    assert [c["width"] for c in twc.kernel_plan(40, n_sms)] == [16, 40]
    assert [c["width"] for c in twc.kernel_plan(12, n_sms)] == [16]
    for bad in (0, 97):
        with pytest.raises(ValueError):
            twc.kernel_plan(bad, n_sms)


def test_width_class_rule_follows_the_tiers():
    """A pair's class is the smallest tier that holds its larger side, else
    the full 96: the tier `_wass_chunk_tiered` picks for a chunk of that
    pair alone."""
    for count in range(0, 97):
        tier = next((w for w in tw.W_TIERS if count <= w), 96)
        assert twc.pair_width(count) == tier
    with pytest.raises(ValueError):
        twc.pair_width(97)


def _tile_cells(c):
    """(thread, row, col) of every Kt entry each thread of a pair's group
    holds, by the kernel's rule: lane l of warp w holds rows (w·A + l //
    lanes)·rows + [0, rows), columns (l % lanes)·cols + [0, cols)."""
    A = c["tile_rows_per_warp"]
    for t in range(32 * c["warps_per_pair"]):
        w, lane = divmod(t, 32)
        r0 = (w * A + lane // c["lanes"]) * c["rows"]
        c0 = (lane % c["lanes"]) * c["cols"]
        for k in range(c["rows"]):
            for m in range(c["cols"]):
                yield t, r0 + k, c0 + m


@pytest.mark.parametrize("width", twc.WIDTHS)
def test_class_shape_fits_the_card_and_tiles_kt(width):
    """Each class's block within the H100's limits: the tiles cover S × S
    exactly once; Kt's tile, its row and column sums and the shuffled u's fit
    the register cap that `__launch_bounds__(threads, blocks_per_sm)` leaves,
    with room to spare; the blocks an SM fit its registers, threads, blocks
    and shared memory; the shared bytes are the source's parts."""
    c = twc.class_shape(width)
    S, R, C, B, WP = c["S"], c["rows"], c["cols"], c["lanes"], c["warps_per_pair"]
    assert S == 2 * width and B * C == S and WP * (32 // B) * R == S
    cells = np.array(list(_tile_cells(c)))
    assert len(cells) == S * S
    assert len({(r, m) for _, r, m in cells}) == S * S
    assert np.bincount(cells[:, 0]).tolist() == [R * C] * (32 * WP)
    # halving row sums: R and B powers of two, R ≤ B
    assert R & (R - 1) == 0 and B & (B - 1) == 0 and R <= B
    assert R * C + 2 * R + C + 32 <= c["reg_cap"] <= 255
    assert c["blocks_per_sm"] * c["threads"] * c["reg_cap"] <= 65_536
    assert c["blocks_per_sm"] * c["threads"] <= 2048 and c["blocks_per_sm"] <= 32
    assert c["blocks_per_sm"] * (c["smem_bytes"] + 1024) <= 233_472
    assert c["dm_bytes"] in (4, 8)
    group = 8 * 2 * S + c["dm_bytes"] * S * S + 4 * 4 * width
    if WP > 1:
        group += 4 * S + 4 * WP * S + 16 * WP + 16
    assert c["smem_bytes"] == c["pairs_per_block"] * group and group % 16 == 0


class _FakeLib:
    """A library that reports `report` for every width."""

    def __init__(self, report):
        self.report = report

    def sinkhorn_tiered_layout(self, width, out):
        rep = self.report(width)
        arr = (ctypes.c_int * len(twc.LAYOUT_FIELDS)).from_address(out)
        for i, k in enumerate(twc.LAYOUT_FIELDS):
            arr[i] = rep[k]
        return 0


def test_launcher_raises_when_the_library_disagrees_with_the_plan():
    """`check_layout` (run by the launcher once per process) accepts a
    library that reports the plan's threads, shared bytes and blocks an SM
    with room for them, and raises on any field that disagrees: no
    fallback to another layout."""
    def report(width, change=None):
        c = twc.class_shape(width)
        rep = dict(threads=c["threads"], smem_bytes=c["smem_bytes"],
                   blocks_per_sm=c["blocks_per_sm"], registers=c["reg_cap"],
                   local_bytes=0, occupancy=c["blocks_per_sm"])
        rep.update((change or {}).get(width, {}))
        return rep

    got = twc.check_layout(_FakeLib(report))
    assert sorted(got) == list(twc.WIDTHS)
    for change in ({80: dict(threads=160)}, {40: dict(smem_bytes=0)},
                   {16: dict(blocks_per_sm=4)}, {96: dict(occupancy=0)},
                   {80: dict(registers=256)}):
        with pytest.raises(RuntimeError, match="disagree"):
            twc.check_layout(_FakeLib(lambda w, c=change: report(w, c)))


def _fma(a, b, c):
    """float32 fma(a, b, c): the product exactly in float64, one rounding of
    the sum (to float64, then float32: a second rounding only in ties)."""
    return (a.double() * b.double() + c.double()).float()


def _halving_sum(v, off, lo):
    """`halving_sum` of the kernel on (..., 32 lanes, N) values: per lane
    bit OFF, OFF / 2, ..., LO, while N is even the lane with the bit set
    keeps the upper half and adds its partner's, else a butterfly step.
    Returns the values and each lane's `base`."""
    lane = torch.arange(32)
    base = torch.zeros(32, dtype=torch.long)
    while off >= lo:
        n, partner = v.shape[-1], lane ^ off
        if n % 2 == 0:
            up = ((lane & off) != 0)[:, None]
            keep = torch.where(up, v[..., n // 2:], v[..., :n // 2])
            send = torch.where(up, v[..., :n // 2], v[..., n // 2:])
            v = keep + send[..., partner, :]
            base = base + up[:, 0] * (n // 2)
        else:
            v = v + v[..., partner, :]
        off //= 2
    return v, base


def _kernel_order_cost(D, c):
    """The kernel's ladder on cost matrices D (P, S, S) at class shape c, lane
    by lane: Kt in each thread's R × C tile, row sums over its columns in
    order then `halving_sum` over the tile row's lanes (KR rows left a
    lane), u of row k back by shuffle from lane (l & ~(B - 1)) + k // KR ·
    (B·KR / R); column sums over its rows in order,
    `halving_sum` over the warp's tile rows, then the warps' partial sums in
    warp order (one warp: v back by shuffle from lane l·B + l % B); float32
    Kt, u, v and expf, float64 duals, exponent and final sum."""
    Pn, S = D.shape[:2]
    R, C, B, WP = c["rows"], c["cols"], c["lanes"], c["warps_per_pair"]
    A = 32 // B
    lane = torch.arange(32)
    rows = ((torch.arange(WP)[:, None] * A + lane // B) * R)[..., None] + torch.arange(R)
    cols = ((lane % B) * C)[:, None] + torch.arange(C)                 # (32, C)
    rows_b = rows[:, :, :, None].expand(WP, 32, R, C)
    cols_b = cols[None, :, None, :].expand(WP, 32, R, C)
    real = D < 1e8
    scale = torch.clamp(torch.where(real, D, 0.0).amax(dim=(1, 2)), min=1e-9)
    off = (torch.tensor(1e3, dtype=torch.float32) * scale)
    Dm = torch.where(real, D, off[:, None, None])
    tile_dm = Dm[:, rows_b, cols_b]                                     # (P, WP, 32, R, C)
    f = torch.zeros(Pn, S, dtype=torch.float64)
    g = torch.zeros(Pn, S, dtype=torch.float64)
    for s_ in range(tw.STEPS):
        eps = twc.eps_ladder()[s_] * scale                              # float32
        inv_eps = 1.0 / eps.double()
        done = 0
        while done < tw.ITERS:
            blk = min(tw.ABSORB, tw.ITERS - done)
            done += blk
            x = (f[:, rows_b] + g[:, cols_b]) - tile_dm.double()
            K = torch.exp((x * inv_eps[:, None, None, None, None]).float())
            v = torch.ones(Pn, S)
            for _ in range(blk):
                vt = v[:, cols][:, None].expand(Pn, WP, 32, C)
                acc = torch.zeros(Pn, WP, 32, R)
                for m in range(C):
                    acc = _fma(K[..., m], vt[..., m, None], acc)
                acc, kr = _halving_sum(acc, B // 2, 1)                  # KR rows a lane
                KR = acc.shape[-1]
                u_own = 1.0 / torch.clamp(acc, min=1e-38)               # (P, WP, 32, KR)
                src = (lane & ~(B - 1))[:, None] + torch.arange(R) // KR * (B * KR // R)
                u = u_own[:, :, src, torch.arange(R) % KR]              # (P, WP, 32, R)
                cs = torch.zeros(Pn, WP, 32, C)
                for k in range(R):
                    cs = _fma(K[..., k, :], u[..., k, None], cs)
                kc = torch.zeros(32, dtype=torch.long)
                if A > 1:
                    cs, kc = _halving_sum(cs, 16, B)
                keep = cs.shape[-1]
                colsum = torch.zeros(Pn, WP, S)
                idx = ((lane % B) * C + kc)[:, None] + torch.arange(keep)
                colsum[:, :, idx.reshape(-1)] = cs.reshape(Pn, WP, 32 * keep)
                tot = colsum[:, 0]
                for w in range(1, WP):
                    tot = tot + colsum[:, w]
                v = 1.0 / torch.clamp(tot, min=1e-38)
            held = kr[:, None] + torch.arange(KR)                       # (32, KR)
            row_of = rows.gather(2, held.expand(WP, 32, KR)).reshape(-1)
            f[:, row_of] += eps.double()[:, None] * torch.log(u_own.reshape(Pn, -1).double())
            g += eps.double()[:, None] * torch.log(v.double())
    inv_lo = 1.0 / (torch.tensor(tw.EPS_LO, dtype=torch.float32) * scale).double()
    x = (f[:, rows_b] + g[:, cols_b]) - tile_dm.double()
    P = torch.exp((x * inv_lo[:, None, None, None, None]).float())
    dm = tile_dm
    return (P.double() * torch.where(dm < off[:, None, None, None, None], dm, 0.0).double()
            ).sum(dim=(1, 2, 3, 4))


@pytest.mark.parametrize("width", twc.WIDTHS)
def test_kernel_summation_order_keeps_both_gates(width):
    """Premise of the register-tile design, before the card: on the card
    cases' pairs of this width class, the kernel's float32 order (modelled
    lane by lane, `_kernel_order_cost`) with float64 duals stays within
    1e-6 of a float64 run of the ladder (chip_smoke.py's SINKHORN_F64_RTOL)
    and within 2e-4 of `wass_sinkhorn_tiered_plain` (SINKHORN_RTOL)."""
    c = twc.class_shape(width)
    worst64 = worst = 0.0
    n = 0
    for args in _card_cases().values():
        t = [torch.as_tensor(x) for x in args]
        b1, d1, m1 = tprog._compact_rows(*t[:3])
        b2, d2, m2 = tprog._compact_rows(*t[3:])
        counts = torch.maximum(m1.sum(1), m2.sum(1))
        idx = torch.as_tensor([i for i, k in enumerate(counts) if twc.pair_width(int(k)) == width],
                              dtype=torch.long)
        if not len(idx):
            continue
        n += len(idx)
        sub = [x[idx, :width] for x in (b1, d1, m1, b2, d2, m2)]
        D = tw.build_cost_matrix(*sub)
        got = _kernel_order_cost(D, c).numpy()
        f64 = tw.sinkhorn_cost_stab(tw.build_cost_matrix(
            sub[0].double(), sub[1].double(), sub[2], sub[3].double(), sub[4].double(),
            sub[5])).numpy()
        plain = tprog.wass_sinkhorn_tiered_plain(*(x[idx] for x in t)).numpy()
        worst64 = max(worst64, _worst(got, f64))
        worst = max(worst, _worst(got, plain))
        np.testing.assert_allclose(got, f64, rtol=1e-6)
        np.testing.assert_allclose(got, plain, rtol=2e-4)
    print(f"kernel order at width {width} ({n} pairs): max rel err vs float64 "
          f"{worst64:.3e}, vs plain {worst:.3e}")
    assert n > 0


def test_eps_ladder_is_the_plain_versions():
    """The launcher runs the ladder of `sinkhorn_cost_stab`'s defaults."""
    defaults = inspect.signature(tw.sinkhorn_cost_stab).parameters
    assert (tw.EPS_HI, tw.EPS_LO, tw.STEPS, tw.ITERS, tw.ABSORB) == tuple(
        defaults[k].default for k in ("eps_hi", "eps_lo", "steps", "iters", "absorb"))
    ladder = twc.eps_ladder()
    assert ladder.dtype == np.float32 and ladder.shape == (6,)
    assert ladder[0] == np.float32(3e-2) and ladder[-1] == np.float32(1e-4)
    assert np.all(np.diff(ladder) < 0)


def test_router_takes_plain_on_cpu_and_launcher_refuses_cpu():
    args = [torch.as_tensor(x[:20]) for x in _pairs("mixed")]
    before = twc.sinkhorn_tiered_cuda.launches
    got = tprog._wass_sinkhorn_tiered(*args)
    assert twc.sinkhorn_tiered_cuda.launches == before
    np.testing.assert_array_equal(got.numpy(),
                                  tprog.wass_sinkhorn_tiered_plain(*args).numpy())
    with pytest.raises(ValueError):
        twc.sinkhorn_tiered_cuda(*args)
    assert twc.sinkhorn_tiered_cuda.launches == before


def _card_cases():
    """The profiles above, an all-empty pair (the [[0, 0]] sentinel on both
    sides) and a 90-vs-90-bar pair (the full width, S = 192)."""
    cases = {p: _pairs(p) for p in ("sparse", "mixed", "dense_in_sparse")}
    rng = np.random.default_rng(7)
    b1, d1, m1 = _study_diagrams(rng, [0, 90, 3])
    b2, d2, m2 = _study_diagrams(rng, [0, 90, 0])
    cases["empty_and_full"] = (b1, d1, m1, b2, d2, m2)
    return cases


@pytest.mark.cuda
def test_library_reports_the_plan_on_card():
    """On a CUDA card: both builds of the library report every width class's
    threads, shared bytes and blocks an SM as `class_shape` reckons them,
    the card's occupancy calculator holds that many blocks an SM, and the
    registers keep within the plan's cap (`check_layout`, which the
    launcher runs once per process)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda)")
    for flags in ((), twc.PROFILE_FLAGS):
        reports = twc.check_layout(cuda_build.load(twc.SRC, twc.SIGNATURES, flags))
        print(f"layout ({flags or 'main build'}): {reports}")
        for w, rep in reports.items():
            plan = twc.class_shape(w)
            assert (rep["threads"], rep["smem_bytes"], rep["blocks_per_sm"]) == \
                (plan["threads"], plan["smem_bytes"], plan["blocks_per_sm"])
            assert rep["occupancy"] >= plan["blocks_per_sm"]


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda)")
    for name, args in _card_cases().items():
        xs = [torch.as_tensor(x, device="cuda") for x in args]
        before = twc.sinkhorn_tiered_cuda.launches
        got = tprog._wass_sinkhorn_tiered(*xs)
        assert twc.sinkhorn_tiered_cuda.launches == before + 5   # bucketing + 4 classes
        ref = tprog.wass_sinkhorn_tiered_plain(*xs)
        torch.cuda.synchronize()
        got, ref = got.cpu().numpy(), ref.cpu().numpy()
        print(f"kernel vs plain {name}: max rel err {_worst(got, ref):.3e}")
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, rtol=2e-4)
