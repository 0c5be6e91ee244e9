"""The tiered H1 Sinkhorn kernel's host side on the CPU, and the premise of
its design: each pair may run at its own tier width, where the JAX package
and the plain version run a whole 128-pair chunk at the width of its
widest pair.  The kernel itself runs on the card only
(`test_kernel_matches_plain_on_card`, chip_smoke.py's Sinkhorn phase).

Tolerance: rtol 2e-4, as `test_torch_ops.py::test_tiered_sinkhorn_matches_jax`
— the ε ladder ends at ε = 1e-4 × the pair's cost scale, so one float32 ULP
in a dual potential moves <P, D> by up to ~1e-4 relative, and the width
changes the order of the matvec sums.  Each worst case is printed
(`pytest -rP`)."""
import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ops import _study_diagrams
from tda_eeg_audio_tpu.models import programs as jprog
from tda_eeg_audio_tpu_torch.models import programs as tprog
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


@pytest.mark.parametrize("n_pairs", [1, 2400, 20_000])
def test_kernel_plan_within_limits(n_pairs):
    plan = twc.kernel_plan(n_pairs, 96)
    assert [c["width"] for c in plan] == list(tw.W_TIERS) + [96]
    assert [c["S"] for c in plan] == [32, 80, 160, 192]
    for c in plan:
        assert c["smem_bytes"] <= 232_448
        assert c["threads"] % 32 == 0 and 0 <= c["threads"] - c["S"] < 32
        assert c["grid"] == n_pairs
    # the narrow class keeps 32 one-warp blocks on an SM (228 KB of shared memory)
    assert plan[0]["threads"] == 32 and 32 * plan[0]["smem_bytes"] <= 228 * 1024
    # a narrower pad needs only the classes that hold it
    assert [c["width"] for c in twc.kernel_plan(n_pairs, 40)] == [16, 40]
    assert [c["width"] for c in twc.kernel_plan(n_pairs, 12)] == [16]
    for bad in (0, 97):
        with pytest.raises(ValueError):
            twc.kernel_plan(n_pairs, bad)


def test_width_class_rule_follows_the_tiers():
    """A pair's class is the smallest tier that holds its larger side, else
    the full 96: the tier `_wass_chunk_tiered` picks for a chunk of that
    pair alone."""
    for count in range(0, 97):
        tier = next((w for w in tw.W_TIERS if count <= w), 96)
        assert twc.pair_width(count) == tier
    with pytest.raises(ValueError):
        twc.pair_width(97)


def test_kernel_source_lays_out_what_the_plan_reckons():
    """`class_shape` reckons the shared memory that the source's `Layout<W>`
    sizes each launch with, and the source instantiates and classifies by
    exactly the plan's widths."""
    src = twc.SRC.read_text()
    floats = re.search(r"FLOATS = ([^;]+);", src).group(1)
    for w in twc.WIDTHS:
        shape = twc.class_shape(w)
        S = 2 * w
        env = dict(S=S, LD=S + 4, W=w, WARPS=shape["threads"] // 32)
        assert eval(floats, env) * 4 == shape["smem_bytes"]
    widths = re.search(r"kWidths\[N_CLASSES\] = \{([^}]+)\}", src).group(1)
    assert tuple(int(x) for x in widths.split(",")) == twc.WIDTHS
    assert tuple(int(c) for c in re.findall(r"CASE\((\d+)\)", src)) == twc.WIDTHS
    assert int(re.search(r"MAX_STEPS = (\d+);", src).group(1)) >= tw.STEPS
    assert 'extern "C" int sinkhorn_tiered_launch(' in src


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
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda)")
    for name, args in _card_cases().items():
        xs = [torch.as_tensor(x, device="cuda") for x in args]
        before = twc.sinkhorn_tiered_cuda.launches
        got = tprog._wass_sinkhorn_tiered(*xs)
        assert twc.sinkhorn_tiered_cuda.launches == before + 4
        ref = tprog.wass_sinkhorn_tiered_plain(*xs)
        torch.cuda.synchronize()
        got, ref = got.cpu().numpy(), ref.cpu().numpy()
        print(f"kernel vs plain {name}: max rel err {_worst(got, ref):.3e}")
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, rtol=2e-4)
