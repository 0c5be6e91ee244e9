"""The H1 kernel's host side, on the CPU: the launch plan, phase 1's
chunking and the properties of the plain reduction that the kernel's work
queue relies on.  The kernel itself runs on the card only
(`test_torch_homology.py::test_kernel_matches_plain_on_card`, chip_smoke.py)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from chip_smoke import ragged_clouds
from tda_eeg_audio_tpu.ops import homology_h1 as jh1
from tda_eeg_audio_tpu_torch.ops import homology_cuda as thc
from tda_eeg_audio_tpu_torch.ops import homology_h1 as th1
from tda_eeg_audio_tpu_torch.ops import phase1_cuda as P1
from tda_eeg_audio_tpu_torch.ops import wasserstein_cuda as twc

torch.set_num_threads(2)

N_SMS = 132
SHAPES = [(47, 128), (124, 96), (24, 64), (128, 128)]


@pytest.mark.parametrize("n,na", SHAPES)
@pytest.mark.parametrize("n_windows", [1, 100, 3120])
def test_kernel_plan_within_limits(n, na, n_windows):
    m = n * (n - 1) // 2
    for resident in (1, 13, 32):
        plan = thc.kernel_plan(n, na, n_windows, resident, N_SMS)
        assert plan["smem_bytes"] <= 232_448
        assert plan["W"] % 32 == 0 and plan["W"] * 32 >= m * n
        assert plan["W"] * 32 < m * n + 1024          # no more than one l1 word of padding
        assert 1 <= plan["grid"] <= min(n_windows, resident * N_SMS)
        assert plan["arena_bytes"] == plan["grid"] * na * plan["W"] * 8
        assert plan["arena_bytes"] <= thc.ARENA_BYTES
        assert plan["threads"] == (64 if n <= 64 else 256)


def test_kernel_plan_caps_grid_by_arena():
    """At n = 128 a full card of blocks would need more than the arena's
    bound: the grid shrinks, the slot does not."""
    plan = thc.kernel_plan(128, 128, 5000, 1, N_SMS)
    assert plan["grid"] == thc.ARENA_BYTES // plan["slot_bytes"] < N_SMS


def test_kernel_shape_by_cloud_size():
    assert thc.kernel_shape(47)["threads"] == 64
    assert thc.kernel_shape(64)["threads"] == 64
    assert thc.kernel_shape(65)["threads"] == 256
    assert thc.kernel_shape(124)["threads"] == 256
    # the column dominates: 118 KB at n = 124, 6.4 KB at n = 47
    assert thc.kernel_shape(124)["W"] * 4 == 118_272
    assert thc.kernel_shape(47)["W"] * 4 == 6_400
    for bad in (1, 129):
        with pytest.raises(ValueError):
            thc.kernel_shape(bad)
    with pytest.raises(ValueError):
        thc.kernel_plan(47, 129, 10, 1)


def test_kernel_source_lays_out_what_the_plan_reckons():
    """`kernel_shape` repeats the shared-memory layout of the CUDA source:
    the same arrays, in bytes (the card checks the total at load)."""
    src = (Path(thc.__file__).parent.parent / "csrc" / "h1_reduce.cu").read_text()
    body = src[src.index("inline Layout layout("):src.index("L.total = o;")]
    terms = re.findall(r"o \+= ([^;]+);", body)
    n, m, Wp, up16 = 124, 124 * 123 // 2, thc.kernel_shape(124)["W"], thc._up16
    total = sum(eval(t, dict(n=n, m=m, Wp=Wp, up16=up16, kMaxNa=thc.MAX_NA))
                for t in terms)
    assert len(terms) == 12 and total == thc.kernel_shape(124)["smem_bytes"]


@pytest.mark.parametrize("n,windows", [(124, 1200), (47, 3120)])
def test_phase1_chunk_holds_a_study_batch(n, windows):
    m = n * (n - 1) // 2
    chunk = thc.phase1_chunk(n)
    assert chunk >= windows                     # one kernel launch per stage
    assert chunk * 8 * m * n <= thc.PHASE1_BYTES
    assert thc.phase1_chunk(128) >= 1


def test_kernel_source_builds_the_block_sizes_of_the_plan():
    """The library is instantiated for the block sizes `kernel_shape` can
    ask for and no other, in the launch and in the occupancy query."""
    src = (Path(thc.__file__).parent.parent / "csrc" / "h1_reduce.cu").read_text()
    planned = {thc.kernel_shape(n)["threads"] for n in range(2, thc.MAX_N + 1)}
    assert {int(t) for t in re.findall(r"return launch<(\d+)>", src)} == planned
    assert {int(t) for t in re.findall(r"return report<(\d+)>", src)} == planned


def test_reduce_plain_commutes_with_window_permutation():
    """Windows are independent: reducing them in another order gives the
    same outputs in that order (what lets blocks take windows from a
    queue), with a budget that some windows exceed."""
    dm, n_pts = ragged_clouds("cpu", n_windows=24, seed=3)
    ins = th1.reduction_inputs(th1._phase1(dm, 24, 2.0, 64, n_pts))
    want = th1.reduce_plain(*ins, n=24, step_budget=32)
    perm = torch.as_tensor(np.random.default_rng(1).permutation(24))
    got = th1.reduce_plain(*(t[perm].contiguous() for t in ins), n=24,
                           step_budget=32)
    assert want[2].any() and not want[2].all()
    for a, b in zip(got, want):
        assert torch.equal(a, b[perm])
    # and one window alone is the same as inside the batch
    one = th1.reduce_plain(*(t[5:6] for t in ins), n=24, step_budget=32)
    for a, b in zip(one, want):
        assert torch.equal(a, b[5:6])


def test_ragged_clouds_match_jax():
    """The ragged case of the card check (padded clouds down to one point,
    windows without creators, a small step budget), plain PyTorch against
    the JAX lockstep: bars of the finished windows and all flags equal."""
    dm, n_pts = ragged_clouds("cpu", n_windows=32, seed=1)
    kw = dict(n=24, thresh=2.0, na_max=64, h1_max=64)
    t = th1.h1_diagrams_plain(dm, n_pts, step_budget=32, **kw)
    a = jh1.h1_diagrams(jnp.asarray(dm.numpy()), jnp.asarray(n_pts.numpy()),
                        step_budget=32, **kw)
    ovf = t["overflow"].numpy()
    np.testing.assert_array_equal(ovf, np.asarray(a["overflow"]))
    assert ovf.any() and not ovf.all() and int((t["n_na"] == 0).sum()) > 0
    assert sorted(set(n_pts.tolist())) == [1, 2, 3, 12, 20, 24]
    full = th1.h1_diagrams_plain(dm, n_pts, step_budget=4096, **kw)
    ref = jh1.h1_diagrams(jnp.asarray(dm.numpy()), jnp.asarray(n_pts.numpy()),
                          step_budget=4096, **kw)
    for k in ("births", "deaths", "mask", "n_essential", "overflow", "h0_deaths"):
        np.testing.assert_array_equal(full[k].numpy(), np.asarray(ref[k]), err_msg=k)
    done = ~ovf                                 # a finished window is final
    for k in ("births", "deaths", "mask", "steps"):
        assert torch.equal(t[k][done], full[k][done]), k


def test_profiled_launch_refuses_cpu_and_stays_out_of_entry_points():
    dm, n_pts = ragged_clouds("cpu", n_windows=4)
    ins = th1.reduction_inputs(th1._phase1(dm, 24, 2.0, 64, n_pts))
    before = thc.h1_diagrams_cuda.launches
    with pytest.raises(ValueError):
        thc.reduce_cuda_profiled(*ins, n=24, step_budget=32)
    with pytest.raises(ValueError):
        thc.reduce_cuda(*ins, n=24, step_budget=32)
    assert thc.h1_diagrams_cuda.launches == before
    p1_before = P1.phase1_cuda.launches
    with pytest.raises(ValueError):
        P1.phase1_cuda_profiled(dm, 24, 2.0, 64, n_pts)
    assert P1.phase1_cuda.launches == p1_before
    sk_before = twc.sinkhorn_tiered_cuda.launches
    bars = torch.zeros((2, 16)), torch.ones((2, 16)), torch.ones((2, 16), dtype=torch.bool)
    with pytest.raises(ValueError):
        twc.sinkhorn_tiered_cuda_profiled(*bars, *bars)
    assert twc.sinkhorn_tiered_cuda.launches == sk_before
    # each instrumented build is named by its kernel's module only
    pkg = Path(thc.__file__).parent.parent
    own = {"homology_cuda.py": r"reduce_cuda_profiled|H1_PROFILE",
           "phase1_cuda.py": r"phase1_cuda_profiled|H1_PHASE1_PROFILE",
           "wasserstein_cuda.py": r"sinkhorn_tiered_cuda_profiled|SINKHORN_PROFILE"}
    users = [p for p in pkg.rglob("*.py")
             if re.search("|".join(v for k, v in own.items() if k != p.name)
                          + r"|PROFILE_FLAGS" * (p.name not in own), p.read_text())]
    assert users == []


def test_only_cuda_build_binds_native_libraries():
    """`ops/cuda_build` is the one owner of the port's native libraries: no
    other module of the package opens a library, sets an entry point's
    types or keeps a cache of libraries; every launcher declares its
    `SIGNATURES` and loads through `cuda_build.load`."""
    pkg = Path(thc.__file__).parent.parent
    binding = re.compile(r"ctypes\.CDLL|cdll\.LoadLibrary|\.argtypes\s*=|\.restype\s*="
                         r"|_libs\s*=")
    owners = sorted(p.relative_to(pkg).as_posix() for p in pkg.rglob("*.py")
                    if binding.search(p.read_text()))
    assert owners == ["ops/cuda_build.py"]
    launchers = sorted(pkg.glob("ops/*_cuda.py")) + [pkg / "native" / "engine.py"]
    assert len(launchers) == 9
    for p in launchers:
        src = p.read_text()
        assert "SIGNATURES = {" in src and "cuda_build.load(" in src, p.name
