"""The exact Butterworth filtfilt bank (`filter_impl="iir_scan"`) of the port
against the JAX package and scipy on the CPU, and the CUDA kernel's host
side.  The kernel itself runs on the card only (`test_kernel_matches_plain_on_card`,
chip_smoke.py phase 10).

Tolerances, relative to each band's largest |reference| value:
  * port vs scipy's float64 `sosfiltfilt`: 1e-5 (the port's float64
    recurrence rounds only its float32 output; worst ~5e-8);
  * port vs the JAX package: the JAX package's own float32 associative-scan
    error sets it — 1e-2 in delta (poles nearest the unit circle; 3.9e-3
    the worst here, 5.3e-3 over longer random walks) and 1e-4 in the other
    bands (theta 4.9e-5 the worst here).  The port is the closer of the two
    to scipy, so the two differ by about the JAX package's error; each worst
    case is printed (`pytest -rP`);
  * the odd extension's clipped source index (n ≤ edge), n = 0 and the
    zeros beyond n are held exactly where exactness is the contract."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal as sps

from tda_eeg_audio_tpu.ops import signal as jsig
from tda_eeg_audio_tpu_torch.ops import iir_cuda as tic
from tda_eeg_audio_tpu_torch.ops import signal as tsig

torch.set_num_threads(1)

BANDS = ("delta", "theta", "alpha", "beta", "gamma")
JAX_TOL = dict(delta=1e-2, theta=1e-4, alpha=1e-4, beta=1e-4, gamma=1e-4)
T = 1200
NS = np.array([1200, 731, 20, 0])          # full, ragged, n ≤ edge (27), empty


def _walk(rng, shape):
    """Random walk plus noise: the low-frequency power that stresses the
    delta band's poles."""
    return (np.cumsum(rng.standard_normal(shape), -1)
            + rng.standard_normal(shape)).astype(np.float32)


@pytest.fixture(scope="module")
def bank():
    rng = np.random.default_rng(0)
    x = _walk(rng, (len(NS), 3, T))
    x = np.where(np.arange(T)[None, None, :] < NS[:, None, None], x, 0.0).astype(np.float32)
    n = NS[:, None]
    got = tsig.bandpass_bank_iir_scan(torch.as_tensor(x), torch.as_tensor(n),
                                      250, 4).numpy()
    fn = jax.jit(jsig.bandpass_bank_iir_scan, static_argnums=(2, 3))
    ref = np.asarray(fn(jnp.asarray(x), jnp.asarray(n), 250, 4))
    return x, got, ref


def _rel(got, ref):
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def test_designs_equal_the_reference():
    for lo, hi in ((0.5, 4.0), (4.0, 8.0), (30.0, 50.0)):
        for a, b in zip(tsig.design_butter_sos(lo, hi, 250),
                        jsig.design_butter_sos(lo, hi, 250)):
            np.testing.assert_array_equal(a, b)
    sos, zi = tsig.design_butter_band_bank(250, 4)
    jsos, jzi = jsig.design_butter_band_bank(250, 4)
    assert sos.shape == (5, 4, 6) and zi.shape == (5, 4, 2)
    np.testing.assert_array_equal(sos, jsos)
    np.testing.assert_array_equal(zi, jzi)


def test_bank_matches_jax_within_its_scan_error(bank):
    x, got, ref = bank
    assert got.shape == ref.shape == (len(NS), 3, 5, T) and got.dtype == np.float32
    for b, name in enumerate(BANDS):
        rel = _rel(got[..., b, :], ref[..., b, :])
        print(f"{name}: port vs JAX {rel:.3g} of max|ref| (tolerance {JAX_TOL[name]:g})")
        assert rel < JAX_TOL[name], name


def test_bank_zero_beyond_n_and_short_series_follow_jax(bank):
    """Zeros beyond n everywhere (all zeros at n = 0); at n = 20 ≤ edge the
    extension reads past n (its source index clipped to T − 1, as the JAX
    package does) and the port still follows the JAX output."""
    x, got, ref = bank
    for i, n in enumerate(NS):
        assert np.all(got[i, ..., n:] == 0.0) and np.all(ref[i, ..., n:] == 0.0)
    for b, name in enumerate(BANDS):
        rel = _rel(got[2, :, b, :20], ref[2, :, b, :20])
        print(f"{name}, n = 20: port vs JAX {rel:.3g}")
        assert rel < JAX_TOL[name]


def test_bank_matches_scipy(bank):
    x, got, _ = bank
    sos, _ = tsig.design_butter_band_bank(250, 4)
    worst = 0.0
    for i, n in enumerate(NS):
        if n <= tsig.sos_edge(sos):        # scipy refuses signals this short
            continue
        for b in range(5):
            ref = sps.sosfiltfilt(sos[b], x[i, :, :n].astype(np.float64))
            worst = max(worst, _rel(got[i, :, b, :n], ref))
    print(f"port vs scipy float64: {worst:.3g}")
    assert worst < 1e-5


def test_full_length_matches_scipy():
    """At the study's full length (T_pad 5800), the bank and the single-band
    masked form against scipy's float64 sosfiltfilt, within 1e-5."""
    rng = np.random.default_rng(3)
    x = _walk(rng, (2, 5800))
    ns = np.array([5800, 4100])
    x[1, 4100:] = 0.0
    got = tsig.bandpass_bank_iir_scan(torch.as_tensor(x), torch.as_tensor(ns),
                                      250, 4).numpy()
    sos, zi = tsig.design_butter_band_bank(250, 4)
    worst = 0.0
    for i, n in enumerate(ns):
        for b in range(5):
            ref = sps.sosfiltfilt(sos[b], x[i, :n].astype(np.float64))
            worst = max(worst, _rel(got[i, b, :n], ref))
    one = tsig.sosfiltfilt_scan_masked(torch.as_tensor(x), torch.as_tensor(ns),
                                       sos[0], zi[0]).numpy()
    np.testing.assert_array_equal(one, got[:, 0])
    print(f"T 5800, port vs scipy float64: {worst:.3g}")
    assert worst < 1e-5


def test_masked_single_band_matches_jax():
    rng = np.random.default_rng(1)
    x = _walk(rng, (4, 600))
    ns = np.array([600, 433, 27, 0])
    sos, zi = tsig.design_butter_sos(4.0, 8.0, 250)
    got = tsig.sosfiltfilt_scan_masked(torch.as_tensor(x), torch.as_tensor(ns),
                                       sos, zi).numpy()
    ref = np.asarray(jax.jit(lambda a, m: jsig.sosfiltfilt_scan_masked(a, m, sos, zi))(
        jnp.asarray(x), jnp.asarray(ns)))
    rel = _rel(got, ref)
    print(f"theta, masked, port vs JAX {rel:.3g}")
    assert rel < JAX_TOL["theta"]
    assert np.all(got[3] == 0.0) and np.all(got[2, 27:] == 0.0)


def test_unmasked_forms_match_jax_and_scipy():
    rng = np.random.default_rng(2)
    x = _walk(rng, (3, 500))
    sos, zi = tsig.design_butter_sos(8.0, 13.0, 250)
    got = tsig.sosfiltfilt_scan(torch.as_tensor(x), sos, zi).numpy()
    ref = np.asarray(jax.jit(lambda a: jsig.sosfiltfilt_scan(a, sos, zi))(jnp.asarray(x)))
    assert got.shape == ref.shape == x.shape
    assert _rel(got, ref) < JAX_TOL["alpha"]
    assert _rel(got, sps.sosfiltfilt(sos, x.astype(np.float64))) < 1e-5
    bp = tsig.bandpass_iir_scan(torch.as_tensor(x), 250, 8.0, 13.0).numpy()
    np.testing.assert_array_equal(bp, got)
    # a band above Nyquist clamps to nothing: pass-through, as the reference
    xt = torch.as_tensor(x)
    assert tsig.bandpass_iir_scan(xt, 250, 130.0, 200.0) is xt


def test_sos_edge_is_scipys_padlen():
    """edge = 3·ntaps with ntaps reduced by first-order sections: an odd
    low-pass design has one (b2 = a2 = 0), and the unmasked form with that
    edge equals scipy's default padding."""
    sos_bank, _ = tsig.design_butter_band_bank(250, 4)
    assert tsig.sos_edge(sos_bank) == tsig.sos_edge(sos_bank[0]) == 27
    sos = sps.butter(3, 0.2, output="sos")
    assert tsig.sos_edge(sos) == 3 * (2 * 2 + 1 - 1)
    x = _walk(np.random.default_rng(4), (200,))
    got = tsig.sosfiltfilt_scan(torch.as_tensor(x), sos, sps.sosfilt_zi(sos)).numpy()
    assert _rel(got, sps.sosfiltfilt(sos, x.astype(np.float64))) < 1e-5
    mixed = np.stack([sos_bank[0][:3], np.concatenate([sos, sos[:1]])])
    with pytest.raises(ValueError):
        tsig.sos_edge(mixed)


def test_kernel_plan():
    """One block per (series, band) chain, the time axis in odd chunks of C
    samples, one a thread; the chain's float64 extension in shared memory
    up to a block's limit (no device-memory scratch at T_pad 5800), in
    device memory just past it."""
    edge = tsig.sos_edge(tsig.design_butter_band_bank(250, 4)[0])
    plan = tic.kernel_plan(16 * 47, 5, 5800, edge, 4)
    assert plan == dict(threads=256, chunk=23, chunks=255, chains=3760, grid=3760,
                        text=5854, shared_bytes=46_832, blocks_per_sm=4,
                        staging="shared", scratch_bytes=0)
    big = tic.kernel_plan(64 * 47, 5, 5800, edge, 4)
    assert big["grid"] == 15_040 and big["scratch_bytes"] == 0
    assert [tic.kernel_plan(1, 5, 5800, edge, 4, t)["chunk"] for t in tic.THREAD_CHOICES] \
        == [183, 93, 47, 23, 13, 7]
    # the last T whose extension fits a block beside the carry's static part
    t_max = (tic.SMEM_BLOCK - tic.STATIC_SMEM) // 8 - 2 * edge
    assert t_max == 28_874
    fits = tic.kernel_plan(1, 5, t_max, edge, 4)
    past = tic.kernel_plan(1, 5, t_max + 1, edge, 4)
    assert (fits["staging"], fits["shared_bytes"], fits["scratch_bytes"],
            fits["blocks_per_sm"]) == ("shared", (t_max + 2 * edge) * 8, 0, 1)
    assert (past["staging"], past["shared_bytes"], past["scratch_bytes"],
            past["blocks_per_sm"]) == ("device", 0, (t_max + 1 + 2 * edge) * 5 * 8, 8)
    long = tic.kernel_plan(1, 5, 40_000, edge, 4)
    assert (long["staging"], long["chunk"], long["chunks"]) == ("device", 157, 256)
    # ragged lengths: C odd, the chunks cover the extension, none is empty
    assert tic.kernel_plan(1, 5, 1200, edge, 4)["chunk"] == 5
    assert tic.kernel_plan(1, 5, 1200, edge, 4)["chunks"] == 251
    assert tic.kernel_plan(1, 5, 10, edge, 4, 32)["chunks"] == 22   # C = 3: 10 threads idle
    for T in (0, 1, 20, 731, 1200, 5800, 40_000):
        for threads in tic.THREAD_CHOICES:
            p = tic.kernel_plan(2, 5, T, edge, 4, threads)
            assert p["chunk"] % 2 == 1 and p["chunk"] * threads >= p["text"], (T, threads)
            assert (p["chunks"] - 1) * p["chunk"] < p["text"] <= p["chunks"] * p["chunk"]
            assert p["chunks"] <= threads and p["blocks_per_sm"] >= 1
    for bad in (0, tic.MAX_SECTIONS + 1):
        with pytest.raises(ValueError):
            tic.kernel_plan(10, 5, 100, edge, bad)
    with pytest.raises(ValueError):
        tic.kernel_plan(10, 5, 100, edge, 4, threads=96)
    # the source instantiates exactly the sections the plan accepts, and its
    # entry points are what the wrapper binds
    src = Path(tic.SRC).read_text()
    cases = [int(c) for c in re.findall(r"CASE\((\d+)\)", src)]
    assert cases == list(range(1, tic.MAX_SECTIONS + 1))
    assert 'extern "C" int sosfiltfilt_launch(' in src
    assert 'extern "C" int sosfiltfilt_layout(' in src


def _odd_extension(x, n, edge):
    """The kernel's buffer before the forward pass: x (R, T) → (R, T + 2·edge)
    float64, the odd extension of each row to n + 2·edge samples (source
    index clipped to [0, T − 1]), zero beyond."""
    R, T = x.shape
    xd = x.double()
    j = torch.arange(T + 2 * edge)
    nn = n[:, None]
    take = lambda i: xd.gather(1, i.clamp(0, T - 1).expand(R, -1))
    left = 2.0 * xd[:, :1] - take(edge - j[None])
    mid = take(j[None] - edge)
    right = 2.0 * take(nn - 1) - take(nn - 2 - (j[None] - edge - nn))
    ext = torch.where(j < edge, left, torch.where(j < edge + nn, mid, right))
    return torch.where(j < nn + 2 * edge, ext, 0.0)


def _chunked_pass(buf, first, step, n_pass, u0, sos, zi, pw, chunk):
    """One pass of the kernel's cascade, modelled in float64 over every chain
    and chunk at once: sample j of chain r at buf[r, first[r] + step·j],
    j < n_pass[r]; per section (a) each chunk from zero state (chunk 0 from
    zi·u0), (b) the kernel's carry (a Kogge–Stone scan over 32-chunk warps
    with A^(C·d), the warps in order through A^(32·C), A^(C·(lane + 1)) on
    the warp's incoming state), (c) each chunk rerun from its true start,
    its output written over its input."""
    R, text = buf.shape
    C = chunk
    W = max(1, -(-(-(-int(n_pass.max()) // C)) // 32))
    K = 32 * W
    lo = torch.arange(K) * C
    lens = (torch.minimum(lo[None] + C, n_pass[:, None]) - lo[None]).clamp(0, C)
    on = torch.arange(C)[None, None] < lens[..., None]             # (R, K, C)
    idx = (first[:, None, None] + step * (lo[None, :, None] + torch.arange(C))
           ).clamp(0, text - 1)
    flat = buf.view(-1)
    rows = torch.arange(R)[:, None, None] * text
    mv = lambda M, v: torch.einsum("...ab,...b->...a", M, v)
    lane = torch.arange(32)[:, None]
    for s in range(sos.shape[1]):
        b0, b1, b2, a1, a2 = (sos[:, s, i][:, None] for i in (0, 1, 2, 4, 5))
        P = pw[:, s]                                                 # (R, 32, 2, 2)
        start = torch.zeros(R, K, 2, dtype=torch.float64)
        start[:, 0] = zi[:, s] * u0[:, None]

        def run(z, write):
            r = buf.gather(1, idx.view(R, -1)).view(on.shape)
            z1, z2 = z[..., 0].clone(), z[..., 1].clone()
            for j in range(C):
                u, m = r[..., j], on[..., j]
                y = b0 * u + z1
                z1 = torch.where(m, (b1 * u + z2) - a1 * y, z1)
                z2 = torch.where(m, b2 * u - a2 * y, z2)
                r[..., j] = y
            if write:
                flat[(rows + idx)[on]] = r[on]
            return torch.stack([z1, z2], -1)

        v = run(start, False).view(R, W, 32, 2)
        for d in (1, 2, 4, 8, 16):
            q = torch.zeros_like(v)
            q[:, :, d:] = v[:, :, :-d]
            v = v + torch.where(lane >= d, mv(P[:, d - 1][:, None, None], q), 0.0)
        inc = torch.zeros(R, W, 2, dtype=torch.float64)
        for w in range(1, W):
            inc[:, w] = v[:, w - 1, 31] + mv(P[:, 31], inc[:, w - 1])
        v = v + mv(P[:, None], inc[:, :, None])
        true_start = torch.cat([inc[:, :, None], v[:, :, :31]], 2).view(R, K, 2)
        true_start[:, 0] = start[:, 0]
        run(true_start, True)


def chunked_bank(x, n, sos_bank, zi_bank, edge, chunk):
    """A float64 model of the kernel at chunk length `chunk`, from the
    launcher's own operators (`chunk_operators`): x (N, T), n (N,) →
    (N, nb, T) float64."""
    N, T = x.shape
    nb = sos_bank.shape[0]
    n = torch.as_tensor(n).long().clamp(0, T).repeat_interleave(nb)
    band = torch.arange(N * nb) % nb
    sos = torch.as_tensor(sos_bank)[band]
    zi = torch.as_tensor(zi_bank)[band]
    pw = torch.as_tensor(tic.chunk_operators(sos_bank, chunk))[band]
    buf = _odd_extension(torch.as_tensor(x), torch.as_tensor(n[::nb]), edge
                         ).repeat_interleave(nb, 0).contiguous()
    L = n + 2 * edge
    _chunked_pass(buf, torch.zeros_like(L), 1, L, buf[:, 0].clone(), sos, zi, pw, chunk)
    r0 = buf[torch.arange(N * nb), L - 1].clone()
    _chunked_pass(buf, L - 1, -1, n + edge, r0, sos, zi, pw, chunk)
    t = torch.arange(T)
    out = torch.where(t < n[:, None], buf[:, edge:edge + T], 0.0)
    return out.view(N, nb, T)


@pytest.fixture(scope="module")
def chunked(bank):
    """The model on the module's ragged bank at chunk lengths 1, 7, the
    plan's own and one longer than any extension."""
    x, _, _ = bank
    sos, zi = tsig.design_butter_band_bank(250, 4)
    edge = tsig.sos_edge(sos)
    plan = tic.kernel_plan(x.shape[0] * x.shape[1], 5, T, edge, 4)
    xs, ns = x.reshape(-1, T), np.repeat(NS, x.shape[1])
    return {c: chunked_bank(xs, ns, sos, zi, edge, c).reshape(*x.shape[:2], 5, T)
            for c in (1, 7, plan["chunk"], T + 2 * edge + 47)}


def test_chunk_operators_reproduce_the_recurrence(bank, chunked):
    """The kernel's algebra on the CPU: chunks from zero state, the carry
    through the host's powers A^(C·m) and the rerun from each chunk's true
    start equal the plain float64 recurrence within 1e-12 of each band's
    max at every chunk length, on
    ragged lengths (n = 1200, 731, 20 ≤ edge, 0) and all five bands — the
    delta band's poles nearest the unit circle included."""
    x, _, _ = bank
    sos, zi = tsig.design_butter_band_bank(250, 4)
    plain = tsig.bandpass_bank_iir_plain(torch.as_tensor(x).double(),
                                         torch.as_tensor(NS[:, None]), sos, zi).numpy()
    for c, got in chunked.items():
        got = got.numpy()
        for b, name in enumerate(BANDS):
            rel = _rel(got[..., b, :], plain[..., b, :])
            print(f"chunk {c}, {name}: model vs plain {rel:.3g}")
            assert rel < 1e-12, (c, name)
        for i, n in enumerate(NS):
            assert np.all(got[i, ..., n:] == 0.0)
    A = tic.chunk_operators(sos, 3)
    assert A.shape == (5, 4, tic.POW_M, 2, 2)
    a = np.array([[-sos[0, 0, 4], 1.0], [-sos[0, 0, 5], 0.0]])
    np.testing.assert_allclose(A[0, 0, 1], np.linalg.matrix_power(a, 6), rtol=1e-13)
    # stable, the delta band's poles nearest the unit circle: its powers
    # grow before they decay (non-normal A), and still vanish at long range
    radius = np.abs(np.roots([1.0, sos[0, 0, 4], sos[0, 0, 5]])).max()
    assert radius < 1.0
    assert max(np.abs(np.roots([1.0, *sos[b, s, 4:]])).max() for b in range(5)
               for s in range(4)) == max(np.abs(np.roots([1.0, *sos[0, s, 4:]])).max()
                                          for s in range(4))
    assert np.abs(A[0]).max() > 1.0
    assert np.abs(tic.chunk_operators(sos, 500)[..., -1, :, :]).max() < 1e-12


def test_chunked_model_matches_jax(bank, chunked):
    """The model at the plan's chunk against the JAX package's
    `bandpass_bank_iir_scan`, within the module's JAX_TOL per band."""
    _, _, ref = bank
    edge = tsig.sos_edge(tsig.design_butter_band_bank(250, 4)[0])
    got = chunked[tic.kernel_plan(12, 5, T, edge, 4)["chunk"]].numpy()
    for b, name in enumerate(BANDS):
        rel = _rel(got[..., b, :], ref[..., b, :])
        print(f"{name}: chunked model vs JAX {rel:.3g} (tolerance {JAX_TOL[name]:g})")
        assert rel < JAX_TOL[name], name


def test_cuda_launcher_refuses_cpu_and_router_takes_plain():
    x = torch.zeros((2, 3, 100))
    sos, zi = tsig.design_butter_band_bank(250, 4)
    before = tic.sosfiltfilt_bank_cuda.launches
    with pytest.raises(ValueError):
        tic.sosfiltfilt_bank_cuda(x, 100, sos, zi, 27)
    out = tsig.bandpass_bank_iir_scan(x, torch.full((2, 1), 100), 250, 4)
    assert out.shape == (2, 3, 5, 100)
    assert tic.sosfiltfilt_bank_cuda.launches == before


def _card_case(rng, shape, T, ns):
    """Random walks of `shape` series on the card, zero beyond n."""
    x = torch.as_tensor(_walk(rng, (*shape, T)), device="cuda")
    n = torch.as_tensor(ns, device="cuda")
    return torch.where(torch.arange(T, device="cuda") < n[..., None], x, 0.0), n


def _hold_to_plain(got, x, n, sos, zi):
    ref = tsig.bandpass_bank_iir_plain(x, n, sos, zi)
    for b in range(sos.shape[0]):
        rel = _rel(got[..., b, :].cpu().numpy(), ref[..., b, :].cpu().numpy())
        assert rel < 1e-6, (b, rel)
    beyond = torch.arange(x.shape[-1], device="cuda") >= n.expand(x.shape[:-1])[..., None, None]
    assert bool((got.masked_select(beyond.expand(got.shape)) == 0).all())


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Ragged recordings, the runner's tuned batch of 64 recordings × 47
    channels at T_pad 5800 (the extension in shared memory), series of
    T = 12,000 (C = 49, 96 KB of shared memory) and one series of T = 40,000
    (staged through device memory): one launch each, within 1e-6 of each
    band's max|plain|, zero beyond n."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda)")
    rng = np.random.default_rng(5)
    sos, zi = tsig.design_butter_band_bank(250, 4)
    edge = tsig.sos_edge(sos)
    n64 = rng.integers(2500, 5801, (64, 1))
    n64[:2] = 5800
    cases = [_card_case(rng, (3, 47), 5800, [[5800], [4100], [20]]),
             _card_case(rng, (64, 47), 5800, n64),
             _card_case(rng, (2, 3), 12_000, [[12_000], [7_001]]),
             _card_case(rng, (1,), 40_000, [39_000])]
    plans = [tic.kernel_plan(int(np.prod(x.shape[:-1])), 5, x.shape[-1], edge, 4)
             for x, _ in cases]
    assert [(p["staging"], p["chunk"]) for p in plans] == [
        ("shared", 23), ("shared", 23), ("shared", 49), ("device", 157)]
    for x, n in cases:
        before = tic.sosfiltfilt_bank_cuda.launches
        got = tsig.bandpass_bank_iir_scan(x, n, 250, 4)
        assert tic.sosfiltfilt_bank_cuda.launches == before + 1
        _hold_to_plain(got, x, n, sos, zi)


@pytest.mark.cuda
def test_kernel_does_not_depend_on_chunk_length():
    """Every chunk length the plan can pick (one per thread count: C = 183
    … 7 at T_pad 5800) stays within 1e-6 of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda)")
    rng = np.random.default_rng(6)
    sos, zi = tsig.design_butter_band_bank(250, 4)
    edge = tsig.sos_edge(sos)
    x, n = _card_case(rng, (4, 47), 5800, [[5800], [4100], [731], [20]])
    for threads in tic.THREAD_CHOICES:
        got = tic.sosfiltfilt_bank_cuda(x, n, sos, zi, edge, threads=threads)
        _hold_to_plain(got, x, n, sos, zi)
