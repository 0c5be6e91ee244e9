"""The EEG window → correlation-distance step (`ops.geometry.window_distances`
and its CUDA kernel, `csrc/window_distance.cu`).

On the CPU: the router's plain version is, bit for bit, the chain the
programs ran before it (`sliding_windows` over every window → `gather` →
`correlation_matrix` → `correlation_to_distance`, copied here as
`parent_chain`) on random windows, flat (constant, all-zero) channels,
windows past T, a strided banded view and each of the four methods; the
features program (with `return_dm0` and `return_bank`) and the in-call
comparison's `_pair_distance_program` give the outputs they gave through
that chain; a model of the kernel's arithmetic (float32 sums over chunks of
the launch plan's t slices, met in float64, the norms dividing the sums)
is held to the plain version; the launcher's plan and checks.  The
`cuda`-marked tests hold the kernel on the card at the study's shapes to the
plain chain's NaN and zero entries, and its correlations to the plain chain
run in float64: within 1e-6, and no farther than the float32 plain chain
itself lies from it (~1.1e-6 at these shapes, so the two float32 versions
are not held within 1e-6 of each other)."""
import dataclasses

import numpy as np
import pytest
import torch

from tda_eeg_audio_tpu_torch.config import DEFAULT_CONFIG
from tda_eeg_audio_tpu_torch.models import programs as P
from tda_eeg_audio_tpu_torch.ops import geometry as G
from tda_eeg_audio_tpu_torch.ops import signal as S
from tda_eeg_audio_tpu_torch.ops import window_distance_cuda as WDC
from tda_eeg_audio_tpu_torch.runtime import last_record, timed_spans

torch.set_num_threads(1)

METHODS = ("euclidean", "abs", "standard", "sqrt")
WIN, STEP = 50, 12
CHUNK = 32      # steps of a float32 Gram sum before it joins float64 (the kernel's)


def parent_chain(banded, use_idx, method, win, step, n_win_max):
    """The programs' chain before the router: every window up to n_win_max,
    the selected ones gathered, the correlation and the distance."""
    C = banded.shape[1]
    wins = S.sliding_windows(banded, n_win_max, win, step).permute(0, 2, 3, 1, 4)
    sel = wins.gather(2, use_idx[:, :, :, None, None].expand(-1, -1, -1, C, win))
    return G.correlation_to_distance(G.correlation_matrix(sel), method)


def _banded(case: str, B=3, C=47, NB=5, T=400, seed=0):
    """(banded (B, C, NB, T) float32, use_idx (B, NB, K) int64, the windows
    the chain gathers from)."""
    g = torch.Generator().manual_seed(seed)
    n_win = (T - WIN) // STEP + 1
    if case == "strided":
        # the FIR bank's layout: a slice of a wider (B, C, NB, L) buffer
        buf = torch.randn((B, C, NB, T + 37), generator=g)
        banded = buf[..., 11:11 + T]
        assert not banded.is_contiguous()
    else:
        banded = torch.randn((B, C, NB, T), generator=g)
    if case == "flat":
        banded[0, 3] = 0.0                       # an all-zero channel
        banded[1, 5] = 2.5                       # a constant channel
        banded[2, :, 1] = -1.0                   # a whole band constant
        banded[1, 7, 2, :120] = 0.125            # flat in the first windows only
    if case == "past_t":
        n_win += 4                               # windows n_win-4 .. past T: NaN-filled
    idx = torch.randint(0, n_win, (B, NB, 7), generator=g)
    if case == "past_t":
        idx[:, :, 0] = n_win - 1
        idx[:, :, 1] = n_win - 3
    return banded, idx, n_win


CASES = ("random", "flat", "past_t", "strided")


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("case", CASES)
def test_plain_is_parent_chain(case, method):
    banded, idx, n_win = _banded(case)
    got = G.window_distances(banded, idx, method, WIN, STEP)
    want = parent_chain(banded, idx, method, WIN, STEP, n_win)
    assert got.shape == want.shape == (*idx.shape, 47, 47)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    if case == "past_t":
        assert bool(torch.isnan(got[:, :, 0]).any())
    if case == "flat":
        assert bool((got == 0).sum() > 0)


def kernel_model(banded, use_idx, method, win, step):
    """The kernel's arithmetic in torch: samples NaN at or past T, the mean
    from a float64 sum, x = v − mean in float32, float32 Gram sums over
    CHUNK steps of the plan's t slices met in float64, r = G_ij / (|x_i| |x_j|) in float64
    rounded once, 0 where a channel is flat (max == min without NaN, or a
    zero sum of squares), then `correlation_to_distance`'s float32 steps."""
    B, C, NB, T = banded.shape
    K = use_idx.shape[-1]
    plan = WDC.kernel_plan(B, NB, K, C, win)
    t = use_idx[..., None] * step + torch.arange(win)                 # (B, NB, K, win)
    src = banded.permute(0, 2, 1, 3)                                  # (B, NB, C, T)
    v = torch.gather(src[:, :, None].expand(-1, -1, K, -1, -1), 4,
                     t.clamp(0, T - 1)[:, :, :, None, :].expand(-1, -1, -1, C, -1))
    v = torch.where((t < T)[:, :, :, None, :], v, torch.nan)
    mean = (v.double().sum(-1) / win).float()
    x = v - mean[..., None]
    nan = torch.isnan(v).any(-1)
    flat = ~nan & (v.amax(-1) == v.amin(-1))
    g = torch.zeros((B, NB, K, C, C), dtype=torch.float64)
    for s in range(plan["slices"]):
        t0, t1 = s * win // plan["slices"], (s + 1) * win // plan["slices"]
        for c0 in range(t0, t1, CHUNK):
            xs = x[..., c0:min(c0 + CHUNK, t1)]
            g += (xs @ xs.transpose(-1, -2)).double()
    ss = torch.diagonal(g, dim1=-2, dim2=-1)
    flat |= ss == 0
    inv = 1.0 / torch.sqrt(ss)
    r = (g * inv[..., :, None] * inv[..., None, :]).float()
    r = torch.where(flat[..., :, None] | flat[..., None, :], 0.0, r)
    return G.correlation_to_distance(r, method)


@pytest.mark.parametrize("case", CASES)
def test_kernel_model_matches_plain(case):
    """The design's premise on the CPU: the kernel's arithmetic gives the
    plain version's correlations within 1e-6 (read through the "standard"
    method, d = 1 − r) and its NaN and zero entries exactly."""
    banded, idx, _ = _banded(case, seed=3)
    plain = G.window_distances(banded, idx, "standard", WIN, STEP)
    model = kernel_model(banded, idx, "standard", WIN, STEP)
    assert torch.equal(torch.isnan(plain), torch.isnan(model))
    assert torch.equal(plain == 0, model == 0)
    ok = ~torch.isnan(plain)
    assert float((plain[ok] - model[ok]).abs().max()) < 1e-6


# ── the programs ─────────────────────────────────────────────────────────


@pytest.fixture(scope="module")
def tiny():
    """Two recordings of 47 channels, 0.2 s windows (win 50, step 12), a
    101-tap FIR bank; a (2, 5, 7) window sample with windows near the end."""
    cfg = dataclasses.replace(DEFAULT_CONFIG, window_sec=0.2, fir_numtaps=101)
    n_win_max = 12
    win, step = cfg.win_samples, cfg.step_samples
    T = win + (n_win_max - 1) * step
    n_e = np.array([win + 7 * step, T], np.int64)
    rng = np.random.default_rng(4)
    eeg = np.zeros((2, 47, T), np.float32)
    for i, n in enumerate(n_e):
        eeg[i, :, :n] = rng.standard_normal((47, n))
    eeg[1, 9] = 0.0                               # a dead electrode
    use_idx = rng.integers(0, n_win_max, (2, 5, 7))
    use_idx[:, :, 0] = n_win_max - 1
    use_mask = np.ones((2, 5, 7), bool)
    use_mask[0, :, 5:] = False
    return dict(cfg=cfg, n_win_max=n_win_max, eeg=eeg, n_e=n_e, use_idx=use_idx,
                use_mask=use_mask, K=7)


def _parent_eeg_window_distances(n_win_max, K):
    """The parent's `eeg_window_distances` from every window of the band
    bank; a (K + 1)-th index column (the programs' window 0) takes the
    parent's window-0 diagnostics chain instead."""
    def run(eeg, n_samples, use_idx, cfg):
        banded = P._band_bank(eeg, n_samples, cfg)
        dist = parent_chain(banded, use_idx[:, :, :K], cfg.distance_method,
                            cfg.win_samples, cfg.step_samples, n_win_max)
        if use_idx.shape[2] == K:
            return dist
        assert use_idx.shape[2] == K + 1 and not bool(use_idx[:, :, K].any())
        wins, _ = P._banded_windows(eeg, n_samples, cfg, n_win_max)
        dm0 = G.correlation_to_distance(G.correlation_matrix(wins[:, :, 0]),
                                        cfg.distance_method)
        return torch.cat([dist, dm0[:, :, None]], dim=2)
    return run


def _same(got, want):
    if isinstance(got, dict):
        assert got.keys() == want.keys()
        for k in got:
            _same(got[k], want[k])
    elif isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("return_dm0,return_bank", [(True, False), (False, True),
                                                    (True, True)])
def test_feature_program_is_parents(tiny, monkeypatch, return_dm0, return_bank):
    def run():
        return P.eeg_feature_program(
            tiny["eeg"], tiny["n_e"], tiny["use_idx"], tiny["use_mask"], tiny["cfg"],
            K=tiny["K"], return_dm0=return_dm0, return_bank=return_bank, device="cpu")
    got = run()
    with monkeypatch.context() as m:
        m.setattr(P, "eeg_window_distances",
                  _parent_eeg_window_distances(tiny["n_win_max"], tiny["K"]))
        want = run()
    _same(got, want)


def test_pair_distance_program_is_parents(tiny):
    cfg, n_win_max, K = tiny["cfg"], tiny["n_win_max"], 5
    eeg = torch.as_tensor(tiny["eeg"])
    n_e = torch.as_tensor(tiny["n_e"])
    aud_idx = torch.tensor([[0, 3, 6, 11, 13], [2, 2, 5, 9, 10]])   # 13: clamped
    n_win = torch.tensor([4, 5])
    dist, kmask, n_pair = P._pair_distance_program(eeg, n_e, aud_idx, n_win, cfg, K,
                                                   n_win_max)
    banded = P._band_bank(eeg, n_e, cfg)
    idx = aud_idx.clamp(0, n_win_max - 1)[:, None, :].expand(-1, 5, -1)
    want = parent_chain(banded, idx, cfg.distance_method, cfg.win_samples,
                        cfg.step_samples, n_win_max)
    _same(dist, want.reshape(2, 5 * K, 47, 47))
    assert kmask.tolist() == [[True] * 4 + [False], [True] * 5]
    assert n_pair.tolist() == [4, 5]


def test_span_and_no_launch_on_the_cpu(tiny):
    """The step is the span `eeg_window_distances`; the CPU never reaches
    the launcher, so neither its launch count nor its counter moves."""
    before = WDC.window_distances_cuda.launches
    with timed_spans():
        P.eeg_feature_program(tiny["eeg"], tiny["n_e"], tiny["use_idx"], tiny["use_mask"],
                              tiny["cfg"], K=tiny["K"], return_dm0=True, device="cpu")
    rec = last_record()
    assert rec["spans"]["eeg_window_distances"]["parent"] == "eeg_feature_program"
    assert "window_distance.windows" not in rec["counters"]
    assert WDC.window_distances_cuda.launches == before


# ── the launcher's host side ─────────────────────────────────────────────


def test_plan_at_the_study_shapes():
    plan = WDC.kernel_plan(64, 5, 54, 47, 250)
    assert (plan["nt"], plan["tiles"], plan["slices"]) == (12, 78, 3)
    assert plan["tiles"] * plan["slices"] <= plan["threads"]
    assert plan["smem_bytes"] == 250 * WDC.CP * 4
    assert plan["windows"] == plan["grid"] == 64 * 5 * 54
    # every channel pair lies in exactly one tile of the upper triangle
    nt = plan["nt"]
    tiles = [(i, j) for i in range(nt) for j in range(i, nt)]
    assert len(tiles) == plan["tiles"]
    cover = {(a, b) for i, j in tiles for a in range(4 * i, 4 * i + 4)
             for b in range(4 * j, 4 * j + 4) if a <= b < 47}
    assert len(cover) == 47 * 48 // 2


@pytest.mark.parametrize("C,win,slices", [(1, 250, 250), (4, 1, 1), (16, 7, 7),
                                          (48, 250, 3), (47, 1000, 3)])
def test_plan_adapts_to_the_shapes(C, win, slices):
    plan = WDC.kernel_plan(2, 5, 3, C, win)
    assert plan["slices"] == slices
    assert plan["smem_bytes"] >= 8 * 16 * plan["tiles"] * plan["slices"]
    assert plan["smem_bytes"] >= 4 * win * WDC.CP


@pytest.mark.parametrize("C,win", [(0, 250), (49, 250), (64, 250), (47, 0), (47, 5000)])
def test_plan_raises_for_what_the_kernel_cannot_hold(C, win):
    with pytest.raises(ValueError):
        WDC.kernel_plan(64, 5, 54, C, win)


def test_launcher_checks_before_any_launch():
    before = WDC.window_distances_cuda.launches
    banded = torch.zeros((2, 47, 5, 300))
    idx = torch.zeros((2, 5, 3), dtype=torch.long)
    with pytest.raises(ValueError, match="CUDA"):
        WDC.window_distances_cuda(banded, idx, "euclidean", 50, 12)
    meta = banded.to("meta")
    with pytest.raises(ValueError):
        WDC.window_distances_cuda(meta, idx.to("meta"), "euclidean", 50, 12)
    assert WDC.window_distances_cuda.launches == before


# ── on the card ──────────────────────────────────────────────────────────


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda)")


def _study_inputs(dev, B=64, T=5800, K=54, seed=0, iir=False):
    """The study's banded shapes on the card: the FIR bank's strided output
    (or a contiguous IIR-shaped tensor) of B recordings of T samples, a
    (B, 5, K) sample of the 90 windows."""
    g = torch.Generator(device=dev).manual_seed(seed)
    eeg = torch.randn((B, 47, T), generator=g, device=dev)
    # band-limited like the bank's output: neighbouring electrodes correlated
    eeg = eeg + 0.8 * torch.roll(eeg, 1, dims=1)
    cfg = DEFAULT_CONFIG
    if iir:
        banded = torch.randn((B, 47, 5, T), generator=g, device=dev)
    else:
        banded = S.bandpass_bank(eeg, P._fir_bank(cfg, dev))
    n_win = (T - cfg.win_samples) // cfg.step_samples + 1
    idx = torch.randint(0, n_win, (B, 5, K), generator=g, device=dev)
    return banded, idx


def _reading(d, method):
    """The correlation as a distance shows it: r itself ("standard": 1 − r,
    "abs": 1 − |r|), 1 − r (euclidean: d² / 2) or 1 − r² ("sqrt": d²)."""
    d = d.double()
    return d * d / 2 if method == "euclidean" else d * d if method == "sqrt" else d


def _held(banded, idx, method):
    """The kernel's distances of idx against the plain chain's: NaN and zero
    entries identical; the reading within TOL[method] of the plain chain
    run in float64, and (for r itself) no farther than the plain chain."""
    got = G.window_distances(banded, idx, method, 250, 62)
    plain = G.window_distances_plain(banded, idx, method, 250, 62)
    f64 = G.window_distances_plain(banded.double(), idx, method, 250, 62)
    assert torch.equal(torch.isnan(got), torch.isnan(plain))
    assert torch.equal(got == 0, plain == 0)
    ok = ~torch.isnan(f64)
    if not bool(ok.any()):
        return 0.0
    ref = _reading(f64, method)[ok]
    err = float((_reading(got, method)[ok] - ref).abs().max())
    assert err < TOL[method], (method, err)
    if method == "standard":
        assert err <= float((_reading(plain, method)[ok] - ref).abs().max())
    return err


# |Δ reading| a float32 result may show for |Δr| ≤ 1e-6: "sqrt" reads 1 − r²
# (twice |Δr|) and each float32 distance adds its roundings
TOL = dict(standard=1e-6, abs=1e-6, euclidean=1e-6, sqrt=2.5e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("iir", [False, True])
@pytest.mark.parametrize("K", [54, 15])
def test_kernel_matches_plain_at_the_study_shapes(K, iir):
    _needs_card()
    banded, idx = _study_inputs(torch.device("cuda"), K=K, iir=iir)
    assert banded.is_contiguous() == iir
    for method in METHODS:
        _held(banded, idx, method)


@pytest.mark.cuda
@pytest.mark.parametrize("T,iir", [(300, True), (1999, False), (5800, False)])
def test_kernel_ragged_nan_and_flat_windows(T, iir):
    """Ragged lengths (T not a multiple of anything, windows past T), NaN
    samples, flat and all-zero channels, a band-expanded index (the in-call
    comparison's): the plain version's patterns and values."""
    _needs_card()
    dev = torch.device("cuda")
    banded, idx = _study_inputs(dev, B=9, T=T, K=15, seed=T, iir=iir)
    banded = banded.clone()
    banded[0, 4] = 0.0
    banded[1, 6, 2] = 3.0
    banded[2, 8, :, 100:110] = torch.nan
    banded[3, :, 4] = 1.5
    n_win = (T - 250) // 62 + 1
    idx[:, :, :3] = n_win - 1 + torch.arange(3, device=dev)        # 2 windows past T
    idx[4] = idx[4, :1].expand(5, -1)                                # one set for every band
    for method in METHODS:
        _held(banded, idx, method)
    _held(banded, idx[:, :1].expand(-1, 5, -1), "euclidean")
    assert bool(torch.isnan(G.window_distances(banded, idx, "euclidean", 250, 62)).any())


@pytest.mark.cuda
def test_kernel_counts_every_batch_and_raises_rather_than_falls_back():
    _needs_card()
    dev = torch.device("cuda")
    cfg = DEFAULT_CONFIG
    eeg = torch.randn((4, 47, 5800), device=dev)
    n_e = torch.full((4,), 5800, device=dev)
    use_idx = torch.randint(0, 90, (4, 5, 54), device=dev)
    use_mask = torch.ones((4, 5, 54), dtype=torch.bool, device=dev)
    before = WDC.window_distances_cuda.launches
    with timed_spans():
        for _ in range(2):
            P.eeg_feature_program(eeg, n_e, use_idx, use_mask, cfg, K=54,
                                  return_dm0=True, device=dev)
    # one launch a batch: window 0's diagnostics ride as a 55th index column
    assert WDC.window_distances_cuda.launches == before + 2
    assert last_record()["counters"]["window_distance.windows"] == 2 * 4 * 5 * 55
    banded = torch.randn((2, 49, 5, 300), device=dev)
    idx = torch.zeros((2, 5, 3), dtype=torch.long, device=dev)
    with pytest.raises(ValueError, match="channels"):
        G.window_distances(banded, idx, "euclidean", 250, 62)
    with pytest.raises(ValueError):
        G.window_distances(banded[:, :47], idx.int(), "euclidean", 250, 62)
    assert WDC.window_distances_cuda.launches == before + 2
