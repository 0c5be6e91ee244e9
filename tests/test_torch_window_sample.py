"""The features stage's md5 window sample: an integer model of the CUDA
kernel (`csrc/window_sample.cu`) against NumPy's `default_rng(md5).choice`
(`io.synthetic.window_sample_indices`, the specification), the router, the
launcher's host side and the runner's sample tables, on the CPU.  The
kernel itself runs on the card only (the `cuda`-marked test, chip_smoke.py's
phase 15).

The model is the kernel's chain lane by lane, in Python integers: MD5 block
by block over the stem's and the band suffix's bytes, NumPy's SeedSequence,
PCG64's 128-bit LCG with XSL-RR output, the buffered 32-bit halves, Lemire's
bounded draws, Floyd's algorithm over a bitmap and the Fisher-Yates shuffle,
and the bank's paired columns in float32.  It reads the kernel's constants
(MD5's sine table and initial state, SeedSequence's and PCG64's multipliers)
from the CUDA source, so a wrong constant there fails here.  Every
comparison is exact: the draw is integer arithmetic."""
import ctypes
import math
import re

import numpy as np
import pytest
import torch

from benchmark.harness.generator import dataset_index, durations_and_rates
from tda_eeg_audio_tpu_torch.config import BAND_NAMES, DEFAULT_CONFIG, GOOD_ELECTRODES
from tda_eeg_audio_tpu_torch.io.device_store import build_from_dataset
from tda_eeg_audio_tpu_torch.io.synthetic import window_sample_indices
from tda_eeg_audio_tpu_torch.models import study as tstudy
from tda_eeg_audio_tpu_torch.ops import cuda_build
from tda_eeg_audio_tpu_torch.ops import window_sample as tws
from tda_eeg_audio_tpu_torch.ops import window_sample_cuda as twc
from tda_eeg_audio_tpu_torch.runtime import last_record, timed_spans

torch.set_num_threads(1)

M32, M64, M128 = (1 << 32) - 1, (1 << 64) - 1, (1 << 128) - 1
SEED = DEFAULT_CONFIG.window_sample_seed
K_CMP = tstudy.K_CMP


def _kernel_constants():
    """The kernel source's scalar constants and MD5's sine table."""
    src = twc.SRC.read_text()
    consts = {m[1]: int(m[2].rstrip("uUlL"), 0) for m in re.finditer(
        r"constexpr (?:uint32_t|unsigned long long|int) (\w+) = (0x[0-9a-fA-F]+u?|\d+(?:ULL)?);",
        src)}
    table = re.search(r"MD5_K\[64\] = \{(.*?)\};", src, re.S)[1]
    consts["MD5_K"] = [int(x.strip().rstrip("u"), 16) for x in table.split(",")]
    return consts


C = _kernel_constants()
MD5_SHIFTS = ((7, 12, 17, 22), (5, 9, 14, 20), (4, 11, 16, 23), (6, 10, 15, 21))


def _rotl(x, s):
    return ((x << s) | (x >> (32 - s))) & M32


def md5_seed(msg: bytes) -> int:
    """The kernel's md5_seed: MD5 over ceil((L + 9) / 64) blocks, the
    digest's first four bytes read big-endian."""
    L = len(msg)
    blocks = (L + 8) // 64 + 1
    padded = msg + b"\x80" + bytes(64 * blocks - L - 9) + (8 * L).to_bytes(8, "little")
    h = [C["MD5_A0"], C["MD5_B0"], C["MD5_C0"], C["MD5_D0"]]
    for blk in range(blocks):
        M = [int.from_bytes(padded[64 * blk + 4 * w:64 * blk + 4 * w + 4], "little")
             for w in range(16)]
        a, b, c, d = h
        for i in range(64):
            if i < 16:
                f, g = (b & c) | (~b & d), i
            elif i < 32:
                f, g = (d & b) | (~d & c), (5 * i + 1) % 16
            elif i < 48:
                f, g = b ^ c ^ d, (3 * i + 5) % 16
            else:
                f, g = c ^ (b | (~d & M32)), (7 * i) % 16
            f = (f + a + C["MD5_K"][i] + M[g]) & M32
            a, d, c = d, c, b
            b = (b + _rotl(f, MD5_SHIFTS[i // 16][i % 4])) & M32
        h = [(x + y) & M32 for x, y in zip(h, (a, b, c, d))]
    return int.from_bytes(h[0].to_bytes(4, "little"), "big")


class Pcg:
    """The kernel's pcg_seeded / next_uint32 / bounded."""

    MULT = (C["PCG_MULT_HI"] << 64) | C["PCG_MULT_LO"]

    def __init__(self, e: int):
        hc = C["SS_INIT_A"]

        def hashmix(v):
            nonlocal hc
            v ^= hc
            hc = (hc * C["SS_MULT_A"]) & M32
            v = (v * hc) & M32
            return v ^ (v >> 16)

        def mix(x, y):
            r = (C["SS_MIX_MULT_L"] * x - C["SS_MIX_MULT_R"] * y) & M32
            return r ^ (r >> 16)

        pool = [hashmix(e if i == 0 else 0) for i in range(C["SS_POOL"])]
        for s in range(C["SS_POOL"]):
            for d in range(C["SS_POOL"]):
                if s != d:
                    pool[d] = mix(pool[d], hashmix(pool[s]))
        hb, st = C["SS_INIT_B"], []
        for i in range(8):
            v = pool[i % C["SS_POOL"]] ^ hb
            hb = (hb * C["SS_MULT_B"]) & M32
            v = (v * hb) & M32
            st.append(v ^ (v >> 16))
        w = [st[2 * k] | (st[2 * k + 1] << 32) for k in range(4)]
        self.inc = ((((w[2] << 64) | w[3]) << 1) | 1) & M128
        self.state = 0
        self._step()
        self.state = (self.state + ((w[0] << 64) | w[1])) & M128
        self._step()
        self.has, self.buf = False, 0

    def _step(self):
        self.state = (self.state * self.MULT + self.inc) & M128

    def next_uint32(self):
        if self.has:
            self.has = False
            return self.buf
        self._step()
        x = ((self.state >> 64) ^ self.state) & M64
        r = self.state >> 122
        out = ((x >> r) | (x << ((64 - r) & 63))) & M64
        self.has, self.buf = True, out >> 32
        return out & M32

    def bounded(self, rng: int) -> int:
        if rng == 0:
            return 0
        ex = rng + 1
        m = self.next_uint32() * ex
        if (m & M32) < ex:
            threshold = (M32 - rng) % ex
            while (m & M32) < threshold:
                m = self.next_uint32() * ex
        return m >> 32


def model_lane(stem: str, suffix: str, nw: int, n_pair: int, K: int, Kx: int,
               first: bool = False):
    """One lane's row as the kernel writes it: (idx (Kx,), mask (Kx,))."""
    k = min(K, nw)
    out = [0] * Kx
    if first:
        out[:k] = range(k)
    else:
        g = Pcg(md5_seed(stem.encode() + suffix.encode()))
        seen = [0] * ((nw + 31) // 32)
        for j in range(nw - k, nw):
            v = g.bounded(j)
            if seen[v >> 5] >> (v & 31) & 1:
                v = j
            seen[v >> 5] |= 1 << (v & 31)
            out[j - (nw - k)] = v
        for i in range(k - 1, 0, -1):
            j = g.bounded(i)
            out[i], out[j] = out[j], out[i]
    n_cmp = Kx - K
    for c in range(n_cmp):
        if n_pair <= n_cmp:
            out[K + c] = min(c, max(n_pair - 1, 0))
        else:
            prod = np.float32(c) * np.float32(n_pair - 1)
            out[K + c] = int(prod / np.float32(n_cmp - 1))
    return np.array(out, np.int64), np.arange(Kx) < k


def model(tables, row0, B, K, Kx):
    """The kernel's (B, 5, Kx) outputs over rows [row0, row0 + B)."""
    idx = np.zeros((B, 5, Kx), np.int64)
    mask = np.zeros((B, 5, Kx), bool)
    for b in range(B):
        r = row0 + b
        for bd, band in enumerate(BAND_NAMES):
            idx[b, bd], mask[b, bd] = model_lane(
                tables.stems[r], f"-{band}-{tables.seed}", int(tables.nw[r]),
                int(tables.n_pair[r]), K, Kx, tables.sampling != "random")
    return idx, mask


def _benchmark_tables():
    """The benchmark's 1,440-recording study in the features stage's order
    (sorted slow files, then sorted fast ones), at its window counts."""
    cfg = DEFAULT_CONFIG
    index = dataset_index(45, 16, 16)
    durs, _ = durations_and_rates(index)
    ns_e = np.minimum(np.round(durs * np.float32(cfg.fs_eeg)).astype(np.int64), 5800)
    nw = (ns_e - cfg.win_samples) // cfg.step_samples + 1
    order = [i for cond in ("slow", "fast") for i in sorted(
        (i for i in range(len(index)) if index[i][2] == cond), key=lambda i: index[i][0])]
    return tws.SampleTables([index[i][0].replace(".mat", "") for i in order],
                            nw[order], np.minimum(nw[order], 60))


def _edge_stem(total: int, band: str, seed: int) -> str:
    """A stem whose message "{stem}-{band}-{seed}" has `total` bytes."""
    return "s" * (total - len(f"-{band}-{seed}"))


def test_md5_model_is_md5():
    """The kernel's MD5 constants are RFC 1321's, and the model's digest
    prefix is hashlib's at every length across three block edges."""
    import hashlib

    assert C["MD5_K"] == [int(abs(math.sin(i + 1)) * 2 ** 32) for i in range(64)]
    for L in range(0, 131):
        msg = bytes((7 * i + L) % 251 for i in range(L))
        assert md5_seed(msg) == int(hashlib.md5(msg).hexdigest()[:8], 16), L


def test_model_matches_numpy_on_the_benchmark_index():
    """Every (stem, band) of the benchmark's 1,440 recordings at its nw and
    K = min nw = 39: the kernel's model is NumPy's draw."""
    tab = _benchmark_tables()
    K = int(tab.nw.min())
    assert K == 39 and int(tab.nw.max()) <= 90
    B = len(tab.stems)
    got_idx, got_mask = model(tab, 0, B, K, K)
    ref_idx, ref_mask = tws.window_sample_plain(tab, 0, B, K, K)
    np.testing.assert_array_equal(got_idx, ref_idx)
    np.testing.assert_array_equal(got_mask, ref_mask)


@pytest.mark.parametrize("seed", [0, 42, 2 ** 31])
@pytest.mark.parametrize("K", [1, 15, 39])
def test_model_matches_numpy_at_the_edges(K, seed):
    """nw at 1, 2, K − 1, K, K + 1, 90 and 200 windows, each band's message
    55, 56, 64 and 120 bytes long (MD5's block edges)."""
    for nw in sorted({n for n in (1, 2, K - 1, K, K + 1, 90, 200) if n >= 1}):
        for total in (55, 56, 64, 120):
            for band in BAND_NAMES:
                stem = _edge_stem(total, band, seed)
                assert len(f"{stem}-{band}-{seed}".encode()) == total
                idx, mask = model_lane(stem, f"-{band}-{seed}", nw, 0, K, K)
                ref = window_sample_indices(stem, band, nw, min(K, nw), "random", seed)
                np.testing.assert_array_equal(idx[:len(ref)], ref)
                assert not idx[len(ref):].any()
                np.testing.assert_array_equal(mask, np.arange(K) < len(ref))


def test_model_matches_numpy_on_the_guard_lanes():
    """The launcher's load-time guard draws its lanes through the kernel and
    NumPy: on them the kernel's model is this NumPy's draw (bank columns
    too), so the guard passes wherever NumPy draws as this one does."""
    tab = tws.SampleTables(twc.GUARD_STEMS, twc.GUARD_NW, twc.GUARD_N_PAIR)
    B = len(twc.GUARD_STEMS)
    lengths = {len(f"{s}-{b}-{SEED}".encode()) for s in twc.GUARD_STEMS for b in BAND_NAMES}
    assert {54, 55, 56, 119, 120} <= lengths and max(lengths) > 119
    assert min(twc.GUARD_NW) == 1 and max(twc.GUARD_NW) == twc.MAX_NW
    assert any(n <= twc.GUARD_K for n in twc.GUARD_NW)
    got = model(tab, 0, B, twc.GUARD_K, twc.GUARD_KX)
    ref = tws.window_sample_plain(tab, 0, B, twc.GUARD_K, twc.GUARD_KX)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


@pytest.mark.parametrize("n_pair", [0, 1, K_CMP - 1, K_CMP, 90])
def test_bank_columns_are_the_paired_windows(n_pair):
    """Columns [K, K + K_CMP) of every band: the model's float32 steps are
    `_paired_window_idx`, mask False, and so is the router's CPU path."""
    K, Kx = 39, 39 + K_CMP
    tab = tws.SampleTables(["bb03_ut07"], [90], [n_pair])
    idx, mask = model(tab, 0, 1, K, Kx)
    want = tstudy._paired_window_idx(n_pair, K_CMP)
    for bd in range(5):
        np.testing.assert_array_equal(idx[0, bd, K:], want)
    assert not mask[..., K:].any()
    r_idx, r_mask = tws.window_sample(tab, 0, 1, K, Kx, "cpu")
    np.testing.assert_array_equal(r_idx.numpy(), idx)
    np.testing.assert_array_equal(r_mask.numpy(), mask)


@pytest.mark.parametrize("sampling", ["random", "first"])
def test_router_takes_numpy_on_the_cpu(sampling):
    """The CPU path is NumPy's draw lane by lane (arange in "first" mode),
    zeros past min(K, nw), the kernel's model's rows; the launcher is not
    reached."""
    stems = ["bb01_ut01", "bb01_ut02", "bb02_ut01", "bb45_ut16"]
    nw = [77, 5, 39, 90]
    tab = tws.SampleTables(stems, nw, sampling=sampling, seed=SEED)
    before = twc.window_sample_cuda.launches
    idx, mask = tws.window_sample(tab, 1, 3, 39, 39, torch.device("cpu"))
    assert twc.window_sample_cuda.launches == before
    assert idx.dtype == torch.int64 and mask.dtype == torch.bool
    assert idx.shape == mask.shape == (3, 5, 39)
    for b in range(3):
        for bd, band in enumerate(BAND_NAMES):
            ref = window_sample_indices(stems[1 + b], band, nw[1 + b], min(39, nw[1 + b]),
                                        sampling, SEED)
            np.testing.assert_array_equal(idx[b, bd, :len(ref)].numpy(), ref)
            assert int(mask[b, bd].sum()) == len(ref)
    m_idx, m_mask = model(tab, 1, 3, 39, 39)
    np.testing.assert_array_equal(idx.numpy(), m_idx)
    np.testing.assert_array_equal(mask.numpy(), m_mask)


def _no_nvcc():
    raise RuntimeError("nvcc not found")


def test_router_never_falls_back_off_the_cpu(tmp_path):
    """A device that is not the CPU goes to the launcher, which raises for
    anything but a CUDA tensor (here the meta device: no card needed); and
    without nvcc the library does not load: no route to NumPy remains."""
    tab = tws.SampleTables(["bb01_ut01"], [77])
    with pytest.raises(ValueError, match="CUDA"):
        tws.window_sample(tab, 0, 1, 39, 39, "meta")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_build, "_libs", {})
        mp.setattr(cuda_build, "_nvcc", _no_nvcc)
        mp.setattr(cuda_build, "BUILD_DIR", tmp_path)
        with pytest.raises(RuntimeError, match="nvcc"):
            cuda_build.load(twc.SRC, twc.SIGNATURES)


@pytest.mark.parametrize("B,K,Kx,nw_max", [(64, 39, 54, 90), (45, 39, 39, 90),
                                           (1, 1, 1, 1), (13, 39, 54, twc.MAX_NW)])
def test_kernel_plan_within_limits(B, K, Kx, nw_max):
    """A thread a lane, every lane in the grid, each lane's bitmap within its
    MAX_NW bits of static shared memory, a block within an H100's limits;
    the plan raises for what the kernel does not take."""
    plan = twc.kernel_plan(B, K, Kx, nw_max)
    assert plan["lanes"] == 5 * B <= plan["grid"] * plan["threads"] < 5 * B + plan["threads"]
    assert plan["threads"] <= 1024 and plan["threads"] % 32 == 0
    assert 32 * plan["bitmap_words"] >= nw_max and plan["bitmap_words"] <= twc.MAX_NW // 32
    assert plan["smem_bytes"] == twc.MAX_NW // 8 * plan["threads"] <= 48 * 1024
    assert plan["max_nw"] == twc.MAX_NW < 10_000      # below NumPy's tail-shuffle branch
    assert plan["threads"] * 255 <= cuda_build.REGS_PER_SM
    for bad in ((B, 0, 0, nw_max), (B, K, K - 1, nw_max), (B, K, K + 1, nw_max),
                (B, K, Kx, twc.MAX_NW + 1), (B, K, Kx, -1)):
        with pytest.raises(ValueError):
            twc.kernel_plan(*bad)


class _FakeLib:
    def __init__(self, report):
        self.report = report

    def window_sample_layout(self, out):
        arr = (ctypes.c_int * len(twc.LAYOUT_FIELDS)).from_address(out)
        for i, k in enumerate(twc.LAYOUT_FIELDS):
            arr[i] = self.report[k]
        return 0


def test_launcher_raises_when_the_library_disagrees_with_the_plan():
    plan = twc.kernel_plan(1, 1, 1, 0)
    good = dict(threads=plan["threads"], max_nw=plan["max_nw"],
                smem_bytes=plan["smem_bytes"], registers=40, local_bytes=0, occupancy=7)
    assert twc.check_layout(_FakeLib(good)) == good
    for change in (dict(threads=128), dict(max_nw=1024), dict(smem_bytes=0),
                   dict(registers=1100), dict(occupancy=0)):
        with pytest.raises(RuntimeError, match="disagree"):
            twc.check_layout(_FakeLib(dict(good, **change)))


def test_runner_tables_and_the_stage_sample():
    """The runner's tables, in the stage's order: each recording's stem,
    nw and n_pair = min(audio windows, nw) (the comparison's paired count);
    the router's rows over them are the per-recording draw and
    `_paired_window_idx`; nothing of them stays on the runner after the
    stage."""
    import dataclasses

    from torch_tiny_data import N_RS_MAX, T_AUDIO_PAD, T_EEG_PAD, TinyDataset

    cfg = dataclasses.replace(DEFAULT_CONFIG, window_sec=0.2, fir_numtaps=101)
    ds = TinyDataset(cfg, n_subjects=2, n_windows={0: 6, 1: 7, 2: 5, 3: 6},
                     one_step_short_audio=(2,))
    store = build_from_dataset(ds, GOOD_ELECTRODES, T_EEG_PAD, T_AUDIO_PAD, device="cpu")
    r = tstudy.StudyRunner(store, cfg, eeg_batch=2, verbose=False, eeg_bank=True,
                           t_eeg_pad=T_EEG_PAD, t_audio_pad=T_AUDIO_PAD, n_rs_max=N_RS_MAX)
    all_idx, counts, K, _, _ = r._feature_index(None, None, None)
    tab = r._sample_tables(all_idx, counts)
    assert tab.stems == [ds.index[i][0].replace(".mat", "") for i in all_idx]
    np.testing.assert_array_equal(tab.nw, [counts[i] for i in all_idx])
    np.testing.assert_array_equal(
        tab.n_pair, [min(r._audio_window_count(i), counts[i]) for i in all_idx])
    assert (tab.n_pair < tab.nw).any()          # the short-audio recording
    Kx = K + K_CMP
    idx, mask = tws.window_sample(tab, 1, 3, K, Kx, "cpu")
    for b, i in enumerate(all_idx[1:4]):
        stem = ds.index[i][0].replace(".mat", "")
        for bd, band in enumerate(BAND_NAMES):
            ref = window_sample_indices(stem, band, counts[i], min(K, counts[i]),
                                        cfg.window_sampling, cfg.window_sample_seed)
            np.testing.assert_array_equal(idx[b, bd, :len(ref)].numpy(), ref)
            np.testing.assert_array_equal(
                idx[b, bd, K:].numpy(),
                tstudy._paired_window_idx(min(r._audio_window_count(i), counts[i]), K_CMP))
    # the stage on one subject without the bank (two batches of one)
    r = tstudy.StudyRunner(store, cfg, eeg_batch=1, verbose=False, eeg_bank=False,
                           t_eeg_pad=T_EEG_PAD, t_audio_pad=T_AUDIO_PAD, n_rs_max=N_RS_MAX)
    with timed_spans():
        r.compute_feature_dataset(batch_end=2)
    assert last_record()["spans"]["features_window_sample"]["calls"] == 2
    assert "window_sample.lanes" not in last_record()["counters"]   # none on the card
    assert not any(isinstance(v, tws.SampleTables) for v in vars(r).values())


@pytest.mark.cuda
def test_kernel_matches_numpy_on_card():
    """On a CUDA card: one launch a call, bit for bit NumPy's draw on the
    benchmark's 7,200 lanes, at the edges (nw, K, seed, message length),
    with bank columns and in "first" mode; the counter counts the lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda)")
    print(f"layout: {twc.layout_report()}")
    tab = _benchmark_tables()
    B = len(tab.stems)
    sets = [(tab, 39, 39), (tab, 39, 39 + K_CMP)]
    for K in (1, 15, 39):
        for seed in (0, 42, 2 ** 31):
            stems, nws = [], []
            for nw in (1, 2, K - 1, K, K + 1, 90, 200):
                for total in (55, 56, 64, 120):
                    if nw >= 1:
                        stems.append(_edge_stem(total, "delta", seed))
                        nws.append(nw)
            sets.append((tws.SampleTables(stems, nws, seed=seed), K, K))
    sets.append((tws.SampleTables(tab.stems, tab.nw, sampling="first"), 39, 39 + K_CMP))
    for t, K, Kx in sets:
        n = len(t.stems)
        before = twc.window_sample_cuda.launches
        with timed_spans():
            idx, mask = tws.window_sample(t, 0, n, K, Kx, "cuda")
        assert twc.window_sample_cuda.launches == before + 1
        assert last_record()["counters"]["window_sample.lanes"] == 5 * n
        ref_idx, ref_mask = tws.window_sample_plain(t, 0, n, K, Kx)
        np.testing.assert_array_equal(idx.cpu().numpy(), ref_idx)
        np.testing.assert_array_equal(mask.cpu().numpy(), ref_mask)
    idx, _ = tws.window_sample(tab, 100, 64, 39, 39, "cuda")     # a row offset
    np.testing.assert_array_equal(idx.cpu().numpy(),
                                  tws.window_sample_plain(tab, 100, 64, 39, 39)[0])
    assert B == 1440
