"""The port's `StudyRunner` as a whole against the JAX `StudyRunner` on the
CPU, on the same recordings: a tiny in-memory dataset (4 subjects × {slow,
fast}, recordings of 1.0–1.4 s, one of 0.4 s whose audio is one window
shorter than its EEG, one that fails to load) staged once with the
reference's `build_from_dataset` and carried over with `store_from_numpy`;
0.2 s windows, 101 taps, pads 600 / 97,020 / 560, eeg_batch 4, eeg_bank on.

Tolerances: X rtol 1e-4 / atol 1e-5; detailed rows and band statistics:
integers, strings and flags exact, floats rtol 1e-4 / atol 1e-5
(wasserstein_h1, w_matched, w_mismatched and the statistics made of them
rtol 2e-4, the tiered Sinkhorn's parity tolerance; Cohen's d, a mean over
a standard deviation of differences of such values, atol 1e-3 besides:
worst observed 4.2e-5).  Worst error / tolerance observed (pytest -rP):
X 0.101, wasserstein_h1 / w_mismatched 0.164, Spearman p 0.235, control
w_matched 0.061, everything else below 0.01.  Four subjects keep the file's time down (the CPU
runs the plain reduction); three complete slow/fast pairs are fewer than the
5 the band statistics need, so those are held against the reference on
synthetic rows of 8 subjects, where both runners are also fed the same sign
draws and `wass_h1_perm_p` is compared too."""
import contextlib
import csv
import dataclasses
import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tda_eeg_audio_tpu.config import (DEFAULT_CONFIG as JAX_CONFIG,
                                      GOOD_ELECTRODES)
from tda_eeg_audio_tpu.io import device_store as jstore
from tda_eeg_audio_tpu.models import study as jstudy
from tda_eeg_audio_tpu_torch.convert import config_from_jax, store_from_numpy
from tda_eeg_audio_tpu_torch.models import programs as tprog
from tda_eeg_audio_tpu_torch.models import study as tstudy
from tda_eeg_audio_tpu_torch.ops import signal as tsig
from tda_eeg_audio_tpu_torch.runtime import device_constant
from tda_eeg_audio_tpu_torch.models.homology_exec import run_tda
from torch_tiny_data import N_RS_MAX, T_AUDIO_PAD, T_EEG_PAD, TinyDataset

# one intra-op thread fixes the float32 summation order of the correlation
# matmul (see tests/test_torch_slice.py), so the comparison is deterministic
torch.set_num_threads(1)

FAILS, SHORT = 5, 2
H1_KEYS = ("wasserstein_h1", "w_mismatched", "w_matched", "wass_h1_slow",
           "wass_h1_fast", "wass_h1_p", "wass_h1_cohens_d", "wass_h1_p_fdr",
           "p", "cohens_d", "p_fdr")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both runners' full study, each run once."""
    jcfg = dataclasses.replace(JAX_CONFIG, window_sec=0.2, fir_numtaps=101,
                               wasserstein_backend="sinkhorn")
    tcfg = config_from_jax(dataclasses.asdict(jcfg))
    ds = TinyDataset(jcfg, n_windows={SHORT: 5}, one_step_short_audio=(SHORT,),
                     fails=(FAILS,))
    jdir, tdir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("torch")
    n_win_max = (T_EEG_PAD - jcfg.win_samples) // jcfg.step_samples + 1

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstudy, "T_EEG_PAD", T_EEG_PAD)
        mp.setattr(jstudy, "T_AUDIO_PAD", T_AUDIO_PAD)
        mp.setattr(jstudy, "N_RS_MAX", N_RS_MAX)
        mp.setattr(jstudy, "N_WIN_MAX", n_win_max)
        jst = jstore.build_from_dataset(ds, GOOD_ELECTRODES, T_EEG_PAD, T_AUDIO_PAD)
        jst.index = ds.index
        jr = jstudy.StudyRunner(jst, jcfg, eeg_batch=4, tda_chunk=64,
                                results_dir=jdir, verbose=False, mesh=None,
                                eeg_bank=True)
        jout = dict(features=jr.compute_feature_dataset(),
                    comparison=jr.run_comparison(n_permutations=100),
                    control=jr.run_control())

    tst = store_from_numpy(np.asarray(jst.eeg), np.asarray(jst.audio), jst.ns_e,
                           jst.ns_a, jst.metas, ds.index, device="cpu")
    tr = tstudy.StudyRunner(tst, tcfg, eeg_batch=4, results_dir=tdir,
                            verbose=False, eeg_bank=True,
                            feature_na_max=jr.feature_na_max,
                            t_eeg_pad=T_EEG_PAD, t_audio_pad=T_AUDIO_PAD,
                            n_rs_max=N_RS_MAX)
    redone0 = run_tda.redone
    # the diagram pairs every `_wass_chunks` call receives
    wass_calls, wass_chunks = [], tstudy.StudyRunner._wass_chunks

    def capture(self, *pairs):
        wass_calls.append([x.clone() for x in pairs])
        return wass_chunks(self, *pairs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tstudy.StudyRunner, "_wass_chunks", capture)
        tout = dict(features=tr.compute_feature_dataset(),
                    comparison=tr.run_comparison(n_permutations=100),
                    control=tr.run_control())
    return dict(jr=jr, tr=tr, j=jout, t=tout, jdir=jdir, tdir=tdir, ds=ds,
                windows_redone=run_tda.redone - redone0, wass_calls=wass_calls)


WORST = {}      # largest |got − want| / allowed seen per kind of value


def _same(got, want, path=""):
    """Recursive comparison with the module's tolerances."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, (float, np.floating)):
        key = path.rsplit(".", 1)[-1]
        rtol = 2e-4 if key in H1_KEYS else 1e-4
        atol = 1e-3 if key.endswith("cohens_d") else 1e-5
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   equal_nan=True, err_msg=path)
        if np.isfinite(want):
            kind = path.split(".")[0].split("[")[0] + ":" + key
            WORST[kind] = max(WORST.get(kind, 0.0),
                              abs(got - want) / (atol + rtol * abs(want)))
    else:
        assert got == want, (path, got, want)


def test_feature_dataset_matches_reference(runs):
    Xt, yt, st, ft, mt = runs["t"]["features"]
    Xj, yj, sj, fj, mj = runs["j"]["features"]
    assert Xt.shape == Xj.shape == (7, 220) and np.isfinite(Xt).all()
    np.testing.assert_allclose(Xt, Xj, rtol=1e-4, atol=1e-5)
    print("X: worst error / tolerance "
          f"{float((np.abs(Xt - Xj) / (1e-5 + 1e-4 * np.abs(Xj))).max()):.3f}")
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_array_equal(st, sj)
    assert ft == fj
    assert mt == mj
    assert mt["K"] == 5 and mt["failed_files"] == ["bb03_ut01.mat"]
    assert len(mt["file_metadata"]) == 7


def test_failed_recording_is_dropped_everywhere(runs):
    fn, subj, cond = runs["ds"].index[FAILS]
    tr = runs["tr"]
    assert [f for f, _ in tr.failed_files] == [fn]
    rows = runs["t"]["comparison"]["detailed_rows"]
    assert not [r for r in rows if (r["filename"], r["condition"]) == (fn, cond)]
    assert len(rows) == 7 * 5
    # its subject has no slow/fast pair left
    assert all(b["n_subjects"] == 3
               for b in runs["t"]["comparison"]["band_results"].values())


def test_bank_path_served_every_batch(runs):
    tr, jr = runs["tr"], runs["jr"]
    assert tr._bank_served == jr._bank_served == 2
    assert tr._bank_fallback == jr._bank_fallback == 0


def test_detailed_rows_match_reference(runs):
    rows_t = runs["t"]["comparison"]["detailed_rows"]
    rows_j = runs["j"]["comparison"]["detailed_rows"]
    _same(rows_t, rows_j, "rows")
    assert {r["n_windows"] for r in rows_t} == {4, 15}


def test_band_results_match_reference(runs):
    ct, cj = runs["t"]["comparison"], runs["j"]["comparison"]
    _same(ct["band_results"], cj["band_results"], "band_results")
    for k in set(cj) - {"band_results", "detailed_rows"}:
        assert ct[k] == cj[k], k
    assert ct["n_recordings"] == 7 and ct["n_subjects"] == 4
    for b in ct["band_results"].values():   # < 5 subjects: FDR entries only
        assert b["wass_h1_p_fdr"] == 1.0 and not b["wass_h1_sig_fdr"]


def test_control_matches_reference_with_exact_redo(runs):
    _same(runs["t"]["control"], runs["j"]["control"], "control")
    assert runs["tr"].redo_counts["control_deviants"] == 1
    for b in runs["t"]["control"].values():
        assert b["n"] == 3 and b["status"] == "insufficient"
        assert set(b["by_condition"]) == {"slow", "fast"}
    assert runs["windows_redone"] == 0


def test_wass_chunks_receive_no_visible_nonfinite_birth(runs):
    """Every diagram pair the study hands `_wass_chunks` (the control's
    exact redo of the short recording) has finite births and deaths in its
    valid slots and (0, 0) in its masked ones."""
    assert runs["wass_calls"]
    for b1, d1, m1, b2, d2, m2 in runs["wass_calls"]:
        for b, d, m in ((b1, d1, m1), (b2, d2, m2)):
            assert torch.isfinite(b[m]).all() and torch.isfinite(d[m]).all()
            assert (b[~m] == 0).all() and (d[~m] == 0).all()


def test_artifacts_have_the_reference_schemas(runs):
    for name in ("eeg_audio_tda_comparison.json", "matched_vs_mismatched.json"):
        jt = json.loads((runs["tdir"] / name).read_text())
        jj = json.loads((runs["jdir"] / name).read_text())
        assert set(jt) == set(jj), name
        for band in jt.get("band_results", {}):
            assert set(jt["band_results"][band]) == set(jj["band_results"][band])
    name = "eeg_audio_tda_detailed.csv"
    with open(runs["tdir"] / name) as ft, open(runs["jdir"] / name) as fj:
        rt, rj = list(csv.reader(ft)), list(csv.reader(fj))
    assert rt[0] == rj[0] and len(rt) == len(rj) == 36
    # the comparison's figures, under the reference's names
    figs = sorted(str(p.relative_to(runs["tdir"])) for p in runs["tdir"].rglob("*.png"))
    assert figs == sorted(str(p.relative_to(runs["jdir"]))
                          for p in runs["jdir"].rglob("*.png"))
    assert len(figs) == 4


def test_runner_refuses_a_host_dataset(runs):
    """The runner reads a `DeviceStore` only: a host dataset is refused
    with a TypeError that names `build_from_dataset`; the store's failed
    file is the runner's one failed file."""
    ds, tr = runs["ds"], runs["tr"]
    with pytest.raises(TypeError, match="build_from_dataset"):
        tstudy.StudyRunner(ds, tr.cfg, eeg_batch=4, verbose=False,
                           t_eeg_pad=T_EEG_PAD, t_audio_pad=T_AUDIO_PAD,
                           n_rs_max=N_RS_MAX, device="cpu")
    assert [f for f, _ in tr.failed_files] == [ds.index[FAILS][0]]
    assert [m["failed"] for m in tr.store.batch([0, SHORT, FAILS])[4]] == \
        [False, False, True]
    # padding rows of the store: zeroed, one empty second long
    e, a, ne, na, m = tr.store.batch([1], pad_to=3)
    assert e.shape[0] == a.shape[0] == 3 and len(m) == 1
    assert not bool(e[1:].any()) and not bool(a[1:].any())
    assert ne.tolist()[1:] == [250, 250] and na.tolist()[1:] == [44100, 44100]
    # the exact backend is a staged path now; unknown backends are refused
    exact = tstudy.StudyRunner(tr.store, dataclasses.replace(
        tr.cfg, wasserstein_backend="host_exact"), t_eeg_pad=T_EEG_PAD,
        t_audio_pad=T_AUDIO_PAD)
    assert exact.on_device and not exact._fused
    for bad in (dict(wasserstein_backend="pot"), dict(homology_backend="pallas")):
        with pytest.raises(ValueError):
            tstudy.StudyRunner(tr.store, dataclasses.replace(tr.cfg, **bad),
                               t_eeg_pad=T_EEG_PAD, t_audio_pad=T_AUDIO_PAD)


def _synthetic_rows(n_subjects=8, seed=3):
    """Comparison and control rows of 8 subjects × {slow, fast} × 2
    recordings, values from a seed; one subject lacks its fast recordings in
    one band and one control value is NaN."""
    rng = np.random.default_rng(seed)
    cmp_rows, ctl_rows = [], []
    for s in range(n_subjects):
        for cond in ("slow", "fast"):
            for u in range(2):
                for band in tstudy.BAND_NAMES:
                    if s == 7 and cond == "fast" and band == "gamma":
                        continue
                    shift = 0.05 if cond == "slow" else 0.0
                    base = dict(filename=f"bb{s:02d}_ut{u:02d}.mat",
                                condition=cond, subject=f"bb{s:02d}", band=band)
                    cmp_rows.append(dict(
                        base, wasserstein_h0=float(rng.uniform(4, 6)),
                        wasserstein_h1=float(rng.uniform(0.4, 0.6) + shift),
                        n_windows=15, tau=int(rng.integers(1, 9)),
                        corr_mean_persistence_r=float(rng.uniform(-1, 1))))
                    wm = float(rng.uniform(0.4, 0.6))
                    ctl_rows.append(dict(
                        base, w_matched=wm,
                        w_mismatched=float(np.nan if (s, u, band) == (1, 0, "theta")
                                           else wm + rng.normal(0.02, 0.03))))
    return cmp_rows, ctl_rows


def test_stats_on_synthetic_rows_match_reference(runs):
    """≥ 5 subjects in every band: both runners' `_comparison_stats` and
    `_control_stats` on one set of rows, the port fed the reference's sign
    draws, so the permutation p-value is compared too."""
    cmp_rows, ctl_rows = _synthetic_rows()
    jr, tr = runs["jr"], runs["tr"]
    jr2 = jstudy.StudyRunner.__new__(jstudy.StudyRunner)
    jr2.__dict__.update(jr.__dict__, results_dir=None)
    tr2 = tstudy.StudyRunner.__new__(tstudy.StudyRunner)
    tr2.__dict__.update(tr.__dict__, results_dir=None)
    n_perm = 200
    want = jr2._comparison_stats([dict(r) for r in cmp_rows], n_perm)
    _, sub = jax.random.split(jax.random.key(42))
    signs = np.array(jax.random.rademacher(sub, (n_perm, 5, 8), dtype=jnp.float32))
    got = tr2._comparison_stats([dict(r) for r in cmp_rows], n_perm, signs=signs)
    _same(got["band_results"], want["band_results"], "band_results")
    assert got["band_results"]["gamma"]["n_subjects"] == 7
    assert all("wass_h1_perm_p" in b for b in got["band_results"].values())
    _same(tr2._control_stats(ctl_rows), jr2._control_stats(ctl_rows), "control")
    print("worst error / tolerance by kind: "
          + json.dumps({k: round(v, 3) for k, v in sorted(WORST.items())}))


# ─────────────────────────────────────────────────────────────────────────────
# The comparison loop's per-stage arrays and constants
# ─────────────────────────────────────────────────────────────────────────────


def _old_bank_gather_idx(runner, idxs, metas):
    """The flat bank indices of a batch as the loop built them batch by
    batch, or None where the bank cannot serve the batch."""
    bk = runner._eeg_bank
    cols = bk["K_base"] + np.arange(tstudy.K_CMP, dtype=np.int64)
    gidx = np.zeros((len(idxs), tstudy.N_BANDS, tstudy.K_CMP), np.int64)
    for b, meta in enumerate(metas):
        if meta.get("failed"):
            continue
        row = bk["slot"].get(idxs[b])
        if row is None:
            return None
        gidx[b] = (row * tstudy.N_BANDS + np.arange(tstudy.N_BANDS))[:, None] * bk["K"] + cols
    return gidx.reshape(-1)


def _old_per_batch_arrays(runner, mis_idx, mis_slot, bank):
    """Each (batch, shard)'s arrays as the comparison loop built them in
    the batch, before they were computed once a stage."""
    zero_slot = bank["b"].shape[0] - 1
    N, out = len(runner.store), []
    for b0 in range(0, N, runner.eeg_batch):
        idxs = list(range(b0, min(b0 + runner.eeg_batch, N)))
        _, _, ns_e_b, ns_a_b, metas_b = runner.store.batch(idxs)
        gidx = (_old_bank_gather_idx(runner, idxs, metas_b)
                if runner._eeg_bank is not None else None)
        for dev, part, sl in runner._shards(idxs):
            B = len(part)
            slots = np.full(B, zero_slot, np.int64)
            mis_n_win = np.zeros(B, np.int64)
            mis_degen = np.zeros((B, tstudy.N_BANDS, tstudy.K_CMP), bool)
            has_mis = np.zeros(B, bool)
            for b, i in enumerate(part):
                fn, subj, cond = runner.store.index[i]
                u = mis_slot.get(mis_idx.get((subj, cond)))
                if u is not None:
                    has_mis[b], slots[b] = True, u
                    mis_n_win[b], mis_degen[b] = bank["n_win"][u], bank["degen"][u]
            out.append(dict(
                b0=b0, sl=sl, idxs=idxs, metas=metas_b, served=gidx is not None,
                slots=slots, has_mis=has_mis, mis_n_win=mis_n_win, mis_degen=mis_degen,
                ns_e=ns_e_b[sl], ns_a=ns_a_b[sl],
                gidx=None if gidx is None else gidx.reshape(len(idxs), -1)[sl].reshape(-1)))
    return out


def _planning_runner(tr, case):
    """A copy of the finished runner `tr` set up for `case`, with its
    mismatch partners and a made-up mismatch bank (its rows' window counts
    and degenerate flags from a seed)."""
    r = tstudy.StudyRunner.__new__(tstudy.StudyRunner)
    r.__dict__.update(tr.__dict__)
    if case == "ragged":            # 8 recordings in batches of 3, 3, 2
        r.eeg_batch = 3
    elif case == "bank_fallback":   # a live recording without a bank row
        bk = dict(r._eeg_bank)
        bk["slot"] = {i: row for i, row in bk["slot"].items() if i != 2}
        r._eeg_bank = bk
    elif case == "mesh":            # two shards of 2 a batch of 4
        r.mesh = [torch.device("cpu"), torch.device("cpu")]
    elif case == "no_bank":
        r._eeg_bank = None
    mis_idx = r._mismatch_index()
    mis_list = sorted(set(mis_idx.values()))
    # the failed recording has no row, as in `_mismatch_diagram_cache`
    mis_slot = {i: u for u, i in enumerate(mis_list) if i != FAILS}
    rng = np.random.default_rng(7)
    U = len(mis_list)
    bank = dict(b=torch.zeros((U + 1, 1, 1)),
                n_win=rng.integers(0, 20, U),
                degen=rng.random((U, tstudy.N_BANDS, tstudy.K_CMP)) < 0.3)
    return r, mis_idx, mis_slot, bank


@pytest.mark.parametrize("case", ["failed", "ragged", "bank_fallback", "mesh", "no_bank"])
def test_comparison_plan_sliced_per_batch_equals_the_per_batch_arrays(runs, case):
    """The comparison loop's arrays computed once a stage
    (`_comparison_plan`), uploaded once a device (`_plan_on`) and sliced
    per batch and shard as the loop slices them, equal what the loop built
    in each batch: slots, has_mis, mis_n_win, mis_degen, the lengths, the
    bank's gidx and the batch's fallback decision.  "failed": batches of
    4, the second holding the failed recording and served by the bank."""
    r, mis_idx, mis_slot, bank = _planning_runner(runs["tr"], case)
    plan = r._comparison_plan(mis_idx, mis_slot, bank)
    old = _old_per_batch_arrays(r, mis_idx, mis_slot, bank)
    assert len(old) == {"mesh": 4, "ragged": 3}.get(case, 2)
    served = []
    for o in old:
        dev = r.device if r.mesh is None else r.mesh[0]
        on = r._plan_on(plan, dev)
        rows = slice(o["b0"] + o["sl"].start, o["b0"] + o["sl"].stop)
        assert r._bank_serves(plan, o["idxs"], o["metas"]) == o["served"]
        served.append(o["served"])
        np.testing.assert_array_equal(plan["has_mis"][rows], o["has_mis"])
        np.testing.assert_array_equal(plan["mis_degen"][rows], o["mis_degen"])
        for k in ("slots", "mis_n_win", "ns_e", "ns_a", "mis_degen"):
            assert on[k].device.type == dev.type
            np.testing.assert_array_equal(on[k][rows].numpy(), o[k], err_msg=k)
        assert on["mis_degen"].dtype == torch.bool
        if o["served"]:
            np.testing.assert_array_equal(on["gidx"][rows].reshape(-1).numpy(), o["gidx"])
    assert any(p.any() for p in (plan["has_mis"], plan["mis_degen"]))
    want = {"bank_fallback": [False, True], "no_bank": [False, False],
            "mesh": [True, True, True, True], "ragged": [True, True, True]}
    assert served == want.get(case, [True, True])
    if case == "no_bank":
        assert "gidx" not in plan and "gidx" not in r._plan_on(plan, r.device)


def test_store_batch_takes_a_contiguous_run_by_a_slice(runs, monkeypatch):
    """A contiguous run of recordings is taken from the store by a slice,
    with nothing uploaded; other indices the old way; both the same rows."""
    st = runs["tr"].store
    uploads = []
    as_tensor = torch.as_tensor

    def spy(x, *a, **kw):
        uploads.append(np.asarray(x).copy())
        return as_tensor(x, *a, **kw)

    monkeypatch.setattr(torch, "as_tensor", spy)
    e1, a1, ne1, na1, m1 = st.batch([2, 3, 4], pad_to=4)
    assert not uploads
    e2, a2, ne2, na2, m2 = st.batch([4, 2, 3], pad_to=4)
    assert len(uploads) == 1
    monkeypatch.undo()
    for x, y in ((e1, e2), (a1, a2)):
        assert torch.equal(x[:3], y[[1, 2, 0]]) and not x[3].any()
    assert torch.equal(e1[:3], st.eeg[2:5]) and torch.equal(a1[:3], st.audio[2:5])
    np.testing.assert_array_equal(ne1[:3], st.ns_e[2:5])
    np.testing.assert_array_equal(na1[:3], st.ns_a[2:5])
    assert [m["filename"] for m in m1] == [st.metas[i]["filename"] for i in (2, 3, 4)]


CONSTANTS = {
    "fir_bank": (tsig.design_band_fir_bank, torch.float32, (250, 4, 101)),
    "envelope_lowpass": (tsig.design_envelope_lowpass, torch.float32, (250,)),
    "hilbert": (tsig.design_hilbert_fir, torch.float32, ()),
    "resample_matrix": (tsig.resample_poly_matrix, torch.float32, (250, 44100)),
    "h1_feature_columns": (np.asarray, torch.int64, (tprog.H1_FEAT_COLS,)),
}


@pytest.mark.parametrize("name", sorted(CONSTANTS))
def test_device_constant_is_one_object_per_device_and_parameters(name):
    """`runtime.device_constant` returns one tensor per (design, device,
    dtype, parameters), equal to the NumPy design; other parameters give
    another.  The resample matrix gives `resample_poly_device` the same
    bits as the matrix it builds itself."""
    design, dtype, args = CONSTANTS[name]
    cpu = torch.device("cpu")
    a = device_constant(design, cpu, dtype, *args)
    assert device_constant(design, torch.device("cpu"), dtype, *args) is a
    assert a.dtype == dtype and a.device == cpu
    assert torch.equal(a, torch.as_tensor(np.asarray(design(*args)), dtype=dtype))
    if name == "fir_bank":
        b = device_constant(design, cpu, dtype, 250, 4, 1537)
        assert b is not a and b.shape == (5, 1537)
    if name == "resample_matrix":
        h, up, down = tsig.design_resample_poly_filter(*args)
        x = torch.as_tensor(np.random.default_rng(0).standard_normal((2, 44100)),
                            dtype=torch.float32)
        n_in = torch.tensor([44100, 30000])
        y0, n0 = tsig.resample_poly_device(x, n_in, 250, h, up, down)
        y1, n1 = tsig.resample_poly_device(x, n_in, 250, h, up, down, a)
        assert torch.equal(y0, y1) and torch.equal(n0, n1)


TINY_CFG = config_from_jax(dataclasses.asdict(dataclasses.replace(
    JAX_CONFIG, window_sec=0.2, fir_numtaps=101, wasserstein_backend="sinkhorn")))
_TINY, _TINY_CPU_ROWS = {}, {}


def _tiny_runner(device, bank, mesh=None):
    """A runner over the tiny dataset (8 recordings, one failing) staged on
    `device` once, batches of 4; with the bank the features stage has run."""
    from tda_eeg_audio_tpu_torch.io.device_store import build_from_dataset

    if device not in _TINY:
        _TINY[device] = build_from_dataset(
            TinyDataset(TINY_CFG, n_windows={SHORT: 5}, fails=(FAILS,)),
            GOOD_ELECTRODES, T_EEG_PAD, T_AUDIO_PAD, device=device)
    r = tstudy.StudyRunner(_TINY[device], TINY_CFG, eeg_batch=4, verbose=False,
                           eeg_bank=bank, t_eeg_pad=T_EEG_PAD, t_audio_pad=T_AUDIO_PAD,
                           n_rs_max=N_RS_MAX, mesh=mesh)
    if bank:
        r.compute_feature_dataset()
    return r


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["bank", "in_call", "mesh"])
def test_comparison_loop_never_waits_for_the_card(path, monkeypatch):
    """On a CUDA card, the comparison's batch loop of the bank path, the
    in-call path (`eeg_bank` off) and a two-shard mesh on one card: the
    counter `comparison_dispatch.host_waits` reads 0 in a `timed_spans()`
    block, a run under `torch.cuda.set_sync_debug_mode("error")` from the
    plan's upload to the end of the loop raises nothing, and its rows equal
    the CPU runner's within this file's row tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda)")
    from tda_eeg_audio_tpu_torch import runtime

    bank = path != "in_call"
    mesh = [torch.device("cuda", 0)] * 2 if path == "mesh" else None
    _tiny_runner("cuda", bank, mesh)._fused_rows()      # libraries, constants
    with runtime.timed_spans():
        _tiny_runner("cuda", bank, mesh)._fused_rows()
    assert runtime.last_record()["counters"]["comparison_dispatch.host_waits"] == 0

    @contextlib.contextmanager
    def strict(name, device):
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)

    r = _tiny_runner("cuda", bank, mesh)
    monkeypatch.setattr(tstudy, "host_waits", strict)
    rows = r._fused_rows()
    monkeypatch.undo()
    assert r._bank_served == (2 if bank else 0)
    if bank not in _TINY_CPU_ROWS:
        _TINY_CPU_ROWS[bank] = _tiny_runner("cpu", bank)._fused_rows()
    _same(rows, _TINY_CPU_ROWS[bank], f"card_{path}")
