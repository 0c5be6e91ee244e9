"""The harness's own arithmetic on fixed inputs: the generator's
determinism, the union of device intervals and the idle gaps, the H1 byte
count from a job's windows."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.harness import generator, spec, trace, work
from benchmark.reference.study import Study

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(subjects=1, slow=1, fast=2, t_eeg_pad=5800, t_audio_pad=1058400,
            fs_eeg=250, fs_audio=44100)


def test_generator_is_deterministic_for_a_seed():
    a = generator.make_study(TINY, 2**31 + 11, "cpu")
    b = generator.make_study(TINY, 2**31 + 11, "cpu")
    c = generator.make_study(TINY, 12, "cpu")
    assert torch.equal(a["eeg"], b["eeg"]) and torch.equal(a["audio"], b["audio"])
    assert not torch.equal(a["eeg"], c["eeg"])
    # the seed changes the samples, never the sizes
    assert np.array_equal(a["ns_e"], c["ns_e"]) and np.array_equal(a["ns_a"], c["ns_a"])
    assert a["index"] == [("bb01_ut01.mat", "bb01", "slow"), ("bb01_ut01.mat", "bb01", "fast"),
                          ("bb01_ut02.mat", "bb01", "fast")]
    n = a["ns_e"][0]
    assert a["eeg"][0, :, n:].abs().max() == 0 and a["eeg"][0, :, :n].abs().max() > 0


def test_durations_are_the_reference_generators():
    durs, rates = generator.durations_and_rates(generator.dataset_index(45, 16, 16))
    slow = durs[rates == 3.0]
    fast = durs[rates == 5.5]
    assert len(slow) == len(fast) == 720
    assert 17.0 <= slow.min() and slow.max() <= 23.0
    assert 10.6 <= fast.min() and fast.max() <= 15.5


def test_union_counts_overlaps_once():
    iv = [(0.0, 10.0), (5.0, 15.0), (20.0, 25.0), (21.0, 22.0)]
    assert trace.union_length(iv) == 20.0
    assert trace.gaps(iv, 0.0, 30.0) == [(15.0, 5.0), (25.0, 5.0)]
    assert trace.union_length([]) == 0.0


def test_reduce_trace_busy_idle_and_labels():
    ev = [dict(ph="X", cat="kernel", name="k1", ts=100.0, dur=50.0),
          dict(ph="X", cat="gpu_memcpy", name="Memcpy HtoD", ts=120.0, dur=50.0),
          dict(ph="X", cat="kernel", name="k1", ts=400.0, dur=100.0),
          dict(ph="X", cat="user_annotation", name="stage.features", ts=0.0, dur=1000.0),
          dict(ph="X", cat="user_annotation", name="audio_takens", ts=160.0, dur=300.0)]
    r = trace.reduce_trace(ev, (0.0, 1000.0))
    assert r["busy_s"] == pytest.approx(170e-6)
    assert r["window_s"] == pytest.approx(1e-3)
    assert r["device_ops"]["k1"] == pytest.approx(150e-6)
    labels = dict(r["idle_gaps"])
    assert labels["stage.features"] == pytest.approx((100 + 500) * 1e-6)
    assert labels["audio_takens"] == pytest.approx(230e-6)


def test_h1_windows_and_roofline_bytes():
    bench = spec.load(ROOT)
    cell = spec.cell(bench, ROOT, "study45.full")
    st = generator.make_study(TINY, 3, "cpu")
    ref = Study(st, spec.reference_pipeline(cell))
    K = ref.feature_K()
    only_features = work.h1_windows(ref, ["features"])
    assert only_features == {47: 3 * 5 * K, 124: 0}
    full = work.h1_windows(ref, ["features", "comparison", "control"])
    assert full[47] >= only_features[47] and full[124] > 0
    spec_ = __import__("importlib.util").util.spec_from_file_location(
        "roof", ROOT / "metrics" / "h1.roofline_pct.py")
    mod = __import__("importlib.util").util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    tr = dict(device_ops={"void h1_reduce_kernel<256>(Args)": 1e-3,
                          "h1_phase1_kernel(Args)": 1e-3, "other": 5.0})
    got = mod.read(dict(trace=tr, h1_windows={47: 1000, 124: 10}))
    want = 100 * (1000 * (47 * 47 + 46) * 4 + 10 * (124 * 124 + 123) * 4) / 3.35e12 / 2e-3
    assert got == pytest.approx(want)
    assert mod.read(dict(trace=dict(device_ops={"other": 1.0}), h1_windows={47: 1})) is None


def test_traffic_files_name_their_configuration():
    for p in (ROOT / "workloads").glob("*.json"):
        t = json.loads(p.read_text())
        assert set(t) == {"config", "stages"}
