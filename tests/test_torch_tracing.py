"""The port's tracing (`runtime.span`, `timed_spans`, `count`,
`last_record`) on the CPU: the record's parents, calls and self time, the
counters' scope, no synchronisation outside a block, the runner's spans over
a tiny study, and the tiered Sinkhorn's work counter against the masks."""
import dataclasses
import io
import json
import time
import warnings

import numpy as np
import pytest
import torch

from tda_eeg_audio_tpu_torch import runtime
from tda_eeg_audio_tpu_torch.config import DEFAULT_CONFIG, GOOD_ELECTRODES
from tda_eeg_audio_tpu_torch.io.device_store import build_from_dataset
from tda_eeg_audio_tpu_torch.models import programs
from tda_eeg_audio_tpu_torch.models.study import StudyRunner
from tda_eeg_audio_tpu_torch.ops.wasserstein import ITERS, STEPS
from tda_eeg_audio_tpu_torch.utils import logging as tlog
from torch_tiny_data import N_RS_MAX, T_AUDIO_PAD, T_EEG_PAD, TinyDataset

torch.set_num_threads(1)
CPU = torch.device("cpu")
CUDA = torch.device("cuda")

# every span the runner's stages enter, and the parent of each
RUNNER_SPANS = {
    "features": None, "features_index": "features", "features_dispatch": "features",
    "features_window_sample": "features_dispatch",
    "eeg_feature_program": "features_dispatch", "features_rows": "features",
    "features_overflow_redo": "features_rows",
    "comparison": None, "mismatch_cache": "comparison",
    "comparison_dispatch": "comparison", "comparison_rows": "comparison",
    "comparison_redo": "comparison", "band_stats": "comparison",
    "results_write": "comparison", "control": None,
    "control_fused_rows": "control", "control_deviant_scan": "control",
    "control_stats": "control"}


def test_record_keeps_parent_calls_and_self_time():
    with runtime.timed_spans() as ms:
        with runtime.span("outer", CPU):
            for _ in range(2):
                with runtime.span("inner", CPU):
                    with runtime.span("leaf", CPU):
                        time.sleep(0.002)
            time.sleep(0.003)
    rec = runtime.last_record()["spans"]
    assert set(ms) == set(rec) == {"outer", "inner", "leaf"}
    assert {k: v["ms"] for k, v in rec.items()} == ms
    assert {k: (v["parent"], v["calls"]) for k, v in rec.items()} == {
        "outer": (None, 1), "inner": ("outer", 2), "leaf": ("inner", 2)}
    # self = own ms less what the direct children cover
    assert rec["outer"]["self_ms"] == pytest.approx(ms["outer"] - ms["inner"])
    assert rec["inner"]["self_ms"] == pytest.approx(ms["inner"] - ms["leaf"])
    assert rec["leaf"]["self_ms"] == pytest.approx(ms["leaf"])
    assert rec["outer"]["self_ms"] >= 3.0 and ms["leaf"] >= 4.0


def test_a_failed_span_leaves_the_record_consistent():
    with runtime.timed_spans() as ms:
        with runtime.span("outer", CPU):
            with pytest.raises(ValueError):
                with runtime.span("fails", CPU):
                    raise ValueError
            with runtime.span("after", CPU):
                pass
    rec = runtime.last_record()["spans"]
    assert "fails" not in ms and rec["after"]["parent"] == "outer"
    with pytest.raises(RuntimeError, match="nest"):
        with runtime.timed_spans():
            with runtime.timed_spans():
                pass


def test_counters_record_only_inside_a_block():
    runtime.count("probe", 5)
    with runtime.timed_spans() as ms:
        assert runtime.counting()
        runtime.count("probe", 2)
        runtime.count("probe", 3)
        runtime.count("on_device", torch.tensor(4, dtype=torch.int64))
        runtime.count("on_device", torch.tensor(6, dtype=torch.int64))
    runtime.count("probe", 7)
    assert not runtime.counting() and ms == {}
    counters = runtime.last_record()["counters"]
    assert counters == {"probe": 5, "on_device": 10}
    assert all(not isinstance(v, torch.Tensor) for v in counters.values())


@pytest.fixture
def no_sync(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: calls.append(a))
    return calls


def test_no_synchronisation_outside_a_block_with_the_logger_off(no_sync, monkeypatch):
    monkeypatch.setattr(tlog, "LOGGER", tlog.StructuredLogger())
    with runtime.span("x", CUDA) as t, runtime.logged_span("y", CUDA):
        pass
    assert no_sync == [] and t.ms is None
    with runtime.timed_spans():
        with runtime.span("x", CUDA):
            pass
    assert len(no_sync) == 2


def test_logged_span_times_itself_while_the_logger_is_on(no_sync, monkeypatch):
    sink = io.StringIO()
    monkeypatch.setattr(tlog, "LOGGER", tlog.StructuredLogger(sink))
    with runtime.span("plain", CUDA):
        pass
    assert no_sync == []
    with runtime.logged_span("part", CUDA, items=3) as fields:
        fields["n"] = 1
    assert len(no_sync) == 2
    ev = json.loads(sink.getvalue())
    assert (ev["event"], ev["stage"], ev["items"], ev["n"]) == ("stage", "part", 3, 1)
    assert ev["seconds"] >= 0.0


def test_host_waits_counts_the_syncs_of_its_block_but_not_the_spans(monkeypatch):
    """`runtime.host_waits` on a card whose synchronisations warn as
    `torch.cuda.set_sync_debug_mode("warn")` makes them (a stand-in here):
    it counts the block's own, leaves out a timed span's two, passes other
    warnings on and restores the mode; on the CPU it counts 0; outside a
    block it counts nothing."""
    mode = {"now": 0}
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: mode["now"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: mode.__setitem__("now", {"warn": 1}.get(m, m)))

    def synchronize(*a, **k):
        if mode["now"]:
            warnings.warn(runtime.SYNC_WARNING)

    monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
    with runtime.timed_spans():
        with runtime.host_waits("w", CUDA):
            torch.cuda.synchronize()
            with runtime.span("x", CUDA):
                torch.cuda.synchronize()
        with pytest.warns(UserWarning, match="another warning"):
            with runtime.host_waits("other", CUDA):
                warnings.warn("another warning")
        with runtime.host_waits("cpu", CPU):
            pass
    assert runtime.last_record()["counters"] == {"w": 2, "other": 0, "cpu": 0}
    assert mode["now"] == 0
    with runtime.host_waits("w", CUDA):
        torch.cuda.synchronize()
    assert mode["now"] == 0


@pytest.fixture(scope="module")
def traced_study(tmp_path_factory):
    """One subject's slow and fast recording through the features, the
    comparison and the control stages under one timed block."""
    cfg = dataclasses.replace(DEFAULT_CONFIG, window_sec=0.2, fir_numtaps=101)
    ds = TinyDataset(cfg, n_subjects=1, n_windows={0: 6, 1: 7})
    store = build_from_dataset(ds, GOOD_ELECTRODES, T_EEG_PAD, T_AUDIO_PAD, device="cpu")
    r = StudyRunner(store, cfg, eeg_batch=4, verbose=False, t_eeg_pad=T_EEG_PAD,
                    t_audio_pad=T_AUDIO_PAD, n_rs_max=N_RS_MAX,
                    results_dir=tmp_path_factory.mktemp("results"))
    with runtime.timed_spans() as ms:
        r.compute_feature_dataset()
        r.run_comparison(n_permutations=10)
        r.run_control()
    return ms, runtime.last_record()


def test_runner_records_every_span_of_its_stages(traced_study):
    ms, rec = traced_study
    spans = rec["spans"]
    assert set(RUNNER_SPANS) <= set(ms)
    assert {k: spans[k]["parent"] for k in RUNNER_SPANS} == RUNNER_SPANS
    # one batch: each span inside the batch loop is entered once a batch
    assert spans["features_window_sample"]["calls"] == 1
    assert spans["eeg_feature_program"]["calls"] == 1
    # the comparison's and the control's result files
    assert spans["results_write"]["calls"] == 2
    # (results_write's first call is the comparison's: a name's parent is
    # its first call's)
    for name in ("features", "features_dispatch", "features_rows"):
        children = sum(v["ms"] for v in spans.values() if v["parent"] == name)
        assert spans[name]["self_ms"] == pytest.approx(ms[name] - children)
    c = rec["counters"]
    assert c["sinkhorn_tiered.pairs"] > 0 and c["sinkhorn_tiered.flop"] > 0


def test_sinkhorn_flop_counter_equals_the_masks_count():
    rng = np.random.default_rng(7)
    N, K = 6, 16
    n1 = np.array([0, 1, 5, 16, 3, 0])
    n2 = np.array([4, 0, 16, 9, 3, 0])
    m1 = np.arange(K)[None, :] < n1[:, None]
    m2 = np.zeros((N, K), bool)
    for p in range(N):          # the second side's bars anywhere in the row
        m2[p, rng.choice(K, n2[p], replace=False)] = True
    b1, b2 = rng.uniform(0, 1, (2, N, K)).astype(np.float32)
    d1 = b1 + rng.uniform(0.01, 1, (N, K)).astype(np.float32)
    d2 = b2 + rng.uniform(0.01, 1, (N, K)).astype(np.float32)
    args = [torch.as_tensor(x) for x in (b1, d1, m1, b2, d2, m2)]
    programs._wass_sinkhorn_tiered(*args)
    with runtime.timed_spans():
        programs._wass_sinkhorn_tiered(*args)
    # an empty side is the one [[0, 0]] bar
    S = np.maximum(n1, 1) + np.maximum(n2, 1)
    assert runtime.last_record()["counters"] == {
        "sinkhorn_tiered.pairs": N,
        "sinkhorn_tiered.flop": int(sum(4 * s * s * STEPS * ITERS for s in S))}
