"""The readers of the port's spans and counter, and of the idle no span
explains, on hand-made contexts."""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from tda_eeg_audio_tpu_torch import runtime

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
SPAN_METRICS = [m["name"] for m in BENCH["per_layer"]
                if m["source"] == "program_span" and m["name"].startswith("span.")]


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "reader_" + name.replace(".", "_"), ROOT / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_span_reader_reads_its_span_or_nothing(name):
    read = _reader(name)
    span = name[len("span."):-len("_ms")]
    assert read(dict(spans_ms={span: 12.5, "other": 1.0})) == 12.5
    assert read(dict(spans_ms={"other": 1.0})) is None
    assert read({}) is None


def test_unattributed_idle_counts_only_harness_and_stage_labels():
    read = _reader("idle.unattributed_ms")
    gaps = [("stage.comparison", 0.1), ("comparison", 0.02), ("features", 0.01),
            ("control", 0.004), ("benchmark.profiled_job", 0.003), ("host", 0.002),
            ("comparison_rows", 0.5), ("features_window_sample", 0.4),
            ("control_stats", 0.03), ("stage_like_span", 0.2)]
    got = read(dict(trace=dict(idle_gaps=gaps)))
    assert got == pytest.approx(1e3 * (0.1 + 0.02 + 0.01 + 0.004 + 0.003 + 0.002))
    assert read(dict(trace=dict(idle_gaps=[("comparison_rows", 0.5)]))) == 0.0
    assert read({}) is None


def test_sinkhorn_roofline_needs_the_counter_and_device_time():
    read = _reader("sinkhorn_tiered.roofline_pct")
    ops = {"void sinkhorn_class_kernel<Shape<80, 8, 10, 16, 10, 1, 1, true> >(Args, Ladder, int)":
           0.75e-3,
           "(anonymous namespace)::bucket_kernel(Args, int*, int*)": 0.25e-3,
           "h1_reduce_kernel<256>(Args)": 5.0}
    with runtime.timed_spans():
        runtime.count("sinkhorn_tiered.flop", torch.tensor(33_500_000_000))
    # 33.5 GFLOP in 1 ms at 67 TFLOP/s: half the peak
    assert read(dict(trace=dict(device_ops=ops))) == pytest.approx(50.0)
    assert read(dict(trace=dict(device_ops={"h1_reduce_kernel<256>(Args)": 1.0}))) is None
    assert read({}) is None
    with runtime.timed_spans():
        pass                    # a job that counted nothing
    assert read(dict(trace=dict(device_ops=ops))) is None
