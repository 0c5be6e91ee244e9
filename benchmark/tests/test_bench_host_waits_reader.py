"""The reader of the port's counter `comparison_dispatch.host_waits`, on
hand-made records: the counter's value, 0 included, or nothing."""

import importlib.util
from pathlib import Path

import torch

from tda_eeg_audio_tpu_torch import runtime

ROOT = Path(__file__).resolve().parents[1]


def _read():
    spec = importlib.util.spec_from_file_location(
        "reader_dispatch_host_waits", ROOT / "metrics" / "dispatch.host_waits.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_host_waits_reads_the_counter_zero_included_or_nothing():
    read = _read()
    with runtime.timed_spans():
        runtime.count("comparison_dispatch.host_waits", 13)
        runtime.count("comparison_dispatch.host_waits", torch.tensor(1))
    assert read({}) == 14.0
    with runtime.timed_spans():
        runtime.count("comparison_dispatch.host_waits", 0)
    assert read({}) == 0.0
    with runtime.timed_spans():
        runtime.count("sinkhorn_tiered.pairs", 5)     # a job without the counter
    assert read({}) is None
