"""`bench_torch.py --eeg-throughput`'s pass on the CPU at a tiny size
(2 recordings × 5 bands × 2 windows, full T_pad 5800): the line's keys and
counts, its aggregates equal to `eeg_feature_program` run directly on the
same EEG (bit for bit: the same calls on the same inputs), the EEG a
function of the seed alone, and no reading without a card.  The program's
parity with JAX is tests/test_torch_slice.py::test_feature_program_matches_jax."""
import pytest
import torch

import bench_torch
from tda_eeg_audio_tpu_torch.config import DEFAULT_CONFIG
from tda_eeg_audio_tpu_torch.models.programs import eeg_feature_program

torch.set_num_threads(1)

LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "detail", "n_windows",
             "phase1_launches", "kernel_launches", "overflow_recordings",
             "peak_device_gb", "device", "card", "torch", "ok"}


@pytest.fixture(scope="module")
def run():
    return bench_torch.eeg_throughput(recordings=2, windows=2, repeats=1,
                                      device="cpu")


def test_line_keys_and_counts(run):
    line, last = run
    assert set(line) == LINE_KEYS
    assert line["metric"] == "eeg_windows_per_sec_per_chip"
    assert set(line["detail"]) >= {"batch", "K", "warm_s", "host_wps"}
    assert (line["detail"]["batch"], line["detail"]["K"]) == (2, 2)
    assert line["n_windows"] == 2 * 5 * 2
    assert line["detail"]["host_windows"] == 20
    # on the CPU the wrappers take the plain path: no launch of either
    assert line["phase1_launches"] == line["kernel_launches"] == 0
    assert line["ok"] and line["value"] > 0 and line["vs_baseline"] > 0
    assert line["device"] == "cpu" and line["card"] is None
    assert last["eeg"].shape == (2, 47, bench_torch.T_PAD)
    assert last["agg"].shape == (2, 5, 2, 11, 2)


def test_agg_equals_the_program_on_the_same_eeg(run):
    _, last = run
    agg, ovf = eeg_feature_program(last["eeg"], last["ns"], last["use_idx"],
                                   last["use_mask"], DEFAULT_CONFIG, K=2,
                                   device="cpu")
    assert torch.equal(agg, last["agg"]) and torch.equal(ovf, last["ovf"])
    # distinct windows per (recording, band), all inside the recording
    idx = last["use_idx"]
    assert all(len(set(row.tolist())) == 2 for row in idx.reshape(-1, 2))
    n_win = (bench_torch.T_PAD - 100 - DEFAULT_CONFIG.win_samples) \
        // DEFAULT_CONFIG.step_samples + 1
    assert int(idx.max()) < n_win


def test_the_eeg_is_a_function_of_the_seed():
    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return [bench_torch.synth_eeg(2, gen, torch.device("cpu"),
                                      DEFAULT_CONFIG.fs_eeg) for _ in range(2)]

    a, b, c = draw(42), draw(42), draw(7)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])          # each pass draws anew
    assert not torch.equal(a[0], c[0])


def test_two_calls_with_one_seed_give_the_same_eeg(run):
    _, last = run
    _, again = bench_torch.eeg_throughput(recordings=2, windows=2, repeats=1,
                                          device="cpu")
    assert torch.equal(again["eeg"], last["eeg"])
    assert torch.equal(again["agg"], last["agg"])


@pytest.mark.parametrize("argv", [["--eeg-throughput"], ["--smoke"]])
def test_no_card_no_reading(argv, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_torch.main(argv) != 0
    assert capsys.readouterr().out == ""
