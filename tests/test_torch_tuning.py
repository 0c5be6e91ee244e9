"""The port's knobs (`tda_eeg_audio_tpu_torch/tuning.py`, CPU): the
reference loader's contract (tests/test_tuning.py) against the port's own
module, the entry points that read it, the committed tuning.json, the two
packages' variables kept apart, and the promotion rule of
tools/tuning_sweep.py with the file it writes."""
import importlib
import json
import subprocess
import sys
from pathlib import Path

import pytest

import tda_eeg_audio_tpu.tuning as jtuning
import tda_eeg_audio_tpu_torch.tuning as tuning
from tda_eeg_audio_tpu_torch import cli
from tda_eeg_audio_tpu_torch.config import DEFAULT_CONFIG, GOOD_ELECTRODES
from tda_eeg_audio_tpu_torch.io.device_store import build_from_dataset
from tda_eeg_audio_tpu_torch.models.study import StudyRunner
from torch_tiny_data import TinyDataset

ROOT = Path(__file__).resolve().parents[1]
DEFAULTS = dict(eeg_batch=16, eeg_bank=True, feature_na_max=128)


@pytest.fixture
def reload_after(monkeypatch):
    """Reload the given modules after the test's env / path changes, and
    again, restored, when it ends (the knobs are read at import)."""
    mods = []

    def reload(*ms):
        mods.extend(ms)
        for m in ms:
            importlib.reload(m)

    yield reload
    monkeypatch.undo()
    for m in mods:
        importlib.reload(m)


# (file text or None for no file, {knob: value} the loader must give)
LOADER_CASES = {
    "absent": (None, DEFAULTS),
    "merge_over_defaults": (json.dumps(dict(eeg_batch=32)),
                            dict(DEFAULTS, eeg_batch=32)),
    # the reference's knobs without a counterpart, and deleted ones, ignored
    "unknown_keys_ignored": (json.dumps(dict(pallas_min_n=80, tda_chunk=64,
                                             audio_chains=4, feature_na_max=96)),
                             dict(DEFAULTS, feature_na_max=96)),
    "corrupt": ("{not json", DEFAULTS),
    "non_object": ("[1, 2]", DEFAULTS),
    # a partial write must not ship half a configuration
    "bad_value_degrades_whole_file": (
        json.dumps(dict(eeg_batch=32, feature_na_max="not-a-number")), DEFAULTS),
}


@pytest.mark.parametrize("case", LOADER_CASES)
def test_loader_contract(case, monkeypatch, tmp_path):
    text, want = LOADER_CASES[case]
    p = tmp_path / "tuning.json"
    if text is not None:
        p.write_text(text)
    monkeypatch.setattr(tuning, "_PATH", p)
    assert tuning._load() == want
    assert tuning._DEFAULTS == DEFAULTS


def test_env_beats_file_beats_default(monkeypatch, tmp_path, reload_after):
    p = tmp_path / "tuning.json"
    p.write_text(json.dumps(dict(eeg_batch=32, feature_na_max=96)))
    monkeypatch.setenv("TDA_TORCH_TUNING_FILE", str(p))
    monkeypatch.setenv("TDA_TORCH_EEG_BATCH", "8")
    monkeypatch.setenv("TDA_TORCH_EEG_BANK", "false")
    reload_after(tuning)
    assert tuning.EEG_BATCH == 8                        # env beats file
    assert tuning.FEATURE_NA_MAX == 96                  # file beats default
    assert tuning.EEG_BANK is False                     # env beats default
    assert tuning.SOURCE == dict(eeg_batch="env", eeg_bank="env",
                                 feature_na_max="file")
    assert tuning.KNOBS == dict(eeg_batch=8, eeg_bank=False, feature_na_max=96)
    # a file that falls back sets no knob
    p.write_text("{not json")
    monkeypatch.delenv("TDA_TORCH_EEG_BATCH")
    monkeypatch.delenv("TDA_TORCH_EEG_BANK")
    reload_after(tuning)
    assert tuning.KNOBS == DEFAULTS
    assert set(tuning.SOURCE.values()) == {"default"}


def test_runner_takes_the_tuned_knobs_unless_given(monkeypatch):
    monkeypatch.setattr(tuning, "EEG_BATCH", 7)
    monkeypatch.setattr(tuning, "EEG_BANK", False)
    monkeypatch.setattr(tuning, "FEATURE_NA_MAX", 64)
    store = build_from_dataset(TinyDataset(DEFAULT_CONFIG, n_subjects=1),
                               GOOD_ELECTRODES, device="cpu")
    r = StudyRunner(store, DEFAULT_CONFIG, verbose=False)
    assert (r.eeg_batch, r.use_eeg_bank, r.feature_na_max) == (7, False, 64)
    r = StudyRunner(store, DEFAULT_CONFIG, eeg_batch=3, eeg_bank=True,
                    feature_na_max=96, verbose=False)
    assert (r.eeg_batch, r.use_eeg_bank, r.feature_na_max) == (3, True, 96)


def test_cli_batch_default_is_the_tuned_batch(monkeypatch, reload_after):
    assert cli._parser().parse_args(["features"]).batch == tuning.EEG_BATCH
    monkeypatch.setenv("TDA_TORCH_EEG_BATCH", "24")
    reload_after(tuning, cli)
    assert cli._parser().parse_args(["features"]).batch == 24
    assert cli._parser().parse_args(["features", "--batch", "3"]).batch == 3


def _numbers_beside_a_card(node, card=None):
    """Every number (bools aside) under `node` with its nearest enclosing
    dict's card string, or None where no dict above it names one."""
    if isinstance(node, dict):
        card = node.get("card", card)
        for v in node.values():
            yield from _numbers_beside_a_card(v, card)
    elif isinstance(node, list):
        for v in node:
            yield from _numbers_beside_a_card(v, card)
    elif isinstance(node, (int, float)) and not isinstance(node, bool):
        yield node, card


def test_committed_file_loads_and_names_the_card():
    path = ROOT / "tda_eeg_audio_tpu_torch" / "tuning.json"
    data = json.loads(path.read_text())
    knobs, from_file = tuning._read()
    assert from_file == set(DEFAULTS)                   # no fallback
    assert knobs == {k: data[k] for k in DEFAULTS}
    measured = data["measured"]
    assert isinstance(measured, dict)
    for number, card in _numbers_beside_a_card(measured):
        assert isinstance(card, str) and card.startswith("NVIDIA ") \
            and card.endswith(" W"), (number, card)


def test_each_package_reads_only_its_own_variables(monkeypatch, reload_after):
    port, ref = tuning.EEG_BATCH, jtuning.EEG_BATCH
    monkeypatch.setenv("TDA_TPU_EEG_BATCH", str(port + 5))
    monkeypatch.setenv("TDA_TORCH_EEG_BATCH", str(ref + 9))
    monkeypatch.setenv("TDA_TPU_TUNING_FILE", "/nonexistent/tuning.json")
    reload_after(tuning)
    assert tuning.EEG_BATCH == ref + 9                  # its own variable
    assert tuning._PATH.name == "tuning.json" and tuning._PATH.exists()
    monkeypatch.delenv("TDA_TORCH_EEG_BATCH")
    reload_after(tuning)
    assert tuning.EEG_BATCH == port                     # TDA_TPU_* ignored
    monkeypatch.delenv("TDA_TPU_EEG_BATCH")
    monkeypatch.delenv("TDA_TPU_TUNING_FILE")
    monkeypatch.setenv("TDA_TORCH_EEG_BATCH", str(ref + 9))
    monkeypatch.setenv("TDA_TORCH_TUNING_FILE", "/nonexistent/tuning.json")
    reload_after(jtuning)
    assert jtuning.EEG_BATCH == ref                     # TDA_TORCH_* ignored
    assert jtuning._PATH.exists()


def test_tuning_imports_neither_jax_nor_the_reference():
    code = ("import sys, tda_eeg_audio_tpu_torch.tuning\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'tda_eeg_audio_tpu')))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def _sweep():
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        return importlib.import_module("tuning_sweep")
    finally:
        sys.path.pop(0)


CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def _call(path, default_s, cand_s, cand_redone=0, ok=True):
    """One sweep call's file: eeg_batch=32 as default, candidate, candidate,
    default, with the given repeat-2 seconds."""
    def line(total, redone, knobs):
        runs = [dict(total=total + 3.0, features_s=0.1, compare_s=0.2,
                     control_s=0.3, redone=dict(windows=0, control_deviants=11))]
        runs.append(dict(runs[0], total=total, redone=dict(
            windows=redone, control_deviants=11)))
        return dict(ok=ok, card=CARD, knobs=knobs, runs=runs, value=total,
                    peak_device_gb=12.0)
    d = dict(tuning._DEFAULTS)
    c = dict(d, eeg_batch=32)
    roles = [("default", default_s[0], 0, d), ("candidate", cand_s[0], cand_redone, c),
             ("candidate", cand_s[1], cand_redone, c), ("default", default_s[1], 0, d)]
    path.write_text(json.dumps(dict(base=d, readings=[
        dict(role=r, knob="eeg_batch", value=32, line=line(t, w, k))
        for r, t, w, k in roles])))
    return str(path)


# (per call: default repeat-2 s, candidate repeat-2 s, candidate's windows
# redone, ok) → whether batch 32 is written
SWEEP_CASES = {
    "wins_in_two_calls": ([((4.0, 4.1), (3.0, 3.1), 0, True)] * 2, True),
    "one_call_decides_nothing": ([((4.0, 4.1), (3.0, 3.1), 0, True)], False),
    "a_reading_inside_the_default_spread": (
        [((4.0, 4.1), (3.0, 3.1), 0, True), ((4.0, 4.1), (3.0, 4.05), 0, True)], False),
    "more_windows_redone": ([((4.0, 4.1), (3.0, 3.1), 0, True),
                             ((4.0, 4.1), (3.0, 3.1), 2, True)], False),
    "not_ok": ([((4.0, 4.1), (3.0, 3.1), 0, True),
                ((4.0, 4.1), (3.0, 3.1), 0, False)], False),
}


@pytest.mark.parametrize("case", SWEEP_CASES)
def test_sweep_promotion_rule_and_the_file_it_writes(case, monkeypatch, tmp_path,
                                                     capsys):
    ts = _sweep()
    calls, promoted = SWEEP_CASES[case]
    files = [_call(tmp_path / f"call{i}.json", *c) for i, c in enumerate(calls)]
    out = tmp_path / "tuning.json"
    monkeypatch.setattr(ts, "TUNING", out)
    assert ts.main(["decide", *files, "--write"]) == 0
    data = json.loads(out.read_text())
    assert data["eeg_batch"] == (32 if promoted else 16)
    # the written file loads whole and names the card beside every number
    monkeypatch.setattr(tuning, "_PATH", out)
    knobs, from_file = tuning._read()
    assert knobs["eeg_batch"] == data["eeg_batch"] and from_file == set(DEFAULTS)
    assert all(card == CARD for _, card in _numbers_beside_a_card(data["measured"]))
