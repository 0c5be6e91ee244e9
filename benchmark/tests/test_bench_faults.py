"""`correct` comes out false when the timed path is broken, and for the
control.  The run is driven as on the card, past the look for a card, on
the port's plain CPU path at a size a test can hold: one subject's two
recordings (a slow and a fast one, each the other's mismatch partner), the
configuration's own shapes otherwise, except that the comparison's cells
take every eighth Takens point (audio clouds of 31 points, not 124).

Faults a features job can have: an answer altered where it is produced
(one feature of every aggregate 5 % off), and half of the batch left out
with the mean taken over the rest (the aggregate over the first half of
each recording's windows).  Faults a comparison job can have: the W values
of half of each batch left unwritten, an answer altered where it is
produced (W_H1 5 % off), and the control's rows altered where they are
produced (the mismatched W of half of them 5 % off).  A job keeps no state
from step to step and runs on one card, so the faults of an unchanged
state and of a missing exchange between cards do not arise."""

import argparse
import json
import time
from pathlib import Path

import pytest
import torch

from benchmark.harness import cell as C
from benchmark.harness import check, generator, spec
from tda_eeg_audio_tpu_torch.models import programs
from tda_eeg_audio_tpu_torch.models.study import StudyRunner

ROOT = Path(__file__).resolve().parents[1]
SEED = 2**31 + 5


def _tiny(tmp_path, name="features45.full"):
    bench = spec.load(ROOT)
    cell = spec.cell(bench, ROOT, name)
    conf = cell["config"]
    cell["config"] = dict(conf, dataset=dict(conf["dataset"], subjects=1, slow=1, fast=1),
                          compare=dict(conf["compare"], features=2))
    if "comparison" in cell["traffic"]["stages"]:
        cell["config"]["pipeline"] = dict(conf["pipeline"], takens_subsample=8)
    cell["tmp"] = str(tmp_path)
    return bench, cell


def _run(tmp_path, capsys, name="features45.full"):
    bench, cell = _tiny(tmp_path, name)
    args = argparse.Namespace(workload=cell["name"], seed=SEED, seconds=0.0, trace=0)
    assert C._run(args, ROOT, bench, cell, time.perf_counter(), device="cpu") == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_a_sound_run_is_correct(tmp_path, capsys):
    line = _run(tmp_path, capsys)
    assert line["correct"] is True, line["compared"]
    assert line["attempted"] == 1 and line["failed"] == 0


def test_an_altered_answer_is_not_correct(tmp_path, capsys, monkeypatch):
    orig = programs.eeg_feature_program

    def altered(*a, **k):
        outs = orig(*a, **k)
        agg = outs[0].clone()
        agg[:, :, 1, 6, 0] *= 1.05          # H1 mean persistence, mean over windows
        return (agg,) + tuple(outs[1:])

    monkeypatch.setattr(programs, "eeg_feature_program", altered)
    line = _run(tmp_path, capsys)
    assert line["correct"] is False
    assert line["compared"]["x_gap"]["value"] > line["compared"]["x_gap"]["limit"]


def test_half_of_the_batch_left_out_is_not_correct(tmp_path, capsys, monkeypatch):
    orig = programs.eeg_feature_program

    def half(eeg, n_samples, use_idx, use_mask, *a, **k):
        mask = torch.as_tensor(use_mask).clone()
        kept = mask.sum(dim=-1, keepdim=True)
        mask &= torch.arange(mask.shape[-1]) < (kept + 1) // 2
        return orig(eeg, n_samples, use_idx, mask, *a, **k)

    monkeypatch.setattr(programs, "eeg_feature_program", half)
    line = _run(tmp_path, capsys)
    assert line["correct"] is False


def test_a_sound_comparison_run_is_correct(tmp_path, capsys):
    line = _run(tmp_path, capsys, "study45.compare")
    assert line["correct"] is True, line["compared"]
    assert {"w_h0_gap", "w_h1_gap", "w_mis_gap", "control_gap",
            "stats_gap"} <= set(line["compared"])


def _unwritten(out, B):
    """The W values of the batch's second half left unwritten."""
    for k in ("w_h0", "w_h1", "w_h1_mis"):
        out[k] = out[k].clone()
        out[k][B // 2:] = 0.0


def _altered(out, B):
    """W_H1 altered where it is produced."""
    out["w_h1"] = out["w_h1"] * 1.05


@pytest.mark.parametrize("fault, number", [(_unwritten, "w_h0_gap"), (_altered, "w_h1_gap")],
                         ids=["half_a_batch_unwritten", "altered_answer"])
def test_a_broken_comparison_is_not_correct(tmp_path, capsys, monkeypatch, fault, number):
    orig = programs.pack_comparison_outputs

    def planted(out):
        out = dict(out)
        fault(out, out["w_h0"].shape[0])
        return orig(out)

    monkeypatch.setattr(programs, "pack_comparison_outputs", planted)
    line = _run(tmp_path, capsys, "study45.compare")
    assert line["correct"] is False
    assert line["compared"][number]["value"] > line["compared"][number]["limit"]


def test_altered_control_rows_are_not_correct(tmp_path, capsys, monkeypatch):
    orig = StudyRunner._control_rows_fused

    def altered(self, *a, **k):
        rows = orig(self, *a, **k)
        return [dict(r, w_mismatched=r["w_mismatched"] * 1.05) if n % 2 else r
                for n, r in enumerate(rows)]

    monkeypatch.setattr(StudyRunner, "_control_rows_fused", altered)
    line = _run(tmp_path, capsys, "study45.compare")
    assert line["correct"] is False
    assert line["compared"]["control_gap"]["value"] > line["compared"]["control_gap"]["limit"]


def test_the_control_is_not_correct(tmp_path):
    _, cell = _tiny(tmp_path)
    study = generator.make_study(cell["config"]["dataset"], SEED, "cpu")
    numbers, _ = check.check(study, spec.reference_pipeline(cell), cell["config"]["compare"],
                             {"X": None}, SEED, precision="bfloat16")
    limits = cell["config"]["limits"]
    assert any(v > limits[k] for k, v in numbers.items()), numbers


def test_the_comparison_control_is_not_correct(tmp_path):
    _, cell = _tiny(tmp_path, "study45.compare")
    study, job = C.make_job(cell, SEED, "cpu", C._port())
    numbers, _ = check.check(study, spec.reference_pipeline(cell), cell["config"]["compare"],
                             job()["outputs"], SEED, precision="bfloat16")
    limits = cell["config"]["limits"]
    assert any(v > limits[k] for k, v in numbers.items()), numbers


@pytest.mark.cuda
def test_the_control_is_not_correct_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, cell = _tiny(tmp_path)
    study = generator.make_study(cell["config"]["dataset"], SEED, "cuda")
    numbers, _ = check.check(study, spec.reference_pipeline(cell), cell["config"]["compare"],
                             {"X": None}, SEED, precision="bfloat16")
    limits = cell["config"]["limits"]
    assert any(v > limits[k] for k, v in numbers.items()), numbers
