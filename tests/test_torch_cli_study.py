"""The port's command line on the CPU, the commands of the classification
stage: classify and ablate on the features' X.npy, and study end to end
with its figures (scikit-learn and matplotlib are installed here), over the
short `.mat` recordings of `test_torch_cli.py` (`--device cpu --backend
host --wasserstein exact`, pads 600 / 97,020 / 560).  Three permutations
and 20 bootstrap draws keep the Random Forest stage short.

No tolerance: study's X equals the features command's X bit for bit (the
same computation); the rest are schema and count checks."""
import json

import numpy as np
import pytest
import torch

from tda_eeg_audio_tpu_torch import cli
from torch_tiny_data import write_mat_recordings

torch.set_num_threads(1)

CPU = ["--device", "cpu", "--backend", "host", "--batch", "3", "--t-eeg-pad",
       "600", "--t-audio-pad", "97020", "--n-rs-max", "560"]


def _run(command, data, results, *extra):
    return cli.main([command, "--data", str(data), "--results", str(results),
                     *CPU, *extra])


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_mat_recordings(tmp_path_factory.mktemp("data"))


@pytest.fixture(scope="module")
def features(data, tmp_path_factory):
    out = tmp_path_factory.mktemp("features")
    assert _run("features", data, out) == 0
    return out


def test_classify_ablate_and_study(data, features, tmp_path):
    for name in ("X.npy", "y.npy", "subjects.npy"):
        (tmp_path / name).write_bytes((features / name).read_bytes())
    assert _run("classify", data, tmp_path, "--permutations", "3",
                "--bootstrap", "20") == 0
    summary = json.loads((tmp_path / "results_summary.json").read_text())
    assert summary["n_samples"] == 8 and summary["n_permutations"] == 3
    assert _run("ablate", data, tmp_path) == 0
    abl = json.loads((tmp_path / "gamma_investigation.json").read_text())
    assert abl["metadata"]["n_features_gamma"] == 44

    study = tmp_path / "study"
    assert _run("study", data, study, "--wasserstein", "exact",
                "--permutations", "3", "--bootstrap", "20") == 0
    for name in ("X.npy", "results_summary.json", "feature_importance_ranked.csv",
                 "metadata.csv", "eeg_audio_tda_comparison.json",
                 "eeg_audio_tda_detailed.csv", "matched_vs_mismatched.json",
                 "confusion_matrix_v2.png", "persistence_diagrams_comparison.png"):
        assert (study / name).exists(), name
    assert (study / "figures" / "filter_response.png").exists()
    np.testing.assert_array_equal(np.load(study / "X.npy"), np.load(features / "X.npy"))


