"""The classification stage (host scikit-learn on a numpy X, as in the
reference package) against the reference: `run_classification`,
`run_band_ablation`, the subject-level permutation and the pooled Cohen's d,
and the runner's `run_classification` artifacts (results_summary.json,
feature_importance_ranked.csv, metadata.csv / metadata.json).

X is seeded: 8 subjects × {slow, fast} × 2 utterances, 220 features with a
small slow/fast shift; 3 folds (the reference's 5 cost two thirds more
fits), 3 permutations and 50 bootstrap draws keep the file's time down.

Tolerance: none — both packages run the same scikit-learn estimators with
the same seeds on the same X, so every result is equal except `timing`
(wall-clock seconds)."""
import dataclasses
import json

import numpy as np
import pytest

from tda_eeg_audio_tpu.config import DEFAULT_CONFIG
from tda_eeg_audio_tpu.models import classify as jcls
from tda_eeg_audio_tpu_torch.convert import config_from_jax
from tda_eeg_audio_tpu_torch.models import classify as tcls
from tda_eeg_audio_tpu_torch.models import study as tstudy

N_PERM, N_BOOT = 3, 50
JAX_CONFIG = dataclasses.replace(DEFAULT_CONFIG, n_splits=3)
TORCH_CONFIG = config_from_jax(dataclasses.asdict(JAX_CONFIG))


def _data(seed=0):
    rng = np.random.default_rng(seed)
    subjects = np.array([f"bb{s:02d}" for s in range(1, 9) for _ in range(4)])
    y = np.tile([0, 0, 1, 1], 8)
    X = rng.standard_normal((32, 220)) + 0.4 * y[:, None]
    X[:, 7] = 1.0                        # a constant feature
    return X, y, subjects


@pytest.fixture(scope="module")
def results():
    X, y, subjects = _data()
    want = jcls.run_classification(X, y, subjects, jcls.feature_names_220(),
                                   JAX_CONFIG, n_permutations=N_PERM,
                                   n_bootstrap=N_BOOT, verbose=False)
    got = tcls.run_classification(X, y, subjects, tcls.feature_names_220(),
                                  TORCH_CONFIG, n_permutations=N_PERM,
                                  n_bootstrap=N_BOOT, verbose=False)
    return want, got


def _without_timing(res):
    return {k: v for k, v in res.items() if k != "timing"}


def test_run_classification_equals_reference(results):
    want, got = results
    assert set(got) == set(want)
    assert set(got["timing"]) == set(want["timing"])
    assert _without_timing(got) == _without_timing(want)
    assert len(got["null_scores"]) == N_PERM
    assert len(got["bootstrap_scores"]) == N_BOOT
    assert got["n_subjects"] == 8 and got["cv_method"] == "StratifiedGroupKFold"


def test_band_ablation_equals_reference():
    X, y, subjects = _data(seed=1)
    want = jcls.run_band_ablation(X, y, subjects, jcls.feature_names_220(),
                                  JAX_CONFIG, verbose=False)
    got = tcls.run_band_ablation(X, y, subjects, tcls.feature_names_220(),
                                 TORCH_CONFIG, verbose=False)
    assert list(got) == list(want)
    assert got == want
    assert got["classifier_gamma_only"]["n_features"] == 44


def test_permutation_and_effect_size_helpers_equal_reference():
    X, y, subjects = _data()
    for seed in range(3):
        np.testing.assert_array_equal(
            tcls.permute_labels_by_subject(y, subjects, np.random.RandomState(seed)),
            jcls.permute_labels_by_subject(y, subjects, np.random.RandomState(seed)))
    for j in (0, 7, 100):
        assert tcls._cohens_d_two_sample(X[y == 0, j], X[y == 1, j]) == \
            jcls._cohens_d_two_sample(X[y == 0, j], X[y == 1, j])
    assert tcls._cohens_d_two_sample(X[y == 0, 7], X[y == 1, 7]) == 0.0
    assert tcls.feature_names_220() == jcls.feature_names_220()
    assert tcls.make_pipeline(42).get_params(deep=True).keys() == \
        jcls.make_pipeline(42).get_params(deep=True).keys()
    assert repr(tcls.make_pipeline(42)) == repr(jcls.make_pipeline(42))


def test_runner_writes_the_classification_artifacts(results, tmp_path, monkeypatch):
    """The runner's stage on the same X (its features stage stubbed out):
    the summary equals the function's result less the raw distributions and
    the ranked importances, which go to their own artifacts."""
    want, _ = results
    X, y, subjects = _data()
    fmeta = [dict(filename=f"f{i}.mat", n_windows={"delta": 3}, validation_issues=[])
             for i in range(len(y))]
    meta = dict(min_windows=3, K=3, failed_files=[], skipped_zero_window=[],
                file_metadata=fmeta)
    runner = tstudy.StudyRunner.__new__(tstudy.StudyRunner)
    runner.__dict__.update(cfg=TORCH_CONFIG, results_dir=tmp_path, verbose=False,
                           ds=[None] * len(y))
    monkeypatch.setattr(runner, "compute_feature_dataset",
                        lambda: (X, y, subjects, [m["filename"] for m in fmeta],
                                 dict(meta)), raising=False)
    monkeypatch.setattr(tstudy, "_figures_module", lambda: None)
    res = runner.run_classification(N_PERM, N_BOOT)
    summary = json.loads((tmp_path / "results_summary.json").read_text())
    expect = {k: v for k, v in want.items()
              if k not in ("null_scores", "bootstrap_scores", "all_importances",
                           "timing")}
    assert _without_timing(summary) == json.loads(json.dumps(
        dict(expect, window_equalization={k: v for k, v in meta.items()
                                          if k != "file_metadata"})))
    assert _without_timing(res) == _without_timing(summary)
    ranked = (tmp_path / "feature_importance_ranked.csv").read_text().splitlines()
    assert ranked[0] == "rank,feature,importance" and len(ranked) == 221
    assert [r.split(",")[1] for r in ranked[1:]] == list(want["all_importances"])
    assert json.loads((tmp_path / "metadata.json").read_text()) == fmeta
    assert (tmp_path / "metadata.csv").read_text().splitlines()[0] == \
        "filename,n_windows,validation_issues"
