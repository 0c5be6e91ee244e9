"""The port's command line on the CPU (`--device cpu --backend host`: the
host engine computes every diagram) over short `.mat` recordings written
with `scipy.io.savemat` in the reference's layout (4 subjects × {slow,
fast}, 1.3–2.2 s, transposed EEG, stereo audio; `torch_tiny_data`), with
pads 600 / 97,020 / 560 that hold them.  `test_torch_cli_study.py` drives
classify, ablate and study.

Every command returns 0 and writes its artifacts; `features`' X equals the
runner's X on the same dataset bit for bit, and two partials plus
`--merge-partials` equal the one-shot run bit for bit (rows in the one-shot
order); the merge builds no runner; `--device cuda` raises without a card.
No tolerance: each comparison is of one computation with itself."""
import json

import numpy as np
import pytest
import torch

from tda_eeg_audio_tpu_torch import cli
from tda_eeg_audio_tpu_torch.config import DEFAULT_CONFIG, GOOD_ELECTRODES
from tda_eeg_audio_tpu_torch.io.device_store import build_from_dataset
from tda_eeg_audio_tpu_torch.io.matfiles import MatDataset
from tda_eeg_audio_tpu_torch.models.study import StudyRunner
from torch_tiny_data import write_mat_recordings

torch.set_num_threads(1)

PADS = ["--t-eeg-pad", "600", "--t-audio-pad", "97020", "--n-rs-max", "560"]
CPU = ["--device", "cpu", "--backend", "host", "--batch", "3"] + PADS
BANDS = ["delta", "theta", "alpha", "beta", "gamma"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_mat_recordings(tmp_path_factory.mktemp("data"))


def _run(command, data, results, *extra):
    return cli.main([command, "--data", str(data), "--results", str(results),
                     *CPU, *extra])


@pytest.fixture(scope="module")
def features(data, tmp_path_factory):
    out = tmp_path_factory.mktemp("features")
    assert _run("features", data, out) == 0
    return out


def test_features_equal_the_runners(data, features):
    X = np.load(features / "X.npy")
    store = build_from_dataset(MatDataset(data), GOOD_ELECTRODES, 600, 97020,
                               device="cpu")
    runner = StudyRunner(store, DEFAULT_CONFIG, eeg_batch=3, verbose=False,
                         backend="host", t_eeg_pad=600, t_audio_pad=97020,
                         n_rs_max=560)
    Xr, yr, sr, fr, meta = runner.compute_feature_dataset()
    assert X.shape == (8, 220) and np.isfinite(X).all()
    np.testing.assert_array_equal(X, Xr)
    np.testing.assert_array_equal(np.load(features / "y.npy"), yr)
    np.testing.assert_array_equal(np.load(features / "subjects.npy"), sr)
    assert (features / "filenames.txt").read_text().split() == fr
    names = (features / "feature_names.txt").read_text().split()
    assert len(names) == 220 and names[0] == "delta_h0_n_features_mean"
    fmeta = json.loads((features / "metadata.json").read_text())
    assert [m["filename"] for m in fmeta] == fr
    assert (features / "metadata.csv").read_text().splitlines()[0] == (
        "filename,n_windows,n_windows_used,validation_issues,window_sampling,"
        "max_windows_per_band,n_windows_total,n_windows_used_total")


def test_partials_and_merge_equal_one_shot(data, features, tmp_path, monkeypatch):
    for start, end in (("5", None), ("0", "5")):      # out of order on purpose
        extra = ["--write-partial", "--batch-start", start]
        if end:
            extra += ["--batch-end", end]
        assert _run("features", data, tmp_path, *extra) == 0
    assert sorted(p.name for p in (tmp_path / "partials").iterdir()) == [
        "batch_0_5.npz", "batch_5_3.npz"]

    def no_runner(args):
        raise AssertionError("the merge built a runner")

    monkeypatch.setattr(cli, "_build_runner", no_runner)
    assert cli.main(["features", "--merge-partials", "--results", str(tmp_path),
                     "--device", "cuda"]) == 0
    for name in ("X.npy", "y.npy", "subjects.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / name),
                                      np.load(features / name), err_msg=name)
    for name in ("filenames.txt", "feature_names.txt"):
        assert (tmp_path / name).read_text() == (features / name).read_text()


def test_preprocess_and_graphs(data, tmp_path):
    assert _run("preprocess", data, tmp_path, "--out", str(tmp_path / "pre")) == 0
    assert _run("graphs", data, tmp_path, "--out", str(tmp_path / "graphs")) == 0
    d = tmp_path / "pre" / "fast" / "bb04_ut01"
    assert sorted(p.name for p in d.iterdir()) == sorted(
        [f"{b}.npy" for b in BANDS] + ["audio.npy", "window_times.npy"])
    assert np.load(d / "gamma.npy").shape == (5, 47, 250)     # 2.2 s: 5 windows
    rows = (tmp_path / "pre" / "preprocessing_metadata.csv").read_text().splitlines()
    assert len(rows) == 9 and rows[0].startswith("filename,n_electrodes,n_samples")
    g = tmp_path / "graphs" / "fast" / "bb04_ut01"
    assert len(list(g.iterdir())) == 10
    assert np.load(g / "delta_distances.npy").shape == (5, 47, 47)


def test_compare_control_and_eda(data, tmp_path):
    for command in ("compare", "control"):
        assert _run(command, data, tmp_path, "--wasserstein", "exact",
                    "--permutations", "20") == 0
    assert _run("eda", data, tmp_path) == 0
    comp = json.loads((tmp_path / "eeg_audio_tda_comparison.json").read_text())
    assert list(comp["band_results"]) == BANDS and comp["n_recordings"] == 8
    rows = (tmp_path / "eeg_audio_tda_detailed.csv").read_text().splitlines()
    assert len(rows) == 1 + 8 * 5
    w = rows[0].split(",").index("wasserstein_h1")
    assert all(np.isfinite(float(r.split(",")[w])) for r in rows[1:])
    ctl = json.loads((tmp_path / "matched_vs_mismatched.json").read_text())
    assert set(ctl) == set(BANDS)
    for band in BANDS:      # 4 subjects: fewer than the 5 the test needs
        assert ctl[band]["status"] == "insufficient" and ctl[band]["n"] == 4
        assert set(ctl[band]["by_condition"]) == {"slow", "fast"}
    eda = json.loads((tmp_path / "eda_summary.json").read_text())
    assert eda["n_recordings"] == 8 and eda["n_subjects"] == 4
    assert len((tmp_path / "file_inventory.csv").read_text().splitlines()) == 9


def test_cli_reads_each_mat_file_once(data, features, tmp_path, monkeypatch):
    """The CLI stages the dataset into a store once: `features` reads each
    .mat file once, and gives the same X."""
    reads = []
    load = MatDataset.load

    def counted(self, i):
        reads.append(self.index[i][0])
        return load(self, i)

    monkeypatch.setattr(MatDataset, "load", counted)
    assert _run("features", data, tmp_path) == 0
    assert sorted(reads) == sorted(fn for fn, _, _ in MatDataset(data).index)
    assert len(reads) == 8
    np.testing.assert_array_equal(np.load(tmp_path / "X.npy"),
                                  np.load(features / "X.npy"))


def test_profile_and_log(data, tmp_path):
    log = tmp_path / "events.jsonl"
    assert _run("graphs", data, tmp_path, "--out", str(tmp_path / "g"),
                "--profile", str(tmp_path / "prof"), "--log", str(log)) == 0
    assert "graphs" in json.loads((tmp_path / "prof" / "stage_times.json").read_text())
    assert (tmp_path / "prof" / "trace.json").exists()
    events = [json.loads(line)["event"] for line in log.read_text().splitlines()]
    assert events[0] == "command_start" and "stage" in events


@pytest.mark.parametrize("flag,mesh", [((), "auto"), (("--mesh", "auto"), "auto"),
                                       (("--mesh", "off"), None)],
                         ids=["default", "auto", "off"])
def test_mesh_flag_reaches_the_runner(data, tmp_path, monkeypatch, flag, mesh):
    """`--mesh auto|off` (the JAX CLI's choices and default) reaches the
    runner as mesh="auto" / None; any other value is refused."""
    from tda_eeg_audio_tpu_torch.models import study

    seen = {}

    def runner(*args, **kw):
        seen.update(kw)
        return "runner"

    monkeypatch.setattr(study, "StudyRunner", runner)
    args = cli._parser().parse_args(["features", "--data", str(data), "--results",
                                     str(tmp_path), *CPU, *flag])
    assert cli._build_runner(args) == "runner" and seen["mesh"] == mesh
    with pytest.raises(SystemExit):
        cli._parser().parse_args(["features", "--mesh", "on"])


def test_cuda_without_a_card_raises(data, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["features", "--data", str(data), "--results", str(tmp_path),
                  *PADS])
    assert not (tmp_path / "X.npy").exists()
