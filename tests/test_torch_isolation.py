"""The port stands alone: importing every module of `tda_eeg_audio_tpu_torch`,
`chip_smoke` and `bench_torch` loads neither JAX nor the reference package,
and no source of the port names them.  The entry points the card's commands
import (the CLI, the runner, `chip_smoke`, `bench_torch`) load neither
scikit-learn nor matplotlib: the card's machine has neither."""
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import tda_eeg_audio_tpu_torch

ROOT = Path(__file__).resolve().parent.parent
PKG = Path(tda_eeg_audio_tpu_torch.__file__).resolve().parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PKG)], prefix="tda_eeg_audio_tpu_torch."))


def test_imports_load_no_jax_and_no_reference_package():
    mods = _modules()
    for name in ("ops.homology_cuda", "models.study", "models.homology_exec",
                 "models.classify", "io.device_store", "native.engine",
                 "utils.validation", "utils.logging", "cli", "io.matfiles",
                 "models.eda", "models.figures", "utils.profiling",
                 "ops.iir_cuda", "ops.cuda_build", "ops.homology",
                 "parallel.sharding"):
        assert f"tda_eeg_audio_tpu_torch.{name}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods + ['chip_smoke', 'bench_torch']!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'tda_eeg_audio_tpu' or m.startswith('tda_eeg_audio_tpu.'))\n"
        "print(','.join(bad))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "", f"loaded: {res.stdout.strip()}"


def test_entry_points_load_neither_sklearn_nor_matplotlib():
    mods = ["tda_eeg_audio_tpu_torch.cli", "tda_eeg_audio_tpu_torch.models.study",
            "tda_eeg_audio_tpu_torch.models.eda",
            "tda_eeg_audio_tpu_torch.models.classify", "chip_smoke", "bench_torch"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('sklearn', 'matplotlib', 'joblib'))\n"
        "print(','.join(bad))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "", f"loaded: {res.stdout.strip()}"


def test_sources_name_neither_jax_nor_reference_package():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.]|import\s+tda_eeg_audio_tpu\b"
                     r"(?!_torch)|from\s+tda_eeg_audio_tpu\b(?!_torch))", re.M)
    files = sorted(PKG.rglob("*.py")) + sorted((PKG / "csrc").iterdir()) + [
        ROOT / "chip_smoke.py", ROOT / "bench_torch.py"]
    assert len(files) > 20
    for f in files:
        text = f.read_text()
        assert not pat.search(text), f
        assert "tda_eeg_audio_tpu." not in text.replace("tda_eeg_audio_tpu_torch", ""), f


def test_entry_scripts_need_the_card():
    """Without a CUDA device both scripts exit non-zero and print no result
    line."""
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for script in ("chip_smoke.py", "bench_torch.py"):
        res = subprocess.run([sys.executable, str(ROOT / script)], cwd=ROOT,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode != 0, script
        assert '"ok"' not in res.stdout and "full_study_seconds" not in res.stdout
