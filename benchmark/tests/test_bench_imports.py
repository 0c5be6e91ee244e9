"""Nothing the benchmark runs imports JAX or the JAX package, comparing
top-level module names whole (the port's name begins with the JAX
package's), and the reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "tda_eeg_audio_tpu"}


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def _sources(sub=""):
    return [p for p in (BENCH / sub).rglob("*.py") if "tests" not in p.relative_to(BENCH).parts]


def test_no_module_outside_the_tests_imports_jax_or_the_jax_package():
    for p in _sources():
        assert not (_imports(p) & FORBIDDEN), p


def test_the_reference_imports_nothing_of_the_program():
    for p in _sources("reference"):
        assert "tda_eeg_audio_tpu_torch" not in _imports(p), p
        assert not (_imports(p) & FORBIDDEN), p


def test_the_harness_loads_no_jax_module():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.harness.cell as c, benchmark.harness.check, "
            "benchmark.harness.work, benchmark.harness.trace\n"
            "c._port()\n"
            "print(c.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole():
    from benchmark.harness.cell import forbidden_modules

    assert forbidden_modules(["tda_eeg_audio_tpu_torch.ops.signal", "numpy", "jaxtyping"]) == []
    assert forbidden_modules(["tda_eeg_audio_tpu.config", "jax._src.api", "flax"]) == [
        "flax", "jax", "tda_eeg_audio_tpu"]
