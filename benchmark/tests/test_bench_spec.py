"""BENCHMARK.json and the benchmark's data files keep the contract's
character rules, and every name they use has the file the harness finds
by it."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|_dim$|_rank$)")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)


def test_command_and_paths():
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for w in cmd[1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in BENCH["paths"])
            assert (ROOT / w).exists()


def test_names_units_and_lines():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert not any(WIDTH.search(k) for k in c["reduced"])
        names.append(c["name"])
    assert len(set(names)) == len(names)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(names)
    cells = []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4) and w["config"] in names
        cells.append(w["name"])
    assert len(set(cells)) == len(cells) and 1 <= len(cells) <= 24
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(cells)
    metrics = []
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        metrics.append(m["name"])
    assert "setup_s" in metrics
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in metrics
        assert set(m.get("workloads", cells)) <= set(cells)
        metrics.append(m["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(set(metrics)) == len(metrics)


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e = [m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in BENCH["per_layer"])


def test_at_most_a_quarter_of_cells_on_four_chips():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_check_fits_the_budget_at_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_has_its_files(cell):
    bench_dir = ROOT / "benchmark"
    traffic = json.loads((bench_dir / "workloads" / f"{cell}.json").read_text())
    w = {x["name"]: x for x in BENCH["workloads"]}[cell]
    assert traffic["config"] == w["config"]
    conf = {c["name"]: c for c in BENCH["configs"]}[w["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    assert {s["stage"] for s in config["analysis"]} >= set(traffic["stages"])
    assert set(config["limits"]) and all(v is not None for v in config["limits"].values())
    for m in BENCH["per_layer"]:
        assert (bench_dir / "metrics" / f"{m['name']}.py").is_file()


def test_data_file_names_are_made_of_name_characters():
    for p in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel
