"""Finding a cell's files by the names in `BENCHMARK.json`:

* the configuration: the `file` its entry names (benchmark/configs/);
* the traffic: `workloads/<cell>.json`, which names the configuration and
  the stages of its analysis that one submitted job runs;
* the per-layer metrics the cell reports: `metrics/<metric>.py` each.

Nothing here names a cell, a configuration or a metric: a later one is
added by adding files and entries."""

from __future__ import annotations

import json
from pathlib import Path


def load(root: Path) -> dict:
    return json.loads((root.parent / "BENCHMARK.json").read_text())


def cell(bench: dict, root: Path, name: str) -> dict:
    """The cell `name` with its configuration, traffic and metrics."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise SystemExit(f"benchmark: no workload {name!r} in BENCHMARK.json")
    w = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root.parent / conf["file"]).read_text())
    traffic = json.loads((root / "workloads" / f"{name}.json").read_text())
    if traffic["config"] != w["config"]:
        raise SystemExit(f"benchmark: {name}'s traffic names {traffic['config']!r}")
    known = {s["stage"] for s in config["analysis"]}
    if not set(traffic["stages"]) <= known:
        raise SystemExit(f"benchmark: {name} asks for stages {traffic['stages']}, "
                         f"its configuration has {sorted(known)}")
    e2e = {m["name"] for m in bench["end_to_end"]
           if name in m.get("workloads", [name])}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in e2e else [])]
    return dict(name=name, chips=w["chips"], config=config, traffic=traffic,
                per_layer=per_layer)


def reference_pipeline(cell: dict) -> dict:
    """The settings the reference reads: the configuration's pipeline
    fields and the runner's padded shapes."""
    c = cell["config"]
    p = dict(c["pipeline"])
    win = int(p["window_sec"] * p["fs_eeg"])
    step = int(win * (1.0 - p["overlap"]))
    p["n_win_max"] = (c["dataset"]["t_eeg_pad"] - win) // step + 1
    p["n_rs_max"] = c["runner"]["n_rs_max"]
    return p
