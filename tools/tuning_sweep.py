#!/usr/bin/env python3
"""The knob sweep behind `tda_eeg_audio_tpu_torch/tuning.json`.

    python3 tools/tuning_sweep.py run --candidates eeg_batch=32,48,64 \\
        [--base eeg_batch=32] --out sweep/a.json
    python3 tools/tuning_sweep.py decide sweep/*.json [--write]

`run` (needs the card) runs `bench_torch.py` in fresh processes, one knob
flipped at a time through its `TDA_TORCH_*` variable over the `--base`
knobs (the defaults where not named): for each candidate value the default,
the candidate, the candidate, the default, each a full study of 2
repeats; then `bench_torch.py --eeg-throughput` at the base knobs, twice.
Every bench's last JSON line is kept in `--out` as it comes.

`decide` reads the files of several calls and applies the promotion rule:
a value is promoted only if, in every call that ran it, every repeat-2
reading of the candidate is below every repeat-2 reading of the default,
in at least two calls, with the overflow windows and deviants redone
equal to the default's and `ok` true on every run.  It prints one table
row per bench and repeat and one per candidate.  `--write` rewrites
tuning.json with the promoted values over the defaults and, under
`measured`, every reading, each beside the card's name and power limit.
That the runner's results at the promoted values equal the defaults' is
`chip_smoke.py` phase 12's check, run after the file is written.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tda_eeg_audio_tpu_torch import tuning  # noqa: E402

TUNING = ROOT / "tda_eeg_audio_tpu_torch" / "tuning.json"
RULE = ("a value passes when, in at least two calls and in every call that "
        "ran it, each repeat-2 reading of it is below each repeat-2 reading "
        "of the default, with equal windows and deviants redone and ok true; "
        "of the values of one knob that pass, the lowest mean is written")


def parse_knobs(text: str) -> dict:
    """"eeg_batch=32,48" → {"eeg_batch": [32, 48]} (values coerced like the
    loader's)."""
    out = {}
    for part in filter(None, (text or "").split(";")):
        name, _, values = part.partition("=")
        if name not in tuning._DEFAULTS:
            raise SystemExit(f"unknown knob {name!r}")
        kind = type(tuning._DEFAULTS[name])
        out[name] = [v.lower() not in ("0", "false", "")
                     if kind is bool else kind(v) for v in values.split(",")]
    return out


def env_value(value) -> str:
    return ("1" if value else "0") if isinstance(value, bool) else str(value)


def bench(args: list, knobs: dict, timeout: float = 900.0) -> dict:
    """One `bench_torch.py` process at `knobs`; its last JSON line, or a
    line with ok false and the error's tail."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("TDA_TORCH_")}
    env.update({tuning._ENV[k]: env_value(v) for k, v in knobs.items()})
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, str(ROOT / "bench_torch.py")] + args,
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=timeout)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    line = json.loads(lines[-1]) if lines else dict(
        ok=False, error=res.stderr[-2000:])
    line.update(rc=res.returncode, process_s=time.perf_counter() - t0,
                knobs=knobs)
    return line


def run(args) -> int:
    base = {k: v[0] for k, v in parse_knobs(args.base).items()}
    default = {**tuning._DEFAULTS, **base}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    readings = []

    def keep(role, knob, value, line):
        readings.append(dict(role=role, knob=knob, value=value, line=line))
        out.write_text(json.dumps(dict(base=default, readings=readings), indent=1))
        study = [r.get("total") for r in line.get("runs", [])]
        print(f"[sweep] {role} {knob}={value}: ok {line.get('ok')} "
              f"study {study} value {line.get('value')}", flush=True)

    study = ["--repeats", "2"]
    for knob, values in parse_knobs(args.candidates).items():
        for value in values:
            cand = {**default, knob: value}
            for role, knobs in (("default", default), ("candidate", cand),
                                ("candidate", cand), ("default", default)):
                keep(role, knob, value, bench(study, knobs))
    for _ in range(2):
        keep("throughput", None, None,
             bench(["--eeg-throughput"], default))
    return 0


def repeat2(line: dict):
    runs = line.get("runs") or []
    return runs[1]["total"] if len(runs) > 1 else None


def redone(line: dict):
    runs = line.get("runs") or []
    return runs[-1]["redone"] if runs else None


def decide(args) -> int:
    calls = {Path(p).stem: json.loads(Path(p).read_text()) for p in args.files}
    rows, verdicts, readings = [], {}, []
    for call, data in calls.items():
        for i, r in enumerate(data["readings"]):
            ln = r["line"]
            readings.append(dict(
                call=call, order=i, role=r["role"], knob=r["knob"],
                value=r["value"], knobs=ln.get("knobs"), card=ln.get("card"),
                ok=ln.get("ok"), metric=ln.get("metric"), value_s=ln.get("value"),
                runs=[{k: run[k] for k in ("total", "features_s", "compare_s",
                                           "control_s", "redone")}
                      for run in ln.get("runs", [])],
                peak_device_gb=ln.get("peak_device_gb"),
                **({"eeg_windows_per_sec": ln.get("value"),
                    "vs_baseline": ln.get("vs_baseline"),
                    "overflow_recordings": ln.get("overflow_recordings"),
                    "launches": [ln.get("phase1_launches"),
                                 ln.get("kernel_launches")]}
                   if r["role"] == "throughput" else {})))
            runs = ln.get("runs", [])
            stages = " / ".join(f"{runs[-1][k]:.4f}" for k in (
                "features_s", "compare_s", "control_s")) if runs else "—"
            rows.append(f"| {call} | {i} | {r['role']} | {r['knob']}={r['value']} | "
                        + (" / ".join(f"{run['total']:.4f}" for run in runs)
                           or str(ln.get("value"))) + f" | {stages} | "
                        f"{ln.get('peak_device_gb')} | {redone(ln)} | {ln.get('ok')} |")
            if r["role"] in ("default", "candidate"):
                v = verdicts.setdefault((r["knob"], json.dumps(r["value"])), {})
                v.setdefault(call, dict(default=[], candidate=[], redone=set(),
                                        ok=True))
                v[call][r["role"]].append(repeat2(ln))
                v[call]["redone"].add(json.dumps(redone(ln), sort_keys=True))
                v[call]["ok"] &= bool(ln.get("ok")) and repeat2(ln) is not None
    print("| call | order | role | knob | repeat 1 / 2 s (throughput: windows/s) "
          "| features / comparison / control s, last repeat | peak GB | redone "
          "| ok |\n|---|---|---|---|---|---|---|---|---|")
    print("\n".join(rows))
    promoted, decisions = {}, []
    for (knob, value), per_call in verdicts.items():
        value = json.loads(value)
        wins = all(c["ok"] and len(c["redone"]) == 1 and c["candidate"] and
                   c["default"] and max(c["candidate"]) < min(c["default"])
                   for c in per_call.values())
        promote = wins and len(per_call) >= 2
        card = next((r["card"] for r in readings if r["knob"] == knob
                     and r["value"] == value and r["card"]), None)
        decisions.append(dict(
            knob=knob, value=value, passes=promote, card=card,
            calls={call: dict(candidate_repeat2_s=c["candidate"],
                              default_repeat2_s=c["default"],
                              redone_equal=len(c["redone"]) == 1, ok=c["ok"])
                   for call, c in per_call.items()}))
        print(f"{knob}={value}: passes {promote} " + json.dumps(
            decisions[-1]["calls"]))
        if promote:
            best = promoted.get(knob)
            if best is None or _mean(per_call, "candidate") < best[1]:
                promoted[knob] = (value, _mean(per_call, "candidate"))
    knobs = {**tuning._DEFAULTS, **{k: v for k, (v, _) in promoted.items()}}
    print("promoted: " + json.dumps({k: v for k, (v, _) in promoted.items()}))
    if args.write:
        # one line a decision and a reading
        lines = [f" {json.dumps(k)}: {json.dumps(v)}," for k, v in knobs.items()]
        lines += [' "measured": {', '  "tool": "tools/tuning_sweep.py",',
                  f'  "rule": {json.dumps(RULE)},', '  "decisions": [']
        lines += ["   " + json.dumps(d) + "," for d in decisions]
        lines[-1] = lines[-1].rstrip(",")
        lines += ["  ],", '  "readings": [']
        lines += ["   " + json.dumps(r) + "," for r in readings]
        lines[-1] = lines[-1].rstrip(",")
        TUNING.write_text("\n".join(["{"] + lines + ["  ]", " }", "}"]) + "\n")
        print(f"wrote {TUNING}: " + json.dumps(knobs))
    return 0


def _mean(per_call, role) -> float:
    xs = [x for c in per_call.values() for x in c[role]]
    return sum(xs) / len(xs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--candidates", required=True,
                   help="knob=v1,v2[;knob=v] flipped one value at a time")
    r.add_argument("--base", default="", help="knob=v[;knob=v] under every run")
    r.add_argument("--out", required=True)
    d = sub.add_parser("decide")
    d.add_argument("files", nargs="+")
    d.add_argument("--write", action="store_true")
    args = ap.parse_args(argv)
    return run(args) if args.cmd == "run" else decide(args)


if __name__ == "__main__":
    sys.exit(main())
