#!/usr/bin/env python3
"""Where the comparison's batch loop waits for the card.

    python3 tools/comparison_waits.py [--workload study45.full] [--seed 1]
        [--jobs 3] [--out waits.json]

Builds the benchmark's study for the cell on the card (`benchmark/harness`),
runs one warm-up job, then:

* `--jobs` plain jobs, each stage and the `comparison_dispatch` /
  `comparison_rows` ranges timed on the host clock without any added
  synchronisation (the host's time in the range; a read-back that waits
  for the card shows in the range that reads);
* one job with `torch.cuda.set_sync_debug_mode("warn")` inside
  `comparison_dispatch`: every implicit synchronisation in the loop, by the
  innermost line of the port that led to it;
* one job under `torch.profiler`: for each range, its wall time, the card's
  busy time inside it (the union of kernels, copies and memsets), and the
  host's time blocked in the CUDA runtime's synchronising calls inside it
  (`cudaStreamSynchronize`, `cudaDeviceSynchronize`, `cudaEventSynchronize`,
  `cudaMemcpy*`): the range's wall less that time is what the host's own
  work (the enqueue) takes, under the profiler's overhead;
* one job under `runtime.timed_spans()`, for the port's counter
  `comparison_dispatch.host_waits` where the port has it;
* with `--cprofile N`, one job with `cProfile` inside
  `comparison_dispatch`: the N functions (torch operations among them)
  that take the most of the host's own time there.

Prints one JSON line, written to `--out` too.  It imports the port of the
checkout it runs from, so a copy of another commit measures that commit."""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import tempfile
import time
import traceback
import warnings
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

RANGES = ("comparison_dispatch", "comparison_rows")
# what `torch.cuda.set_sync_debug_mode("warn")` says of each synchronisation
SYNC_WARNING = "called a synchronizing CUDA operation"
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
            "cudaMemcpy")


def _patch_ranges(study_mod, hook):
    """Wrap the runner's `span` / `logged_span` so that `hook(name)` (a
    context manager factory) runs inside each of RANGES.  Returns the undo."""
    span0, logged0 = study_mod.span, study_mod.logged_span

    @contextlib.contextmanager
    def span(name, device, *a, **kw):
        with span0(name, device, *a, **kw) as h:
            with (hook(name) if name in RANGES else contextlib.nullcontext()):
                yield h

    @contextlib.contextmanager
    def logged_span(name, device, *a, **kw):
        with logged0(name, device, *a, **kw) as h:
            with (hook(name) if name in RANGES else contextlib.nullcontext()):
                yield h

    study_mod.span, study_mod.logged_span = span, logged_span

    def undo():
        study_mod.span, study_mod.logged_span = span0, logged0
    return undo


def _profiled(job, tmp):
    """Per range: wall, device busy inside it and host time blocked in
    synchronising runtime calls inside it, in ms, from one profiled job."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.harness.trace import union_length

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        job()
        torch.cuda.synchronize()
    path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    xs = [e for e in events if e.get("ph") == "X"]
    dev = [(e["ts"], e["ts"] + e.get("dur", 0.0)) for e in xs
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    rt = [(e["ts"], e["ts"] + e.get("dur", 0.0), e["name"]) for e in xs
          if e.get("cat") == "cuda_runtime"]
    out = {}
    for name in RANGES:
        rs = [(e["ts"], e["ts"] + e["dur"]) for e in xs
              if e.get("cat") == "user_annotation" and e["name"] == name]
        if not rs:
            continue
        wall = busy = blocked = 0.0
        calls = Counter()
        for lo, hi in rs:
            wall += hi - lo
            busy += union_length([(max(s, lo), min(e, hi)) for s, e in dev
                                  if e > lo and s < hi])
            for s, e, n in rt:
                if s >= lo and e <= hi and n.startswith(BLOCKING):
                    blocked += e - s
                    calls[n] += 1
        out[name] = dict(wall_ms=wall / 1e3, device_busy_ms=busy / 1e3,
                         host_blocked_ms=blocked / 1e3,
                         host_own_ms=(wall - blocked) / 1e3,
                         blocking_calls=dict(calls))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="study45.full")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cprofile", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import cell as C
    from benchmark.harness import spec
    from tda_eeg_audio_tpu_torch import runtime
    from tda_eeg_audio_tpu_torch.models import study as study_mod

    bench_root = ROOT / "benchmark"
    cell = spec.cell(spec.load(bench_root), bench_root, args.workload)
    tmp = tempfile.mkdtemp(prefix="waits-", dir=os.environ.get("TMPDIR"))
    cell["tmp"] = tmp
    port = C._port()
    for build in port["builds"]:
        build()
    _, job = C.make_job(cell, args.seed, "cuda", port)
    job()                                   # warm-up

    host_ms = {n: [] for n in RANGES}

    @contextlib.contextmanager
    def clock(name):
        t0 = time.perf_counter()
        yield
        host_ms[name].append((time.perf_counter() - t0) * 1e3)

    undo = _patch_ranges(study_mod, clock)
    stage_s = []
    try:
        for _ in range(args.jobs):
            stage_s.append(job()["stage_s"])
    finally:
        undo()

    sites = Counter()

    def site(message, category, filename, lineno, file=None, line=None):
        # the innermost frame of this checkout's port that led to the warning
        if SYNC_WARNING not in str(message):
            return
        port = [f for f in traceback.extract_stack()
                if "tda_eeg_audio_tpu_torch" in f.filename]
        f = port[-1] if port else None
        sites[f"{os.path.relpath(f.filename, ROOT)}:{f.lineno}" if f
              else f"{filename}:{lineno}"] += 1

    @contextlib.contextmanager
    def catch(name):
        if name != "comparison_dispatch":
            yield
            return
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = site
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode(0)

    undo = _patch_ranges(study_mod, catch)
    try:
        job()
    finally:
        undo()

    top = []
    if args.cprofile:
        import cProfile
        import pstats

        prof = cProfile.Profile()

        @contextlib.contextmanager
        def cprof(name):
            if name != "comparison_dispatch":
                yield
                return
            prof.enable()
            try:
                yield
            finally:
                prof.disable()

        undo = _patch_ranges(study_mod, cprof)
        try:
            job()
        finally:
            undo()
        st = pstats.Stats(prof)
        rows = [(fn, cc, tt, ct) for fn, (cc, nc, tt, ct, _) in st.stats.items()]
        for (path, line, func), calls, tt, ct in sorted(rows, key=lambda r: -r[2])[:args.cprofile]:
            top.append([f"{os.path.basename(path)}:{line}:{func}", calls,
                        round(tt * 1e3, 2), round(ct * 1e3, 2)])

    profiled = _profiled(job, tmp)
    with runtime.timed_spans():
        job()
    record = getattr(runtime, "last_record", lambda: None)() or {}
    spans = record.get("spans", {})
    line = dict(
        workload=args.workload, seed=args.seed,
        card=torch.cuda.get_device_name(0),
        stage_s={k: [round(r[k], 4) for r in stage_s] for k in stage_s[0]},
        host_ms={k: [round(v, 2) for v in vs] for k, vs in host_ms.items()},
        host_ms_median={k: statistics.median(vs) for k, vs in host_ms.items() if vs},
        sync_sites=dict(sites.most_common()), syncs=sum(sites.values()),
        profiled=profiled, cprofile_top_ms=top,
        counter_host_waits=record.get("counters", {}).get("comparison_dispatch.host_waits"),
        timed_ms={k: round(v["ms"], 2) for k, v in spans.items()
                  if k in RANGES + ("comparison", "stats", "audio_takens")})
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
