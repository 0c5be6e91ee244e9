"""Reading a job's device trace.

One job runs under `torch.profiler` (CPU and CUDA activities); its Chrome
trace is read back and reduced to: the device's busy time as the union of
the intervals of every kernel, copy and memset (overlapping operations are
counted once), the wall window of the job, the device time of each
operation by name, and the longest idle gaps between device operations,
each labelled by the innermost `record_function` range the host was in when
the gap began (the port's spans, the harness's stage ranges)."""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation",)
LABELLED_GAPS = 200      # the longest gaps, summed by the host range they began in


def short_name(name: str, width: int = 96) -> str:
    """A device operation's name without `void `, anonymous namespaces
    and argument lists, cut to `width` characters."""
    for junk in ("void ", "(anonymous namespace)::"):
        name = name.replace(junk, "")
    depth, cut = 0, len(name)
    for k, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            cut = k
            break
    return name[:cut][:width].rstrip()


def union_length(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float):
    """(start, length) of the stretches of [lo, hi] covered by no interval."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi) - t))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi - t))
    return [(s, g) for s, g in out if g > 0]


def host_label(ranges, t: float) -> str:
    """The innermost (shortest) host range covering time t, or "host"."""
    best, best_len = "host", float("inf")
    i = bisect.bisect_right(ranges["starts"], t)
    for s, e, name in ranges["items"][max(0, i - 4096):i]:
        if s <= t < e and e - s < best_len:
            best, best_len = name, e - s
    return best


def reduce_trace(events, window_us):
    """events: Chrome trace events (ts / dur in microseconds); window_us:
    (start, end) of the job on the same clock, or None to take the device
    events' span.  Returns busy_s, window_s, device_ops {name: seconds},
    idle_gaps [(host range, seconds)]: the LABELLED_GAPS longest gaps
    summed by the range each began in, the largest sum first."""
    dev = [(e["ts"], e["ts"] + e.get("dur", 0.0), e["name"]) for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    host = sorted((e["ts"], e["ts"] + e.get("dur", 0.0), e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in HOST_CATS)
    if window_us is None:
        window_us = (min(s for s, _, _ in dev), max(e for _, e, _ in dev)) if dev else (0.0, 0.0)
    lo, hi = window_us
    iv = [(max(s, lo), min(e, hi)) for s, e, _ in dev if e > lo and s < hi]
    ops = defaultdict(float)
    for s, e, name in dev:
        ops[name] += (e - s) / 1e6
    ranges = {"starts": [s for s, _, _ in host], "items": host}
    idle = defaultdict(float)
    for s, length in sorted(gaps(iv, lo, hi), key=lambda x: -x[1])[:LABELLED_GAPS]:
        idle[host_label(ranges, s)] += length / 1e6
    return dict(busy_s=union_length(iv) / 1e6, window_s=(hi - lo) / 1e6,
                device_ops=dict(ops),
                idle_gaps=sorted(idle.items(), key=lambda x: -x[1]))


def profile_job(run_job, out_dir: str):
    """Run `run_job()` under the profiler; returns (its result, the reduced
    trace, bytes of trace written).  The trace file is removed after it is
    read."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("benchmark.profiled_job"):
            result = run_job()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", dir=out_dir)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    job = [e for e in events if e.get("name") == "benchmark.profiled_job"
           and e.get("cat") in HOST_CATS]
    window = (job[0]["ts"], job[0]["ts"] + job[0]["dur"]) if job else None
    return result, reduce_trace(events, window), size
