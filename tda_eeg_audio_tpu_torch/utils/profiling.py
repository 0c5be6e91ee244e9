"""Per-stage wall timers and an optional device trace.

Every stage of a CLI command reports into a `StageTimes` registry
(`GLOBAL_TIMES`, dumped as stage_times.json by `--profile`), and the whole
command can be wrapped in a `torch.profiler` trace written to a directory.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from pathlib import Path


class StageTimes:
    """Accumulates per-stage wall time and item counts → items/s reports."""

    def __init__(self):
        self.t = defaultdict(float)
        self.n = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.t[name] += time.perf_counter() - t0
            self.n[name] += items

    def report(self) -> dict:
        out = {}
        for k in self.t:
            r = {"seconds": round(self.t[k], 3)}
            if self.n[k]:
                r["items"] = self.n[k]
                r["items_per_sec"] = round(self.n[k] / max(self.t[k], 1e-9), 1)
            out[k] = r
        return out

    def dump(self, path) -> None:
        Path(path).write_text(json.dumps(self.report(), indent=2))


GLOBAL_TIMES = StageTimes()


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """Wrap a block in a `torch.profiler` trace of the host and, where a card
    is present, the device; the Chrome trace is written to
    `log_dir/trace.json` (a no-op when log_dir is None)."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))
