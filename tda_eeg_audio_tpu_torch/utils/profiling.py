"""An optional device trace: a whole CLI command wrapped in a
`torch.profiler` trace written to a directory (`--profile`).  The spans'
timings come from `runtime.timed_spans`."""

from __future__ import annotations

import contextlib
from pathlib import Path


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
