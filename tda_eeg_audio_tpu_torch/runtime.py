"""Device resolution and numeric settings for the port.

Entry points take ``device=None`` (meaning CUDA) or an explicit device.  A
CUDA request without a card raises; nothing falls back to the CPU silently.
TF32 is off for matmuls and cuDNN convolutions so float32 products keep
full float32 precision (the reference computes them in float32).

`span(name, device)` marks a named part of an entry point: a
`torch.profiler` range always, and, inside `timed_spans()`, the part's wall
milliseconds between two device synchronisations (the only cost when on).
"""

from __future__ import annotations

import contextlib
import time

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` → CUDA.  Raises when CUDA is requested and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA requested but torch.cuda.is_available() is False; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


_span_ms = None         # {name: wall ms} while timed_spans() is active


@contextlib.contextmanager
def timed_spans():
    """Collect the wall milliseconds of every `span` run inside the block;
    yields the dict it fills (a name seen twice adds up)."""
    global _span_ms
    _span_ms = {}
    try:
        yield _span_ms
    finally:
        _span_ms = None


@contextlib.contextmanager
def span(name: str, device: torch.device):
    with torch.profiler.record_function(name):
        if _span_ms is None:
            yield
            return
        sync = torch.cuda.synchronize if device.type == "cuda" else (lambda d: None)
        sync(device)
        t0 = time.perf_counter()
        yield
        sync(device)
        _span_ms[name] = _span_ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
