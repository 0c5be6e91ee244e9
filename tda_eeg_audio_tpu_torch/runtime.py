"""Device resolution and numeric settings for the port.

Entry points take ``device=None`` (meaning CUDA) or an explicit device.  A
CUDA request without a card raises; nothing falls back to the CPU silently.
TF32 is off for matmuls and cuDNN convolutions so float32 products keep
full float32 precision (the reference computes them in float32).

Tracing, the port's one facility.  `span(name, device)` marks a named part
of the program: a `torch.profiler` range always, and, inside a
`timed_spans()` block, the part's wall milliseconds between two device
synchronisations, its calls, its parent (the innermost enclosing span of
its first call) and its self milliseconds (its own less what its direct
children cover).  `logged_span` is a span whose seconds also go to the
structured log as a `stage` event; it synchronises while the logger is on.
`count(name, value)` adds to a counter of the block; a device tensor
accumulates on its device and is read to the host once, when the block
closes.  Outside a block a span costs its profiler range and no
synchronisation, and a count one check of a module global.
`last_record()` returns the whole record of the last block that closed.
`host_waits(name, device)` counts, inside a block, the implicit
synchronisations of a part of the program (a host wait for the card) into
the counter `name`; the spans' own synchronisations are not counted.

Uploads without a host wait: `to_device` copies a host array to a CUDA
device through pinned memory and returns at once; `device_constant` builds
a constant (a filter design, an index list) once per (device, parameters)
and keeps it there.

Multi-process runs: `init_distributed` joins a `torch.distributed` group
(one process per card, or several processes on the CPU), `process_shard`
gives each process its slice of a work list.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
import warnings
from collections import defaultdict

import numpy as np
import torch
import torch.distributed as dist

from .utils import logging as tlog

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


class _Record:
    """What one `timed_spans()` block collects."""

    def __init__(self):
        self.ms = {}                    # {name: wall ms}, the block's yield
        self.calls = defaultdict(int)
        self.self_ms = defaultdict(float)
        self.parent = {}                # name → the parent of its first call
        self.open = []                  # [name, ms of direct children] a span
        self.counters = defaultdict(dict)   # name → {device or None: sum}
        self.waits_open = False         # a host_waits() block has warn mode on

    def close(self) -> dict:
        counters = {}
        for name, parts in self.counters.items():
            counters[name] = sum(v.item() if isinstance(v, torch.Tensor) else v
                                 for v in parts.values())
        return dict(spans={n: dict(ms=ms, calls=self.calls[n], self_ms=self.self_ms[n],
                                   parent=self.parent[n]) for n, ms in self.ms.items()},
                    counters=counters)


class _Timing:
    """A span's handle: its wall ms once it closed timed, else None."""
    __slots__ = ("ms",)

    def __init__(self):
        self.ms = None

    @property
    def seconds(self):
        return None if self.ms is None else self.ms / 1e3


_UNTIMED = _Timing()    # shared by every untimed span; never written
_record = None          # the active timed_spans() block's _Record
_last = None            # the record of the last block that closed


@contextlib.contextmanager
def timed_spans():
    """Collect every `span` and `count` run inside the block; yields the
    {name: wall ms} dict it fills (a name seen twice adds up).  The whole
    record is `last_record()` once the block has closed."""
    global _record, _last
    if _record is not None:
        raise RuntimeError("timed_spans blocks do not nest")
    _record = rec = _Record()
    try:
        yield rec.ms
    finally:
        _record = None
        _last = rec.close()


def last_record():
    """The last closed block's record, or None: {"spans": {name: {"ms",
    "calls", "self_ms", "parent"}}, "counters": {name: value}}."""
    return _last


def counting() -> bool:
    """Whether a `timed_spans()` block is active (so that a caller computes
    a counter's value only when it is recorded)."""
    return _record is not None


def count(name: str, value) -> None:
    """Add `value` (a number, or a tensor that stays on its device until the
    block closes) to the counter `name`; nothing outside a block."""
    if _record is None:
        return
    parts = _record.counters[name]
    key = value.device if isinstance(value, torch.Tensor) else None
    parts[key] = parts[key] + value if key in parts else value


@contextlib.contextmanager
def _span(name: str, device: torch.device, timed: bool):
    with torch.profiler.record_function(name):
        if not timed:
            yield _UNTIMED
            return
        rec, t = _record, _Timing()
        cuda = device.type == "cuda"
        if rec is not None:
            rec.parent.setdefault(name, rec.open[-1][0] if rec.open else None)
            frame = [name, 0.0]
            rec.open.append(frame)
        if cuda:
            _span_sync(device, rec)
        t0 = time.perf_counter()
        try:
            yield t
        finally:
            if rec is not None:
                rec.open.pop()
        if cuda:
            _span_sync(device, rec)
        t.ms = (time.perf_counter() - t0) * 1e3
        if rec is not None:
            rec.ms[name] = rec.ms.get(name, 0.0) + t.ms
            rec.calls[name] += 1
            rec.self_ms[name] += t.ms - frame[1]
            if rec.open:
                rec.open[-1][1] += t.ms


def _span_sync(device: torch.device, rec) -> None:
    """A timed span's synchronisation, left out of an open `host_waits`'
    count."""
    if rec is None or not rec.waits_open:
        torch.cuda.synchronize(device)
        return
    torch.cuda.set_sync_debug_mode(0)
    try:
        torch.cuda.synchronize(device)
    finally:
        torch.cuda.set_sync_debug_mode("warn")


SYNC_WARNING = "called a synchronizing CUDA operation"


@contextlib.contextmanager
def host_waits(name: str, device: torch.device):
    """Inside a `timed_spans()` block, count into the counter `name` every
    implicit synchronisation the enclosed code makes on a CUDA device (a
    blocking copy, `.item()`, a data-dependent shape), as
    `torch.cuda.set_sync_debug_mode("warn")` reports them; a timed span's
    own synchronisations are not counted, and its other warnings pass on.
    On the CPU the count is 0: no card to wait for.  Outside a block it
    does nothing."""
    if _record is None:
        yield
        return
    if device.type != "cuda":
        yield
        count(name, 0)
        return
    rec, mode = _record, torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        rec.waits_open = True
        try:
            yield
        finally:
            rec.waits_open = False
            torch.cuda.set_sync_debug_mode(mode)
    waits = [w for w in caught if SYNC_WARNING in str(w.message)]
    for w in caught:            # the block's other warnings, as they were
        if w not in waits:
            warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
    count(name, len(waits))


def to_device(array, device: torch.device, dtype=None) -> torch.Tensor:
    """A host array as a tensor on `device` (of `dtype`, else its own):
    on a CUDA device through pinned memory and a non-blocking copy, so the
    host does not wait for the card; on the CPU `torch.as_tensor`."""
    t = torch.as_tensor(np.asarray(array), dtype=dtype)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


@functools.lru_cache(maxsize=None)
def device_constant(design, device: torch.device, dtype, *args) -> torch.Tensor:
    """`design(*args)` (a host array) as a `dtype` tensor on `device`,
    built once per (design, device, dtype, args) and kept; the caller must
    not write to it."""
    return to_device(design(*args), device, dtype)


def span(name: str, device: torch.device):
    """A named part of the program; yields its handle (`.ms` once it closed
    inside a block, else None)."""
    return _span(name, device, _record is not None)


@contextlib.contextmanager
def logged_span(name: str, device: torch.device, **fields):
    """A span whose seconds go to the structured log as a `stage` event
    named after it, with `fields`; yields that dict, for what the part
    learns on its way (item counts).  It synchronises while the logger is
    on, as inside a block."""
    with _span(name, device, _record is not None or tlog.LOGGER.enabled) as t:
        yield fields
    tlog.LOGGER.stage(name, t.seconds, **fields)


def process_rank_world(group=None) -> tuple[int, int]:
    """(this process's rank, the number of processes); (0, 1) outside a
    `torch.distributed` group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(group), dist.get_world_size(group)
    return 0, 1


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, device=None) -> dict:
    """Join a multi-process run: the data-parallel entry, one process per
    card (the reference scales only by env-var batch slicing with partial
    files, tda_eeg_classification_v2.py:54-60,608-668).

    The arguments default to torchrun's environment: MASTER_ADDR:MASTER_PORT,
    WORLD_SIZE, RANK.  One process (nothing configured, or
    num_processes == 1) is a no-op.  Otherwise the process joins a gloo group
    at tcp://coordinator as rank process_id, once.  gloo, not NCCL: every
    payload here is kilobytes (feature rows, subject deltas) and the bulk
    travels in the partial files, so the collectives copy their small
    tensors to the host and back — transport only, the compute stays on the
    card.  When `device` asks for CUDA, the process is bound to
    cuda:{(LOCAL_RANK or process_id) % device_count}, so several processes
    on one host share its cards round robin.

    Returns {"process_id", "num_processes", "local_devices", "devices"}: the
    port computes on one device per process, so local_devices is 1 and
    devices the number of processes."""
    if coordinator is None and "MASTER_ADDR" in os.environ:
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if (num_processes or 1) > 1 and not dist.is_initialized():
        if coordinator is None or process_id is None:
            raise ValueError("a multi-process run needs the coordinator's "
                             "host:port and this process's id")
        on_cuda = device is not None and resolve_device(device).type == "cuda"
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)
        if on_cuda:
            local = int(os.environ.get("LOCAL_RANK", process_id))
            torch.cuda.set_device(local % torch.cuda.device_count())
    rank, world = process_rank_world()
    return dict(process_id=rank, num_processes=world, local_devices=1,
                devices=world)


def process_shard(n_items: int) -> tuple[int, int]:
    """This process's [start, end) slice of an n_items work list — the
    multi-process replacement for the reference's manual BATCH_START /
    BATCH_END env vars: deterministic, balanced (ceil(n / p) per process),
    gap-free, in rank order."""
    rank, world = process_rank_world()
    per = -(-n_items // world)
    return min(rank * per, n_items), min((rank + 1) * per, n_items)
