"""Device resolution and numeric settings for the port.

Entry points take ``device=None`` (meaning CUDA) or an explicit device.  A
CUDA request without a card raises; nothing falls back to the CPU silently.
TF32 is off for matmuls and cuDNN convolutions so float32 products keep
full float32 precision (the reference computes them in float32).

`span(name, device)` marks a named part of an entry point: a
`torch.profiler` range always, and, inside `timed_spans()`, the part's wall
milliseconds between two device synchronisations (the only cost when on).

Multi-process runs: `init_distributed` joins a `torch.distributed` group
(one process per card, or several processes on the CPU), `process_shard`
gives each process its slice of a work list.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
import torch.distributed as dist

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
