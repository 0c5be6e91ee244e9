"""The one owner of the port's native libraries: it builds, loads, binds
and checks each of them.  The hand-written CUDA kernels of `csrc/*.cu` are
built with `nvcc` into `build/torch_kernels/`, the host engine of
`csrc/rips_host.cpp` + `csrc/wasserstein_host.cpp` with the host's C++
compiler into `build/torch_native/`: at first use, from the sources in the
checkout, one shared library with a plain C interface per (sources, flags),
named by a hash of both so a changed source or flag set builds anew.
Several libraries build side by side: `build_libraries` starts one
compiler per job, then waits for all of them.

`load(srcs, signatures, flags)` is the way every module of the port opens a
library: it builds it, opens it with ctypes, sets each entry point's types
from the launcher's `SIGNATURES` and keeps it in one cache, under one lock,
so every later call with the same sources and flags returns the same
object.  An instrumented build is the same sources with its `-D` flag.

`check_layout` holds what a library reports of its kernel (threads, shared
bytes, registers, occupancy) to the launcher's plan; `once_per_card` makes
a launcher's check run once per library, arguments and card.  A launch
pays a dict lookup for each."""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
SMEM_LIMIT = 232_448      # shared memory a block may use on an H100
REGS_PER_SM = 65_536

_lock = threading.Lock()
_libs: dict = {}          # (sources, flags) → the loaded library
_reports: dict = {}       # (check, library, its arguments, card) → checked report


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "the port's csrc/ on a machine with the CUDA toolkit")
    return path


def _cxx() -> str:
    path = shutil.which("g++") or shutil.which("c++")
    if path is None:
        raise RuntimeError("no C++ compiler found to build the port's host engine")
    return path


def _sources(srcs) -> tuple:
    if isinstance(srcs, Path):
        return (srcs,)
    return (Path(srcs),) if isinstance(srcs, str) else tuple(map(Path, srcs))


def _cuda(srcs: tuple) -> bool:
    return srcs[0].suffix == ".cu"


def library_path(srcs, flags=()) -> Path:
    """The .so of `srcs` (one source or several, compiled together) built
    with the compiler's flags + flags."""
    srcs = _sources(srcs)
    base, sub = (NVCC_FLAGS, "torch_kernels") if _cuda(srcs) else (CXX_FLAGS, "torch_native")
    h = hashlib.sha1()
    for src in srcs:
        h.update(src.read_bytes())
    h.update(" ".join(base + tuple(flags)).encode())
    return BUILD_DIR / sub / f"lib{srcs[0].stem}_{h.hexdigest()[:12]}.so"


def _start(srcs: tuple, flags):
    """(.so path, (running compiler, temporary output) or None if built)."""
    so = library_path(srcs, flags)
    if so.exists():
        return so, None
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    if _cuda(srcs):
        cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-Xptxas", "-v"]
    else:
        cmd = [_cxx(), *CXX_FLAGS, *flags]
    cmd += ["-o", str(tmp), *map(str, srcs)]
    return so, (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True), tmp)


def _finish(so: Path, started, verbose: bool) -> Path:
    if started is not None:
        proc, tmp = started
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(proc.args[0]).name} failed on {so.name} "
                               f"({proc.returncode}):\n{err}")
        os.replace(tmp, so)
        if verbose:
            print(err.strip())
    return so


def build_libraries(jobs, verbose: bool = False):
    """Build every (sources, flags) job, one compiler each, all started
    together.

    Returns (the .so paths in job order, wall seconds of the builds or None
    when every library was already built).  verbose prints each build's
    report (nvcc's `-Xptxas -v`: registers, shared memory, spills)."""
    t0 = time.perf_counter()
    started = [_start(_sources(srcs), tuple(flags)) for srcs, flags in jobs]
    sos = [_finish(so, st, verbose) for so, st in started]
    built = any(st is not None for _, st in started)
    return sos, (time.perf_counter() - t0 if built else None)


def build(srcs, flags=()) -> Path:
    """Build one library (once per source content and flags); its .so."""
    return build_libraries([(srcs, flags)])[0][0]


def load(srcs, signatures: dict, flags=()) -> ctypes.CDLL:
    """The library of `srcs` built with `flags`, built and opened at the
    first call, with each entry point's types set (signatures maps a symbol
    to (argtypes, restype)); the same object at every later call."""
    key = (_sources(srcs), tuple(flags))
    lib = _libs.get(key)
    if lib is None:
        with _lock:
            lib = _libs.get(key)
            if lib is None:
                lib = ctypes.CDLL(str(build(*key)))
                for symbol, (argtypes, restype) in signatures.items():
                    fn = getattr(lib, symbol)
                    fn.argtypes, fn.restype = argtypes, restype
                _libs[key] = lib
    return lib


def library_layout(lib, symbol: str, fields, *args) -> dict:
    """What a library reports of its kernel: `symbol(*args, int *out)`
    fills one int per field and returns a cudaError."""
    out = (ctypes.c_int * len(fields))()
    rc = getattr(lib, symbol)(*args, ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"{symbol}{args} failed: cudaError {rc}")
    return dict(zip(fields, out))


def check_layout(lib, symbol: str, fields, plan: dict, exact, src: Path, *args) -> dict:
    """The library's report (`library_layout(lib, symbol, fields, *args)`)
    against the plan: the `exact` fields must be the plan's, the shared
    bytes within a block's limit, a thread's registers within the plan's
    `reg_cap` (default: an SM's registers over the plan's threads), and the
    card's occupancy calculator must hold the plan's `occupancy` blocks an
    SM (default 1).  Raises on any disagreement; returns the report."""
    rep = library_layout(lib, symbol, fields, *args)
    bad = [k for k in exact if rep[k] != plan[k]]
    if rep.get("smem_bytes", 0) > SMEM_LIMIT:
        bad.append("smem_bytes")
    if rep["registers"] > plan.get("reg_cap", REGS_PER_SM // plan["threads"]):
        bad.append("registers")
    if rep["occupancy"] < plan.get("occupancy", 1):
        bad.append("occupancy")
    if bad:
        raise RuntimeError(f"kernel_plan and csrc/{Path(src).name} disagree"
                           f"{f' at {args}' if args else ''} on {bad}: "
                           f"library {rep}, plan {plan}")
    return rep


def once_per_card(check):
    """A launcher's layout check, `check(lib, *args)`, run once per library,
    arguments and card when called with `card` (a CUDA device index): later
    calls return the first report.  Without `card` it runs every time."""
    @functools.wraps(check)
    def checked(lib, *args, card: int | None = None):
        if card is None:
            return check(lib, *args)
        key = (check, lib, args, card)
        rep = _reports.get(key)
        if rep is None:
            rep = _reports[key] = check(lib, *args)
        return rep
    return checked
