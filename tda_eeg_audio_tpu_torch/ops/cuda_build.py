"""Build of the port's hand-written CUDA kernels: `nvcc` at first use, from
the sources in the checkout, into `build/torch_kernels/`, one shared library
with a plain C interface per (source, flags), named by a hash of both so a
changed source or flag set builds anew.  The launchers (`homology_cuda`,
`phase1_cuda`, `iir_cuda`, `wasserstein_cuda`, `sinkhorn_log_cuda`,
`wasserstein_h0_cuda`) load the libraries with ctypes.

Several libraries build side by side: `build_libraries` starts one `nvcc`
per job, then waits for all of them.

`load` and `check_layout` are the load-and-check steps a launcher shares:
bind a library's C entry points, then hold the layout its kernel reports
(threads, shared bytes, registers, occupancy) to the launcher's plan."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
SMEM_LIMIT = 232_448      # shared memory a block may use on an H100
REGS_PER_SM = 65_536


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "the port's csrc/ on a machine with the CUDA toolkit")
    return path


def library_path(src: Path, flags=()) -> Path:
    """The .so of `src` built with NVCC_FLAGS + flags."""
    all_flags = list(NVCC_FLAGS) + list(flags)
    tag = hashlib.sha1(src.read_bytes() + " ".join(all_flags).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}_{tag}.so"


def _start(src: Path, flags):
    """(.so path, (running nvcc, temporary output) or None if built)."""
    so = library_path(src, flags)
    if so.exists():
        return so, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-Xptxas", "-v", "-o", str(tmp), str(src)]
    return so, (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True), tmp)


def _finish(so: Path, started, verbose: bool) -> Path:
    if started is not None:
        proc, tmp = started
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {so.name} ({proc.returncode}):\n{err}")
        os.replace(tmp, so)
        if verbose:
            print(err.strip())
    return so


def build_libraries(jobs, verbose: bool = False):
    """Build every (source, flags) job, one nvcc each, all started together.

    Returns (the .so paths in job order, wall seconds of the builds or None
    when every library was already built).  verbose prints each build's
    `-Xptxas -v` report (registers, shared memory, spills)."""
    t0 = time.perf_counter()
    started = [_start(Path(src), tuple(flags)) for src, flags in jobs]
    sos = [_finish(so, st, verbose) for so, st in started]
    built = any(st is not None for _, st in started)
    return sos, (time.perf_counter() - t0 if built else None)


def load(src: Path, signatures: dict) -> ctypes.CDLL:
    """Build `src` (once per source content), load it and set each entry
    point's types: signatures maps a symbol to (argtypes, restype)."""
    lib = ctypes.CDLL(str(build_libraries([(src, ())])[0][0]))
    for symbol, (argtypes, restype) in signatures.items():
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def library_layout(lib, symbol: str, fields) -> dict:
    """What a library reports of its kernel: `symbol(int *out)` fills one
    int per field and returns a cudaError."""
    out = (ctypes.c_int * len(fields))()
    rc = getattr(lib, symbol)(ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"{symbol} failed: cudaError {rc}")
    return dict(zip(fields, out))


def check_layout(lib, symbol: str, fields, plan: dict, exact, src: Path) -> dict:
    """The library's report against the plan: the `exact` fields must be the
    plan's, the shared bytes within a block's limit, a block's registers
    within an SM's, and the card's occupancy calculator must hold a block.
    Raises on any disagreement; returns the report."""
    rep = library_layout(lib, symbol, fields)
    bad = [k for k in exact if rep[k] != plan[k]]
    if rep["smem_bytes"] > SMEM_LIMIT:
        bad.append("smem_bytes")
    if rep["registers"] * rep["threads"] > REGS_PER_SM:
        bad.append("registers")
    if rep["occupancy"] < 1:
        bad.append("occupancy")
    if bad:
        raise RuntimeError(f"kernel_plan and csrc/{Path(src).name} disagree on "
                           f"{bad}: library {rep}, plan {plan}")
    return rep
