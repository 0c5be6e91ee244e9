"""Build of the port's hand-written CUDA kernels: `nvcc` at first use, from
the sources in the checkout, into `build/torch_kernels/`, one shared library
with a plain C interface per (source, flags), named by a hash of both so a
changed source or flag set builds anew.  The wrappers (`homology_cuda`,
`iir_cuda`) load the libraries with ctypes.

Several libraries build side by side: `build_libraries` starts one `nvcc`
per job, then waits for all of them."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


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
