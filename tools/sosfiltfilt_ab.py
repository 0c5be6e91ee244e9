#!/usr/bin/env python3
"""The sosfiltfilt kernel of this checkout against other builds of it, in
turns, in one call.

    python3 tools/sosfiltfilt_ab.py [--reps 20] [--out FILE] \
        [--threads 128,512] [--variant NAME=SOURCE[:THREADS][:FLAG,FLAG...]] ...

Needs one CUDA card and nvcc.  A variant is another copy of
`csrc/sosfiltfilt.cu`, built with the port's nvcc flags plus FLAGs and
launched with THREADS threads a block, so chunks of about
(T + 2·edge) / THREADS samples (default: `kernel_plan`'s).  A source
without `sosfiltfilt_layout` is read as the first design's interface (one
thread per chain, 32 a block, a float64 scratch of (T + 2·edge) × chains in
device memory), e.g. that earlier design saved from git history:

    git show d702a88:tda_eeg_audio_tpu_torch/csrc/sosfiltfilt.cu > build/sosfiltfilt_pr5.cu

`--threads` adds this build at other thread counts (chunk lengths).  On
chip_smoke.py phase 10's inputs — 2 ragged random-walk recordings, and the
first 16 and 64 recordings of phase 6's synthetic store (47 channels,
T_pad 5800) — it runs this build, the variants, the variants again in
reverse and this build again, and for each: the CUDA-event ms of a call
over --reps calls (what a caller waits for, the Python launcher included)
and the kernel's own device ms under torch.profiler, the largest error
against the plain recurrence (relative to each band's max|plain|), whether
the output is zero beyond n, the peak device memory a call adds, and the
registers, stack and local (spill) bytes of each kernel as `cuobjdump
--dump-resource-usage` reads them from the build.  One JSON line per
shape, with the bound (`iir_bound`); all of them also go to --out
(default build/sosfiltfilt_ab.json).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def parse_variant(text: str):
    name, _, rest = text.partition("=")
    src, _, rest = rest.partition(":")
    threads, _, flags = rest.partition(":")
    return name, Path(src), int(threads) if threads else None, \
        tuple(f for f in flags.split(",") if f)


def resource_usage(so: Path) -> dict:
    """Registers, stack and local bytes per kernel of a built library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        text = subprocess.run([tool, "--dump-resource-usage", str(so)],
                              capture_output=True, text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError) as exc:
        return {"error": str(exc)}
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)", line)
        if m and name:
            out[name] = dict(zip(("registers", "stack", "shared", "local"),
                                 map(int, m.groups())))
            name = None
    return out


def kernel_ms(fn, reps: int) -> float:
    """Device time of the sosfiltfilt kernel a call under torch.profiler
    (the launcher's host work and the small kernels around it excluded)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and "sosfiltfilt_kernel" in e.key:
            us += getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
    return us / reps / 1e3


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--threads", default="",
                    help="comma-separated thread counts of this build besides the plan's")
    ap.add_argument("--variant", action="append", default=[], type=parse_variant)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "sosfiltfilt_ab.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sosfiltfilt_ab: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import B_REC, card_line, cuda_ms, iir_bound, max_sm_clock_hz
    from tda_eeg_audio_tpu_torch.io.device_store import build_synthetic_device
    from tda_eeg_audio_tpu_torch.ops import cuda_build
    from tda_eeg_audio_tpu_torch.ops import iir_cuda as IC
    from tda_eeg_audio_tpu_torch.ops import signal as S

    builds = [("this", IC.SRC, IC.THREADS, ())]
    builds += [(f"this@{t}", IC.SRC, int(t), ()) for t in args.threads.split(",") if t]
    builds += args.variant
    jobs = list(dict.fromkeys((src.resolve(), flags) for _, src, _, flags in builds))
    built = dict(zip(jobs, cuda_build.build_libraries(jobs, verbose=True)[0]))
    P, I = ctypes.c_void_p, ctypes.c_int
    legacy_sig = {"sosfiltfilt_launch": ([P] * 6 + [I] * 6 + [P], I)}
    libs, usage = {}, {}
    for name, src, threads, flags in builds:
        so = built[(src.resolve(), flags)]
        legacy = "sosfiltfilt_layout" not in src.read_text()
        lib = cuda_build.load(src.resolve(), legacy_sig if legacy else IC.SIGNATURES, flags)
        libs[name] = (lib, legacy, threads or IC.THREADS)
        # the kernels at the bank's S = 4 sections
        usage[name] = {f: u for f, u in resource_usage(so).items() if "ILi4E" in f}

    dev = torch.device("cuda")
    sos, zi = S.design_butter_band_bank(250, 4)
    edge = S.sos_edge(sos)
    nb, n_sec = sos.shape[:2]
    sos_t, zi_t = torch.as_tensor(sos, device=dev), torch.as_tensor(zi, device=dev)

    def call(name, x, n):
        lib, legacy, threads = libs[name]
        if not legacy:
            return IC.sosfiltfilt_bank_cuda(x, n, sos, zi, edge, threads=threads, lib=lib)
        T = x.shape[-1]
        n_series = int(x[..., 0].numel())
        nlen = n.to(torch.int32).expand(x.shape[:-1]).contiguous()
        out = torch.empty((*x.shape[:-1], nb, T), dtype=torch.float32, device=dev)
        scratch = torch.empty((T + 2 * edge) * n_series * nb, dtype=torch.float64,
                              device=dev)
        rc = lib.sosfiltfilt_launch(x.data_ptr(), nlen.data_ptr(), sos_t.data_ptr(),
                                    zi_t.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                                    n_series, nb, n_sec, T, edge, 32,
                                    torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"legacy sosfiltfilt_launch failed: cudaError {rc}")
        return out

    store = build_synthetic_device(n_subjects=6, n_per_subject=8, device=dev)
    T = store.eeg.shape[-1]
    gen = torch.Generator(device=dev).manual_seed(11)
    xr = (torch.cumsum(torch.randn((2, 47, T), generator=gen, device=dev), -1)
          + torch.randn((2, 47, T), generator=gen, device=dev))
    nr = torch.full((2, 47), T, dtype=torch.int64, device=dev)
    nr[1] = 4100
    nr[1, 46] = edge - 7
    xr = torch.where(torch.arange(T, device=dev) < nr[..., None], xr, 0.0).contiguous()
    n64 = torch.as_tensor(store.ns_e[:64], device=dev).long()[:, None]
    shapes = {"ragged": (xr, nr),
              "main": (store.eeg[:B_REC].contiguous(), n64[:B_REC]),
              "main64": (store.eeg[:64].contiguous(), n64)}
    del store
    clock_hz = max_sm_clock_hz()

    out = [dict(card=card_line(), torch=torch.__version__, resource_usage=usage)]
    print(json.dumps(out[0]), flush=True)
    order = [b[0] for b in builds] + [b[0] for b in reversed(builds)]
    ok = True
    for shape, (x, n) in shapes.items():
        plain = S.bandpass_bank_iir_plain(x, n, sos, zi)
        red = tuple(i for i in range(plain.dim()) if i != plain.dim() - 2)
        scale = plain.abs().amax(dim=red).clamp(min=1e-30)
        beyond = torch.arange(T, device=dev) >= n[..., None, None]
        rows = {}
        for name in order:
            got = call(name, x, n)
            rel = float(((got - plain).abs().amax(dim=red) / scale).max())
            zeros = bool((got.masked_select(beyond.expand(got.shape)) == 0).all())
            ok &= rel <= 1e-6 and zeros
            del got
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            call(name, x, n)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            ms = cuda_ms(lambda: call(name, x, n), args.reps)
            k_ms = kernel_ms(lambda: call(name, x, n), args.reps)
            _, legacy, threads = libs[name]
            row = dict(ms=ms, kernel_ms=k_ms, max_rel_err=rel, zeros_beyond_n=zeros,
                       peak_bytes=peak)
            if legacy:
                row.update(threads=32, staging="device")
            else:
                plan = IC.kernel_plan(int(x[..., 0].numel()), nb, T, edge, n_sec, threads)
                row.update(threads=threads, chunk=plan["chunk"], staging=plan["staging"],
                           layout=IC.check_layout(libs[name][0], n_sec, plan["threads"],
                                                  plan["shared_bytes"],
                                                  plan["staging"] == "device"))
            rows.setdefault(name, []).append(row)
        del plain
        bound = iir_bound(n.expand(x.shape[:-1]), T, nb, n_sec, edge, clock_hz)
        rec = dict(shape=shape, chains=int(x[..., 0].numel()) * nb, reps=args.reps,
                   bound_ms=max(bound["t_bytes"], bound["t_ops"]),
                   t_bytes=bound["t_bytes"], t_ops=bound["t_ops"], builds=rows)
        out.append(rec)
        print(json.dumps(rec), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(dict(ok=bool(ok))))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
