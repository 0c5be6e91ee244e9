#!/usr/bin/env python3
"""The un-tiered Sinkhorn kernel (A, `csrc/sinkhorn_log.cu`) and the exact H0
DP kernel (B, `csrc/wasserstein_h0.cu`) of this checkout against other
builds of them, in turns, in one call.

    python3 tools/wasserstein_kernels_ab.py [--reps 5] [--out FILE] [--no-study] \
        [--old-a SOURCE] [--old-b SOURCE] \
        [--variant-a NAME=SOURCE[:FLAG,FLAG...]] [--variant-b NAME=SOURCE[:FLAG...]]

Needs one CUDA card and nvcc.  `--old-a` / `--old-b` name the first designs
of both kernels (default build/sinkhorn_log_old.cu and
build/wasserstein_h0_old.cu, saved from git history beforehand, since a
copy of the checkout without .git cannot read them):

    git show 4bdce37:tda_eeg_audio_tpu_torch/csrc/sinkhorn_log.cu > build/sinkhorn_log_old.cu
    git show 4bdce37:tda_eeg_audio_tpu_torch/csrc/wasserstein_h0.cu > build/wasserstein_h0_old.cu

A variant is another copy of a kernel's source with the same C interface
(`sinkhorn_log_launch` / `_layout`, `wasserstein_h0_launch` / `_layout`),
built with the port's nvcc flags plus FLAGs (a -D macro such a copy
reads); every library builds side by side.

Sets.  Kernel A: `control`, the pairs chip_smoke.py phase 6's control redo
hands it (96 recordings at batch 16); `seeded`, phase 13's 112 seeded pairs;
`study`, the pairs of the full synthetic study's control redo (1,440
recordings, bench_torch.py's seed and knobs, batch 64), captured by wrapping
`StudyRunner._wass_chunks` here.  Kernel B: `main`, the 1,200 pairs (46 ×
123) of phase 4's comparison batch of 16 recordings; `study`, the 4,800
pairs of the study's first comparison batch of 64 recordings.  `--no-study`
leaves the study out (no 1,440-recording store).

For each set it runs this build, the others, the others again in reverse and
this build again, and for each: the CUDA-event ms of a call over --reps calls
(the Python launcher included), the largest relative difference from the
plain version and (A) from a float64 run of it, the gates of chip_smoke.py's
phase 13 (A: within 1e-4 of float64 on every pair, within 2e-4 of plain on
the pairs where plain is within 1e-4 of float64, the same NaN / inf; B:
within rtol 1e-6 of the card's plain loop, finite, and bit for bit the CPU's
plain loop as a reading), and the library's layout.  Beside kernel B, an
empty kernel's launch through ctypes (1 block, and B's grid of 128-thread
blocks) as the launch floor.  One JSON line per set with the pairs' widths
(A: S = n1 + n2, the lanes a line) and the bound; all of them also go to
--out (default build/wasserstein_kernels_ab.json).  Exit 1 if this build
misses a gate.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

EMPTY_SRC = """#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int grid, int threads, void* stream) {
  empty_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
"""


def parse_variant(text: str):
    name, _, rest = text.partition("=")
    src, _, flags = rest.partition(":")
    return name, Path(src), tuple(f for f in flags.split(",") if f)


def study_sets(dev):
    """(the control redo's pairs, the first comparison batch's H0 pairs) of
    the full synthetic study at bench_torch.py's seed and knobs."""
    import torch

    from tda_eeg_audio_tpu_torch import tuning
    from tda_eeg_audio_tpu_torch.config import DEFAULT_CONFIG
    from tda_eeg_audio_tpu_torch.io.device_store import build_synthetic_device
    from tda_eeg_audio_tpu_torch.models import programs as P
    from tda_eeg_audio_tpu_torch.models.study import StudyRunner
    from chip_smoke import capture_calls

    cfg = dataclasses.replace(DEFAULT_CONFIG, wasserstein_backend="sinkhorn")
    ds = build_synthetic_device(n_subjects=45, n_per_subject=16, seed=42)
    with tempfile.TemporaryDirectory() as td:
        runner = StudyRunner(ds, cfg, eeg_batch=tuning.EEG_BATCH, eeg_bank=tuning.EEG_BANK,
                             feature_na_max=tuning.FEATURE_NA_MAX, results_dir=td,
                             verbose=False)
        runner.compute_feature_dataset()
        _, (h0_calls,) = capture_calls(lambda: runner.run_comparison(n_permutations=1000),
                                       (P, "wasserstein_h0_exact"))
        wass, route = [], StudyRunner._wass_chunks

        def keep(self, *pairs):
            wass.append(tuple(x.clone() for x in pairs))
            return route(self, *pairs)

        StudyRunner._wass_chunks = keep
        try:
            runner.run_control()
        finally:
            StudyRunner._wass_chunks = route
    ctl = tuple(torch.cat([c[k] for c in wass]) for k in range(6))
    del ds
    torch.cuda.empty_cache()
    return ctl, h0_calls[0], len(wass)


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--old-a", type=Path, default=ROOT / "build" / "sinkhorn_log_old.cu")
    ap.add_argument("--old-b", type=Path, default=ROOT / "build" / "wasserstein_h0_old.cu")
    ap.add_argument("--variant-a", action="append", default=[], type=parse_variant)
    ap.add_argument("--variant-b", action="append", default=[], type=parse_variant)
    ap.add_argument("--no-study", action="store_true")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "wasserstein_kernels_ab.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wasserstein_kernels_ab: no CUDA device", file=sys.stderr)
        return 2
    for old in (args.old_a, args.old_b):
        if not old.exists():
            print(f"wasserstein_kernels_ab: {old} missing (save it with git show; see the "
                  f"script's doc)", file=sys.stderr)
            return 2
    from chip_smoke import (B_REC, K_FEAT, H0_RTOL, SINKHORN_LOG_F64_RTOL, SINKHORN_LOG_RTOL,
                            capture_calls, card_line, cuda_ms, main_path, max_sm_clock_hz,
                            plain_sinkhorn_log, runner_phase, sinkhorn_log_bound,
                            sinkhorn_log_seeded_pairs, HBM_BYTES_PER_S, FP32_FLOPS_PER_S)
    from tda_eeg_audio_tpu_torch.config import DEFAULT_CONFIG
    from tda_eeg_audio_tpu_torch.io.device_store import build_synthetic_device
    from tda_eeg_audio_tpu_torch.io.synthetic import SynthDataset, load_batch
    from tda_eeg_audio_tpu_torch.models import programs as P
    from tda_eeg_audio_tpu_torch.models import study as study_mod
    from tda_eeg_audio_tpu_torch.ops import cuda_build
    from tda_eeg_audio_tpu_torch.ops import sinkhorn_log_cuda as SL
    from tda_eeg_audio_tpu_torch.ops import wasserstein_h0_cuda as WH
    from tda_eeg_audio_tpu_torch.ops.wasserstein import wasserstein_h0_exact_plain

    builds_a = [("this", SL.SRC, ()), ("old", args.old_a, ())] + args.variant_a
    builds_b = [("this", WH.SRC, ()), ("old", args.old_b, ())] + args.variant_b
    empty = ROOT / "build" / "empty_kernel.cu"
    empty.parent.mkdir(parents=True, exist_ok=True)
    empty.write_text(EMPTY_SRC)
    jobs = [(src.resolve(), flags) for _, src, flags in builds_a + builds_b] + [(empty, ())]
    unique = list(dict.fromkeys(jobs))          # one nvcc per library
    cuda_build.build_libraries(unique, verbose=True)
    libs_a = {n: cuda_build.load(s.resolve(), SL.SIGNATURES, f) for n, s, f in builds_a}
    libs_b = {n: cuda_build.load(s.resolve(), WH.SIGNATURES, f) for n, s, f in builds_b}
    lib_e = cuda_build.load(empty, {"empty_launch": (
        [ctypes.c_int, ctypes.c_int, ctypes.c_void_p], ctypes.c_int)})

    ladder = SL.eps_ladder()

    def run_a(lib, pairs):
        b1, d1, m1, b2, d2, m2 = (x.contiguous() for x in pairs)
        N, K1 = b1.shape
        out = torch.empty(N, dtype=torch.float32, device=b1.device)
        rc = lib.sinkhorn_log_launch(
            b1.data_ptr(), d1.data_ptr(), m1.data_ptr(), K1, b2.data_ptr(), d2.data_ptr(),
            m2.data_ptr(), b2.shape[1], N, ladder.ctypes.data_as(ctypes.c_void_p), SL.STEPS,
            SL.EPS_LO, SL.ITERS, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"sinkhorn_log_launch failed: cudaError {rc}")
        return out

    def run_b(lib, args_):
        d1, m1, d2, m2 = args_
        N = d1.shape[0]
        out = torch.empty(N, dtype=torch.float32, device=d1.device)
        rc = lib.wasserstein_h0_launch(
            d1.data_ptr(), m1.data_ptr(), d1.stride(0), m1.stride(0), d1.shape[1],
            d2.data_ptr(), m2.data_ptr(), d2.stride(0), m2.stride(0), d2.shape[1], N,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"wasserstein_h0_launch failed: cudaError {rc}")
        return out

    dev = torch.device("cuda")
    cfg = DEFAULT_CONFIG
    clock_hz = max_sm_clock_hz()
    head = dict(card=card_line(), torch=torch.__version__, cuda=torch.version.cuda,
                reps=args.reps,
                layouts_a={n: cuda_build.library_layout(lib, "sinkhorn_log_layout",
                                                        SL.LAYOUT_FIELDS)
                           for n, lib in libs_a.items()},
                layouts_b={n: cuda_build.library_layout(lib, "wasserstein_h0_layout",
                                                        WH.LAYOUT_FIELDS)
                           for n, lib in libs_b.items()})
    out = [head]
    print(json.dumps(head), flush=True)

    # the sets: phase 4's batch (B main), phase 6's control redo (A control)
    batch = load_batch(SynthDataset(n_subjects=8, n_per_subject=1, cfg=cfg),
                       list(range(B_REC)), K_FEAT, cfg)
    perm = np.arange(B_REC) ^ 1
    mis = dict(audio=batch["audio"][perm], n_a=batch["n_a"][perm])
    _, (h0_calls,) = capture_calls(lambda: main_path(batch, mis, cfg, dev),
                                   (P, "wasserstein_h0_exact"))
    store = build_synthetic_device(n_subjects=6, n_per_subject=8, device=dev)
    cut = 10_937                             # as chip_smoke.py's phase 6
    store.audio[0, store.ns_a[0] - cut:store.ns_a[0]] = 0.0
    store.ns_a[0] -= cut
    _, (wass_calls,) = capture_calls(lambda: runner_phase(store, cfg),
                                     (study_mod, "sinkhorn_cost_pairs"))
    del store
    sets_a = {"control": tuple(torch.cat([c[k] for c in wass_calls]) for k in range(6)),
              "seeded": sinkhorn_log_seeded_pairs(dev)}
    sets_b = {"main": h0_calls[-1]}
    if not args.no_study:
        ctl, h0_study, n_calls = study_sets(dev)
        sets_a["study"], sets_b["study"] = ctl, h0_study
        head["study_control_calls"] = n_calls
    torch.cuda.synchronize()

    ok = True
    order_a = [b[0] for b in builds_a] + [b[0] for b in reversed(builds_a)]
    for name, pairs in sets_a.items():
        ref = plain_sinkhorn_log(pairs).double().cpu()
        r64 = plain_sinkhorn_log([x.double() if x.is_floating_point() else x
                                  for x in pairs]).cpu()
        fin = torch.isfinite(ref)
        nz = fin & (ref != 0)
        sound = nz & ((ref - r64).abs() <= SINKHORN_LOG_F64_RTOL * r64.abs())
        S = (torch.clamp(pairs[2].sum(1), min=1) + torch.clamp(pairs[5].sum(1), min=1)).cpu()
        L = torch.tensor([SL.lanes(int(s)) for s in S])
        rows = {}
        for b in order_a:
            got = run_a(libs_a[b], pairs).double().cpu()
            rel_p = ((got - ref).abs() / ref.abs())
            rel_64 = ((got - r64).abs() / r64.abs())
            row = dict(
                ms=cuda_ms(lambda: run_a(libs_a[b], pairs), args.reps),
                max_rel_vs_plain_sound=float(rel_p[sound].max()) if sound.any() else 0.0,
                max_rel_vs_plain=float(rel_p[nz].max()) if nz.any() else 0.0,
                max_rel_vs_float64=float(rel_64[nz].max()) if nz.any() else 0.0,
                same_nonfinite=bool(torch.equal(torch.isfinite(got), fin)))
            row["gates"] = (row["same_nonfinite"]
                            and row["max_rel_vs_float64"] <= SINKHORN_LOG_F64_RTOL
                            and row["max_rel_vs_plain_sound"] <= SINKHORN_LOG_RTOL)
            ok &= row["gates"] or b != "this"
            rows.setdefault(b, []).append(row)
        bound = sinkhorn_log_bound(pairs, clock_hz)
        rec = dict(kernel="sinkhorn_log", set=name, pairs=int(S.numel()),
                   S_mean=float(S.double().mean()), S_max=int(S.max()),
                   pairs_by_lanes={int(l): int((L == l).sum()) for l in (8, 4, 2, 1)},
                   sound_pairs=int(sound.sum()), bound_ms=max(bound["t_ops"], bound["t_bytes"]),
                   bound_ms_at_pad_width=bound["t_ops_pad"], builds=rows)
        out.append(rec)
        print(json.dumps(rec), flush=True)

    order_b = [b[0] for b in builds_b] + [b[0] for b in reversed(builds_b)]
    stream = torch.cuda.current_stream().cuda_stream
    for name, args_ in sets_b.items():
        ref = wasserstein_h0_exact_plain(*args_).double().cpu()
        cpu = wasserstein_h0_exact_plain(*(x.cpu() for x in args_))
        N, K1, K2 = args_[0].shape[0], args_[0].shape[1], args_[2].shape[1]
        halves = (torch.sort(torch.where(args_[3], args_[2], 0.0), dim=1).values / 2).cpu().numpy()
        exact = sum(WH.scan_is_exact(h) for h in halves)
        rows = {}
        for b in order_b:
            got = run_b(libs_b[b], args_)
            g = got.double().cpu()
            err = (g - ref).abs()
            row = dict(ms=cuda_ms(lambda: run_b(libs_b[b], args_), args.reps * 4),
                       max_abs_err=float(err.max()),
                       within=bool((err <= H0_RTOL * ref.abs()).all()),
                       finite=bool(torch.isfinite(g).all()),
                       bit_for_bit_vs_cpu=bool(torch.equal(got.cpu(), cpu)))
            ok &= (row["within"] and row["finite"]) or b != "this"
            rows.setdefault(b, []).append(row)
        grid = -(-N // WH.WARPS)
        lib_e.empty_launch(grid, WH.THREADS, stream)        # the first launch loads it
        floor = {f"grid_{gr}": cuda_ms(lambda: lib_e.empty_launch(gr, WH.THREADS, stream),
                                       args.reps * 4) for gr in (1, grid)}
        ops = N * (8 * K1 * (K2 + 1) + K1 * max(K1 - 1, 1).bit_length()
                   + K2 * max(K2 - 1, 1).bit_length())
        rec = dict(kernel="wasserstein_h0", set=name, pairs=N, K=(K1, K2),
                   scan_exact_pairs=int(exact), empty_launch_ms=floor,
                   bound_ms=max(ops / FP32_FLOPS_PER_S, (N * (K1 + K2) * 5 + N * 4)
                                / HBM_BYTES_PER_S) * 1e3, builds=rows)
        out.append(rec)
        print(json.dumps(rec), flush=True)

    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(dict(ok=bool(ok))))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
