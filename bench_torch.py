#!/usr/bin/env python3
"""Benchmarks of the PyTorch/CUDA port (`tda_eeg_audio_tpu_torch`).

    python3 bench_torch.py [--smoke] [--repeats N] [--no-bank] [--seed S] [--spans]
    python3 bench_torch.py --eeg-throughput [--recordings R] [--windows K]

Full study (the default): on one CUDA card, per-recording features (EEG
Rips H0 + H1 in 5 bands), the EEG↔audio comparison and the
matched/mismatched control (audio Takens diagrams, window-paired
Wasserstein, Wilcoxon / sign-flip / FDR), on the synthetic dataset
generated into device memory before the clock starts (45 subjects × 32
recordings; `--smoke`: 3 × 4).  A fresh runner per repeat; each stage is
timed between two `torch.cuda.synchronize()` calls.  The batch, the bank
and the feature arena width are the knobs of `tda_eeg_audio_tpu_torch/
tuning.py` (`TDA_TORCH_*` variables override them); `--no-bank` forces the
bank off.  After every completed repeat one JSON line is printed (the last
line wins): `metric: full_study_seconds`, `value` (best repeat), `runs`,
`checks`, the knobs with the source of each, the ingest seconds and the
card's name and power limit.  `--spans` adds one more repeat under
`runtime.timed_spans()`, outside `value`: its line gains `spanned`, that
repeat's stage seconds and the wall ms of every span summed over the study
(the comparison's parts; the control's `control_fused_rows`,
`control_deviant_scan`, `control_mismatch_cache`, `control_exact_rows` with
`control_own_diagrams` and `control_wass_h1` inside it, `control_stats`).
Every span synchronises the card, so its stage seconds are not the
benchmark's.  Run from another checkout (`python3 <tree>/bench_torch.py`),
it reads that checkout's port: parent and change in one call.  The host
Random-Forest stage is not part of the study's clock.

`--eeg-throughput`: the EEG feature pass alone in windows/s, the unit of
BASELINE.json's metric — R recordings (default 64) of band-mixture EEG (5
oscillators at 2, 6, 10.5, 22 and 41 Hz with random phase and amplitude, a
mix per channel, 0.7 × Gaussian noise; 47 channels, T_pad 5800) with K
distinct windows drawn per recording and band (default 40), through
`eeg_feature_program` at its default arena width: one warm pass, then
`--repeats` timed passes of EEG synthesis plus the program, each between
two `torch.cuda.synchronize()` calls.  The EEG is drawn on the card from a
`torch.Generator` seeded by `--seed`, so its samples differ from those of
the JAX package's `bench.py --eeg-throughput`, whose construction this
copies.  `vs_baseline` divides by the host engine's windows/s
(`native.engine.rips_persistence_batch`) on the first min(512, windows)
of the same distance matrices.  One JSON line,
`metric: eeg_windows_per_sec_per_chip`.

Both modes need the card: they exit non-zero without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import tempfile
import time

from tda_eeg_audio_tpu_torch import tuning

# --eeg-throughput's shape: bench.py's (T_pad, windows per recording, channels)
T_PAD, N_WIN, N_CH = 5800, 90, 47
OSC_HZ = (2.0, 6.0, 10.5, 22.0, 41.0)
HOST_WINDOWS = 512


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def _sync_time(dev) -> float:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter()


def synth_eeg(b: int, gen, dev, fs: float):
    """(b, 47, T_PAD) band-mixture EEG drawn from `gen` on `dev`: five
    shared oscillators with random phase and amplitude, mixed into each
    channel with its own weight, plus 0.7 × unit Gaussian noise."""
    import math

    import torch

    t = torch.arange(T_PAD, device=dev, dtype=torch.float32) / fs
    freqs = torch.tensor(OSC_HZ, device=dev)
    n_osc = len(OSC_HZ)
    phase = torch.rand((b, n_osc, 1), generator=gen, device=dev) * (2 * math.pi)
    amp = 0.5 + torch.rand((b, n_osc, 1), generator=gen, device=dev)
    drive = torch.sum(amp * torch.sin(2 * math.pi * freqs[None, :, None]
                                      * t[None, None, :] + phase), dim=1)
    mix = 0.3 + 0.7 * torch.rand((b, N_CH, 1), generator=gen, device=dev)
    noise = torch.randn((b, N_CH, T_PAD), generator=gen, device=dev)
    return mix * drive[:, None, :] + 0.7 * noise


def eeg_throughput(recordings: int = 64, windows: int = 40, repeats: int = 2,
                   seed: int = 42, device=None):
    """The EEG feature pass over recordings × 5 bands × windows windows, one
    warm pass then `repeats` timed ones, each on new EEG from one generator
    seeded by `seed`.  Returns (the JSON line as a dict, the last pass's
    eeg, ns, use_idx, use_mask, agg and ovf).  On the CPU the programs take
    the plain path: a test of the pass, not a device reading."""
    import numpy as np
    import torch

    from tda_eeg_audio_tpu_torch.config import DEFAULT_CONFIG as cfg
    from tda_eeg_audio_tpu_torch.models.programs import (eeg_distance_program,
                                                          eeg_feature_program)
    from tda_eeg_audio_tpu_torch.native.engine import rips_persistence_batch
    from tda_eeg_audio_tpu_torch.ops.homology_cuda import h1_diagrams_cuda
    from tda_eeg_audio_tpu_torch.ops.phase1_cuda import phase1_cuda
    from tda_eeg_audio_tpu_torch.runtime import resolve_device

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    B, K = recordings, windows
    ns = torch.full((B,), T_PAD - 100, dtype=torch.long, device=dev)
    n_win = (T_PAD - 100 - cfg.win_samples) // cfg.step_samples + 1
    rng = np.random.default_rng(0)
    use_idx = torch.as_tensor(np.stack([
        rng.choice(n_win, size=K, replace=False) for _ in range(B * 5)
    ]).reshape(B, 5, K), device=dev)
    use_mask = torch.ones((B, 5, K), dtype=torch.bool, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def device_pass():
        eeg = synth_eeg(B, gen, dev, cfg.fs_eeg)
        agg, ovf = eeg_feature_program(eeg, ns, use_idx, use_mask, cfg, K=K,
                                       device=dev)
        return dict(eeg=eeg, ns=ns, use_idx=use_idx, use_mask=use_mask,
                    agg=agg, ovf=ovf)

    t0 = _sync_time(dev)
    device_pass()
    warm = _sync_time(dev) - t0
    times, n_ovf, finite = [], 0, True
    red0, p10 = h1_diagrams_cuda.launches, phase1_cuda.launches
    for _ in range(max(repeats, 1)):
        t0 = _sync_time(dev)
        last = device_pass()
        times.append(_sync_time(dev) - t0)
        ovf = last["ovf"].cpu()
        n_ovf += int(ovf.sum())
        finite &= bool(torch.isfinite(last["agg"].cpu()[~ovf]).all())
    kernel_launches = h1_diagrams_cuda.launches - red0
    phase1_launches = phase1_cuda.launches - p10
    n_windows = B * 5 * K
    dev_wps = n_windows / min(times)

    # host baseline: the host engine on the first windows' distance matrices
    n_base = min(HOST_WINDOWS, n_windows)
    b_base = -(-n_base // (5 * K))
    dist, _, _ = eeg_distance_program(last["eeg"][:b_base], ns[:b_base], cfg,
                                      N_WIN, device=dev)
    sel = dist.gather(2, use_idx[:b_base, :, :, None, None].expand(
        -1, -1, -1, N_CH, N_CH))
    dms = sel.reshape(-1, N_CH, N_CH)[:n_base].cpu().numpy()
    rips_persistence_batch(dms[:64], cfg.max_edge_length)     # warm / build
    t0 = time.perf_counter()
    rips_persistence_batch(dms, cfg.max_edge_length)
    host_wps = n_base / (time.perf_counter() - t0)

    launches_ok = phase1_launches == kernel_launches and \
        (kernel_launches > 0) == on_card
    line = {
        "metric": "eeg_windows_per_sec_per_chip",
        "value": dev_wps,
        "unit": "windows/s (filter -> window -> corr -> exact Rips H0+H1 -> "
                "features)",
        "vs_baseline": dev_wps / host_wps,
        "detail": {"batch": B, "K": K, "warm_s": warm, "host_wps": host_wps,
                   "runs_s": times, "host_windows": n_base},
        "n_windows": n_windows,
        "phase1_launches": phase1_launches, "kernel_launches": kernel_launches,
        "overflow_recordings": n_ovf,
        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9
        if on_card else None,
        "device": str(dev), "card": card_line() if on_card else None,
        "torch": torch.__version__,
        "ok": bool(launches_ok and finite and np.isfinite(dev_wps)),
    }
    return line, last


def full_study(args) -> int:
    import torch

    from tda_eeg_audio_tpu_torch.config import DEFAULT_CONFIG
    from tda_eeg_audio_tpu_torch.io.device_store import build_synthetic_device
    from tda_eeg_audio_tpu_torch.models.homology_exec import run_tda
    from tda_eeg_audio_tpu_torch.models.study import StudyRunner
    from tda_eeg_audio_tpu_torch.ops import homology_cuda as HC
    from tda_eeg_audio_tpu_torch.ops import phase1_cuda as P1
    from tda_eeg_audio_tpu_torch.ops import sinkhorn_log_cuda as SL
    from tda_eeg_audio_tpu_torch.ops import wasserstein_cuda as WC
    from tda_eeg_audio_tpu_torch.ops import wasserstein_h0_cuda as WH
    from tda_eeg_audio_tpu_torch.runtime import timed_spans

    card = card_line()
    n_subj, per = (3, 2) if args.smoke else (45, 16)
    cfg = dataclasses.replace(DEFAULT_CONFIG, wasserstein_backend="sinkhorn")
    bank = tuning.EEG_BANK and not args.no_bank
    dev = torch.device("cuda")

    WC.build()                                  # nvcc, before any clock
    SL.build()
    WH.build()
    t0 = _sync_time(dev)
    ds = build_synthetic_device(n_subjects=n_subj, n_per_subject=per,
                                seed=args.seed)
    t_ingest = _sync_time(dev) - t0
    print(f"[bench] {len(ds)} recordings on {card}; ingest {t_ingest:.1f}s",
          file=sys.stderr, flush=True)

    def study(td):
        """One study by a fresh runner: stage seconds, launches, checks."""
        runner = StudyRunner(ds, cfg, eeg_batch=tuning.EEG_BATCH,
                             eeg_bank=bank,
                             feature_na_max=tuning.FEATURE_NA_MAX,
                             results_dir=td, verbose=False)
        launches0, redone0 = HC.h1_diagrams_cuda.launches, run_tda.redone
        sk0 = WC.sinkhorn_tiered_cuda.launches
        p10 = P1.phase1_cuda.launches
        sl0, h00 = SL.sinkhorn_log_cuda.launches, WH.wasserstein_h0_cuda.launches
        t0 = _sync_time(dev)
        X, y, subjects, filenames, meta = runner.compute_feature_dataset()
        t1 = _sync_time(dev)
        cmp_out = runner.run_comparison(n_permutations=1000)
        t2 = _sync_time(dev)
        runner.run_control()
        t3 = _sync_time(dev)
        run = dict(
            total=t3 - t0, features_s=t1 - t0, compare_s=t2 - t1,
            control_s=t3 - t2, bank_batches=runner._bank_served,
            bank_fallback=runner._bank_fallback,
            kernel_launches=HC.h1_diagrams_cuda.launches - launches0,
            phase1_launches=P1.phase1_cuda.launches - p10,
            # bucketing + one per width class: 5 a comparison batch
            sinkhorn_launches=WC.sinkhorn_tiered_cuda.launches - sk0,
            # the control's exact redo (un-tiered Sinkhorn) and one
            # exact H0 DP a comparison batch
            sinkhorn_log_launches=SL.sinkhorn_log_cuda.launches - sl0,
            h0_launches=WH.wasserstein_h0_cuda.launches - h00,
            redone=dict(runner.redo_counts,
                        windows=run_tda.redone - redone0))
        checks = {"n_features_220": X.shape[1] == 220,
                  "rows_complete":
                      len(cmp_out["detailed_rows"]) >= len(ds) * 4,
                  # every H1 chunk: one phase-1 launch, one reduction launch
                  "phase1_per_reduction":
                      run["phase1_launches"] == run["kernel_launches"],
                  "X_shape": list(X.shape)}
        return run, checks

    def line(runs, checks, pending, spanned=None):
        ok = bool(checks["n_features_220"] and checks["rows_complete"]
                  and checks["phase1_per_reduction"])
        out = {"metric": "full_study_seconds",
               "value": min(r["total"] for r in runs),
               "unit": "s (features + comparison + control, 5 bands, one card)",
               "ok": ok, "runs": runs, "checks": checks,
               "n_recordings": len(ds), "eeg_bank": bank,
               "eeg_batch": tuning.EEG_BATCH,
               "feature_na_max": tuning.FEATURE_NA_MAX,
               "knob_source": tuning.SOURCE, "ingest_s": t_ingest,
               "pending_repeats": pending,
               "card": card, "torch": torch.__version__,
               "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9}
        if spanned is not None:
            out["spanned"] = spanned
        print(json.dumps(out), flush=True)
        return ok

    runs = []
    repeats = max(args.repeats, 1)
    with tempfile.TemporaryDirectory() as td:
        for rep in range(repeats):
            run, checks = study(td)
            runs.append(run)
            print(f"[bench] rep {rep}: " + json.dumps(run), file=sys.stderr,
                  flush=True)
            ok = line(runs, checks, repeats - rep - 1 + bool(args.spans))
        if args.spans:
            # every span synchronises the card at both ends: this repeat's
            # stage seconds are not the benchmark's, its spans are the split
            with timed_spans() as parts:
                run, checks = study(td)
            ok = line(runs, checks, 0, dict(run, spans_ms=dict(parts)))
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true", help="3 subjects x 2 per condition")
    ap.add_argument("--eeg-throughput", action="store_true",
                    help="the EEG feature pass alone, in windows/s")
    ap.add_argument("--recordings", type=int, default=64,
                    help="--eeg-throughput: recordings a pass")
    ap.add_argument("--windows", type=int, default=40,
                    help="--eeg-throughput: windows per band per recording")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--no-bank", action="store_true",
                    help="comparison recomputes the EEG diagrams (eeg_bank=False)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--spans", action="store_true",
                    help="full study: one more repeat with every span timed")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2

    from tda_eeg_audio_tpu_torch.ops import homology_cuda as HC
    from tda_eeg_audio_tpu_torch.ops import phase1_cuda as P1

    HC.build()                                  # nvcc, before any clock
    P1.build()
    if not args.eeg_throughput:
        return full_study(args)
    line, _ = eeg_throughput(args.recordings, args.windows, args.repeats,
                             args.seed)
    print(json.dumps(line), flush=True)
    return 0 if line["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
