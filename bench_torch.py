#!/usr/bin/env python3
"""Full-study benchmark of the PyTorch/CUDA port (`tda_eeg_audio_tpu_torch`).

    python3 bench_torch.py [--smoke] [--repeats N] [--no-bank] [--seed S]

The study on one CUDA card: per-recording features (EEG Rips H0 + H1 in 5
bands), the EEG↔audio comparison and the matched/mismatched control (audio
Takens diagrams, window-paired Wasserstein, Wilcoxon / sign-flip / FDR), on
the synthetic dataset generated into device memory before the clock starts
(45 subjects × 32 recordings; `--smoke`: 3 × 4).  A fresh runner per repeat;
each stage is timed between two `torch.cuda.synchronize()` calls.  After
every completed repeat one JSON line is printed (the last line wins):
`metric: full_study_seconds`, `value` (best repeat), `runs`, `checks`, the
ingest seconds and the card's name and power limit.  The host Random-Forest
stage is not part of the study's clock.  Needs the card: exits non-zero
without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import tempfile
import time


EEG_BATCH = 16      # recordings per batch, the size the programs are checked at


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true", help="3 subjects x 2 per condition")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--no-bank", action="store_true",
                    help="comparison recomputes the EEG diagrams (eeg_bank=False)")
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2

    from tda_eeg_audio_tpu_torch.config import DEFAULT_CONFIG
    from tda_eeg_audio_tpu_torch.io.device_store import build_synthetic_device
    from tda_eeg_audio_tpu_torch.models.homology_exec import run_tda
    from tda_eeg_audio_tpu_torch.models.study import StudyRunner
    from tda_eeg_audio_tpu_torch.ops import homology_cuda as HC
    from tda_eeg_audio_tpu_torch.ops import phase1_cuda as P1
    from tda_eeg_audio_tpu_torch.ops import wasserstein_cuda as WC

    card = card_line()
    n_subj, per = (3, 2) if args.smoke else (45, 16)
    cfg = dataclasses.replace(DEFAULT_CONFIG, wasserstein_backend="sinkhorn")

    def sync_time():
        torch.cuda.synchronize()
        return time.perf_counter()

    HC.build()                                  # nvcc, before any clock
    P1.build()
    WC.build()
    t0 = sync_time()
    ds = build_synthetic_device(n_subjects=n_subj, n_per_subject=per,
                                seed=args.seed)
    t_ingest = sync_time() - t0
    print(f"[bench] {len(ds)} recordings on {card}; ingest {t_ingest:.1f}s",
          file=sys.stderr, flush=True)

    runs = []
    with tempfile.TemporaryDirectory() as td:
        for rep in range(max(args.repeats, 1)):
            runner = StudyRunner(ds, cfg, eeg_batch=EEG_BATCH,
                                 eeg_bank=not args.no_bank, results_dir=td,
                                 verbose=False)
            launches0, redone0 = HC.h1_diagrams_cuda.launches, run_tda.redone
            sk0 = WC.sinkhorn_tiered_cuda.launches
            p10 = P1.phase1_cuda.launches
            t0 = sync_time()
            X, y, subjects, filenames, meta = runner.compute_feature_dataset()
            t1 = sync_time()
            cmp_out = runner.run_comparison(n_permutations=1000)
            t2 = sync_time()
            runner.run_control()
            t3 = sync_time()
            runs.append(dict(
                total=t3 - t0, features_s=t1 - t0, compare_s=t2 - t1,
                control_s=t3 - t2, bank_batches=runner._bank_served,
                bank_fallback=runner._bank_fallback,
                kernel_launches=HC.h1_diagrams_cuda.launches - launches0,
                phase1_launches=P1.phase1_cuda.launches - p10,
                # bucketing + one per width class: 5 a comparison batch
                sinkhorn_launches=WC.sinkhorn_tiered_cuda.launches - sk0,
                redone=dict(runner.redo_counts,
                            windows=run_tda.redone - redone0)))
            print(f"[bench] rep {rep}: " + json.dumps(runs[-1]), file=sys.stderr,
                  flush=True)
            checks = {"n_features_220": X.shape[1] == 220,
                      "rows_complete":
                          len(cmp_out["detailed_rows"]) >= len(ds) * 4,
                      # every H1 chunk: one phase-1 launch, one reduction launch
                      "phase1_per_reduction":
                          runs[-1]["phase1_launches"] == runs[-1]["kernel_launches"],
                      "X_shape": list(X.shape)}
            ok = bool(checks["n_features_220"] and checks["rows_complete"]
                      and checks["phase1_per_reduction"])
            print(json.dumps({
                "metric": "full_study_seconds",
                "value": min(r["total"] for r in runs),
                "unit": "s (features + comparison + control, 5 bands, one card)",
                "ok": ok, "runs": runs, "checks": checks,
                "n_recordings": len(ds), "eeg_bank": not args.no_bank,
                "eeg_batch": EEG_BATCH, "ingest_s": t_ingest,
                "pending_repeats": max(args.repeats, 1) - rep - 1,
                "card": card, "torch": torch.__version__,
                "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9}),
                flush=True)
    return 0 if runs and ok else 1


if __name__ == "__main__":
    sys.exit(main())
