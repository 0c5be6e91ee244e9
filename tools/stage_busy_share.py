#!/usr/bin/env python3
"""How busy the card is during the runner's stages (needs one CUDA card).

    python3 tools/stage_busy_share.py [--subjects 2] [--out trace.json]

Builds a synthetic store on the card (subjects × 16 recordings), warms the
pipeline with one untraced study, then runs a fresh runner's features stage
and fused comparison pass under `torch.profiler` (CPU + CUDA activities).
Per stage it prints the wall seconds (between two synchronisations), the
summed device time of all kernels and copies, their ratio (the device's
busy share; its idle share is the rest) and the ten kernels with the most
device time.  Tracing slows the host side, so the wall seconds here are not
the benchmark's."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def traced(name, fn, out_dir):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies, memsets): the host-side ops
    # and the named spans carry their kernels' time a second time
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    device_s = sum(r[0] for r in rows) / 1e6
    if out_dir:
        prof.export_chrome_trace(str(Path(out_dir) / f"{name}.trace.json"))
    return dict(stage=name, wall_s=wall, device_s=device_s,
                busy_share=device_s / wall, device_events=sum(r[1] for r in rows),
                top=[dict(kernel=k[:80], device_ms=us / 1e3, calls=c)
                     for us, c, k in rows[:10]])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--subjects", type=int, default=2)
    ap.add_argument("--out", default=None, help="directory for chrome traces")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("stage_busy_share: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import card_line
    from tda_eeg_audio_tpu_torch.io.device_store import build_synthetic_device
    from tda_eeg_audio_tpu_torch.models.study import StudyRunner

    card = card_line()
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
    store = build_synthetic_device(n_subjects=args.subjects, n_per_subject=8)
    warm = StudyRunner(store, verbose=False)
    warm.compute_feature_dataset()
    warm._fused_rows()
    runner = StudyRunner(store, verbose=False)
    report = [traced("features", runner.compute_feature_dataset, args.out),
              traced("comparison", runner._fused_rows, args.out)]
    print(json.dumps(dict(card=card, recordings=len(store), stages=report)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
