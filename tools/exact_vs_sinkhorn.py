#!/usr/bin/env python3
"""How far the fused comparison's tiered Sinkhorn is from persim's exact
matching over the whole synthetic study, and what the exact parity path
costs (needs one CUDA card).

    python3 tools/exact_vs_sinkhorn.py [--subjects 45] [--per-subject 16]

Builds the synthetic store on the card (subjects × {slow, fast} ×
per-subject recordings), then computes the comparison's detailed rows twice
on the same recordings, each between two device synchronisations: the fused
pass (`wasserstein_backend="sinkhorn"`: exact H0 DP and tiered Sinkhorn on
the card) and the staged parity path (`"host_exact"`: the same kernel's
diagrams, every pair matched exactly on the host).  Prints, per band, the
relative difference of `wasserstein_h1` (and `wasserstein_h0`) per
recording, (Sinkhorn − exact) / exact: largest absolute, mean absolute and
mean signed; whether the integer fields agree; and the band statistics of
both row sets (Wilcoxon p of W_H1, its FDR decision), so a reader sees
whether the approximation moves a conclusion.  One JSON line."""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--subjects", type=int, default=45)
    ap.add_argument("--per-subject", type=int, default=16)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("exact_vs_sinkhorn: no CUDA device", file=sys.stderr)
        return 2
    from tda_eeg_audio_tpu_torch.config import DEFAULT_CONFIG
    from tda_eeg_audio_tpu_torch.io.device_store import build_synthetic_device
    from tda_eeg_audio_tpu_torch.models.study import BAND_NAMES, StudyRunner

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    store = build_synthetic_device(args.subjects, args.per_subject, device="cuda")
    exact_cfg = dataclasses.replace(DEFAULT_CONFIG, wasserstein_backend="host_exact")
    fused = StudyRunner(store, DEFAULT_CONFIG, eeg_bank=False, verbose=False)
    exact = StudyRunner(store, exact_cfg, eeg_bank=False, verbose=False)
    fused._fused_rows()                  # first use of every shape, untimed
    fused._fused_cache = None
    rows_s, sec_s = timed(lambda: [r for r in fused._fused_rows()
                                   if r["n_windows"] > 0])
    rows_e, sec_e = timed(lambda: exact._staged_comparison_rows(
        list(range(len(store)))))
    by_key = {(r["filename"], r["condition"], r["band"]): r for r in rows_s}
    keys = [(r["filename"], r["condition"], r["band"]) for r in rows_e]
    if sorted(keys) != sorted(by_key):
        print("FAIL: the two paths emit different rows", file=sys.stderr)
        return 1
    int_equal = all(by_key[k][f] == r[f] for k, r in zip(keys, rows_e)
                    for f in ("n_windows", "tau"))
    diff = {}
    for band in BAND_NAMES:
        d = {}
        for f in ("wasserstein_h1", "wasserstein_h0"):
            rel = np.array([(by_key[k][f] - r[f]) / r[f]
                            for k, r in zip(keys, rows_e) if k[2] == band])
            d[f] = dict(max_abs_rel=float(np.abs(rel).max()),
                        mean_abs_rel=float(np.abs(rel).mean()),
                        mean_rel=float(rel.mean()), rows=int(rel.size))
        diff[band] = d
    stats_s = fused._comparison_stats(rows_s, 1000)["band_results"]
    stats_e = exact._comparison_stats(rows_e, 1000)["band_results"]
    stats = {b: {k: [stats_s[b].get(k), stats_e[b].get(k)]
                 for k in ("wass_h1_p", "wass_h1_p_fdr", "wass_h1_sig_fdr",
                           "wass_h1_cohens_d")} for b in BAND_NAMES}
    print(json.dumps(dict(
        card=card, torch=torch.__version__, recordings=len(store),
        rows=len(rows_e), sinkhorn_fused_s=sec_s, exact_staged_s=sec_e,
        integers_equal=int_equal, relative_difference=diff,
        band_stats_sinkhorn_vs_exact=stats)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
