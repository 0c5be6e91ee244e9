#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`tda_eeg_audio_tpu_torch`).

    python3 chip_smoke.py            # needs one CUDA card, nvcc, the checkout

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels — the H1 reduction, H1 phase 1 and the tiered
     Sinkhorn, each with its instrumented twin, the sosfiltfilt chunked
     scan, the un-tiered log-domain Sinkhorn and the exact H0 DP (nine nvcc
     side by side, sm_90a) — from the sources in the checkout;
  3. hold the reduction kernel against its plain PyTorch version on the
     card, at the shapes of the main path: the features stage's n = 47 EEG
     windows and the comparison's n = 124 Takens clouds of one 16-recording
     batch — `h1_diagrams_cuda` (the phase-1 kernel, then the reduction
     kernel) against the plain phase 1 and reduction: pair keys, bars, step
     counts and overflow flags must be identical —
     and on a ragged case the main path does not reach (more windows than
     resident blocks, windows without creators, padded clouds, a step
     budget that some windows exceed); read the instrumented build's
     shares of the step at both shapes (the `kernel phases` line);
 3b. the phase-1 kernel (`phase1_cuda`, one launch: the edge sort is inside
     it) against the plain `_phase1` on the card, bit for bit on every key
     of its dict, at n = 47 (the features batch), n = 124 (the 1,200 clouds
     with their point counts), the ragged n = 24 clouds, tied grid clouds,
     n = 47 windows with NaN (windows past a recording's end), and n = 47
     windows with tied -0.0 / +0.0 weights and ±NaN channels held against
     `_phase1` on a CPU copy (the CPU's and JAX's edge order) and the card's
     plain `_phase1` held to the CPU's too; whether the plain route and the
     card's own torch.sort(stable=True) give that order (readings); timed
     (CUDA events: the launcher, the plain version), peak memory of both,
     the bound (the sieve's compares, counted from the plain vstar); the
     instrumented build's shares per part and the SMs' busy share at both
     main-path shapes (the `h1_phase1 phases` line);
  4. drive one full-width study batch (16 synthetic recordings, 47 channels,
     5 bands, 1537 taps, T_pad 5800, K 39 / 15) through
     eeg_feature_program → audio_h1_program (mismatch audio) →
     comparison_program, with the launch count zeroed just before and read
     just after, the comparison stage's parts timed by its own spans, and
     check shapes, finiteness and launches (the H1 kernels' by stage — one
     phase-1 launch for every reduction launch — the tiered Sinkhorn's and
     the exact H0 DP's per batch); the warm-up run keeps the pairs the
     comparison hands the tiered Sinkhorn (phase 4b) and the H0 DP (13);
 4b. the tiered Sinkhorn kernel against its plain version on the card, on
     the 2,400 pairs phase 4's comparison hands it (kept in the warm-up run)
     and on synthetic pairs of every width class (empty sides, 16 | 17 ...
     96 bars), within rtol 1e-6 of a float64 run of the ladder on every
     pair, and within rtol 2e-4 of each plain value on the pairs (at least
     half) where the plain version lies within 1e-4 of the float64 run;
     the kernel path once under
     `torch.cuda.set_sync_debug_mode("error")`; timed (CUDA events), the
     plain version timed, pairs per width class and the bound (at each
     pair's own width) printed, and a rounding line per set (the kernel and
     the plain version against the float64 run, the plain version against
     itself on its pairs reversed); each width class's layout as the library
     reports it, and the instrumented build's shares per part and SMs' busy
     share per class (the `sinkhorn phases` line);
  5. hold the CUDA run of a small batch against the CPU run (plain path);
  6. the study runner at full width: 96 synthetic recordings (6 subjects ×
     {slow, fast} × 8) generated into a device-resident store, then
     `StudyRunner.compute_feature_dataset → run_comparison → run_control`
     with the union bank on, per-stage seconds and kernel launches, the
     counts of what the exact redo did, and checks of shapes, finiteness,
     bank service and statistics; the control stage's parts timed by its
     spans, and the pairs its exact redo hands the un-tiered Sinkhorn and
     the exact-H0 pairs of its first four comparison batches kept for
     phase 13;
  7. one batch through `comparison_from_bank` and through
     `comparison_program` on the card (integers and flags equal, floats
     within phase 5's tolerances);
  8. the exact redo on the card: one n = 47 batch through `run_tda` with an
     arena so small that windows overflow, against the wide-arena run;
  9. the command line on the card: 8 full-length synthetic recordings (4
     subjects × {slow, fast}) written as .mat files in the reference's
     layout, then `cli.main` in this process for preprocess, graphs,
     features, features as two partials + --merge-partials (X equal bit for
     bit), features --backend host (X against the kernel's within phase 5's
     tolerances), compare, compare --wasserstein exact, control, control
     --wasserstein exact and eda, each command's kernel launches counted from
     0 (the exact H0 DP's in compare and control only), its
     artifacts checked for the reference's keys and columns; prints the
     exact-vs-Sinkhorn difference of wasserstein_h1 per band (a reading, not
     a gate) and the `cli` line.  classify, ablate and study are not run:
     the card's machine has neither scikit-learn nor matplotlib;
 10. the exact IIR bank (`filter_impl="iir_scan"`): the sosfiltfilt kernel
     against its plain recurrence on the card (2 recordings × 47 channels
     × 5 bands, T_pad 5800, lengths 5800 / 4,100 / one n ≤ edge; within
     1e-6 × the band's max|ref|) and against scipy's float64 sosfiltfilt on
     a few series (1e-5), then at the main path's 16-recording shape, at
     the runner's tuned batch of 64 recordings and on one series of
     T = 40,000 whose extension is staged through device memory (each
     timed, held to plain too, one launch a call, its launch plan and the
     library's occupancy and registers printed); then the runner over phase
     6's 96 recordings with `filter_impl="iir_scan"`, both kernels' launches
     counted from 0, and its X held to phase 6's FIR X under
     tests/test_fir_parity.py's gates;
 11. two processes on the card: `cli.main(["features", ...,
     "--coordinator", ..., "--num-processes", "2", "--process-id", i])`
     (what `python -m tda_eeg_audio_tpu_torch.cli` runs) as two
     subprocesses over gloo on cuda:0 (pinned to the loopback interface,
     where they meet) on phase 9's kind of .mat files, then
     `--merge-partials` and one single-process run in this process: X, y
     and subjects equal bit for bit; in the same two ranks
     `parallel.sharding.sharded_stats_step` equal to this process's
     Wilcoxon + BH-FDR on the whole array;
 12. the knobs of `tuning.py` in force and the source of each; then
     `bench_torch.eeg_throughput` at the bench's shape (64 recordings × 5
     bands × 40 windows, T_pad 5800; one warm pass, one timed pass) with its
     JSON line, failing unless phase-1 launches equal reduction launches
     and every recording that did not overflow has finite aggregates, and
     the timed pass's first 2 recordings held against `eeg_feature_program`
     on the CPU (phase 5's tolerances, overflow flags equal); then, only if
     tuning.json departs from the defaults, the runner over phase 6's 96
     recordings at the defaults and at the tuned knobs, the comparison's
     parts timed by its spans (per batch): X and the detailed rows (bit for
     bit expected; else within phase 5's tolerances, the largest difference
     printed) and equal overflow windows and deviants redone.
     Phases 6, 7, 8 and 10 run at the defaults (batch 16, the bank on,
     arena 128) whatever tuning.json holds;
 13. the un-tiered log-domain Sinkhorn kernel through its router
     (`sinkhorn_cost_pairs`) against the plain version on the card, on the
     pairs phase 6's control redo handed it, on 112 pairs made from a seed
     (0–128 bars a side, empty sides) and on those pairs with a NaN birth
     in every masked slot (what an all-NaN window leaves there; the
     results bit for bit the seeded set's): within rtol 2e-4 of the plain
     float32 version and 1e-4 of its float64 run, the same NaN / inf, one
     launch a call, no host synchronisation (set_sync_debug_mode("error")),
     timed beside the plain version, peak memory a call, the bound at each
     pair's own width and at the pad width, the pairs by the lanes a line
     takes and by cost route (table or bars); the exact H0 DP kernel
     through `wasserstein_h0_exact` against the plain loop on the card on
     phase 4's 1,200 pairs (46 / 123), on staged pads (64 / 128) with
     all-pad and single-bar rows and on phase 6's 4,800 (a batch of 64
     recordings' worth): within rtol 1e-6, one launch a call, bit for bit
     against the CPU's plain loop (a reading), timed, its bound;
 14. the runner's data-parallel mesh: `StudyRunner(mesh=[cuda:i, cuda:i])`,
     two shards on this card, over phase 6's store with the bank on: at
     eeg_batch 32 each shard runs one of phase 6's batches of 16, and X and
     the detailed rows must equal phase 6's bit for bit; at eeg_batch 16
     (shards of 8) they are held to phase 6's under phase 12's gates; in
     both runs every shard must launch the H1 reduction, H1 phase 1, the
     tiered Sinkhorn and the exact H0 DP (counted per shard, printed);
 15. the md5 window sample kernel on the full study's 7,200 lanes (1,440
     recordings, K = 39 and the bank's 15 paired columns) in one launch and
     in launches of 64 recordings, bit for bit against NumPy's draw; its
     device ms, a launch's host us and NumPy's host ms (every runner phase
     above also counts its launches: one a features batch);
 16. the window -> correlation-distance kernel at a features batch (64
     recordings x 5 bands x 54 windows read in place from the FIR bank's
     strided output, and window 0 as a 55th column) and a comparison batch
     (15 windows, one set for every band) against the plain chain on the
     card: NaN and zero patterns identical, correlations within 1e-6 of the
     plain chain run in float64 and no farther from it than the float32
     plain chain; its device ms, the plain chain's, a launch's host us and
     its bound (every runner phase also counts its launches: one a features
     batch);
then print the `kernels` JSON line, the card line, and the result line.
Imports nothing of JAX or of the reference package, nor scikit-learn or
matplotlib.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

B_REC = 16          # recordings per batch
# the features stage's H1 arena width: the runner phases run at the knobs'
# defaults (B_REC, the bank on, NA_FEAT), whatever tuning.json holds, so
# that their launch counts stay those of the default configuration
NA_FEAT = 128
K_FEAT = 39         # features-stage windows per band
K_CMP = 15          # comparison windows per band
N_WIN_MAX = 90
N_RS_MAX = 5900
HBM_BYTES_PER_S = 3.35e12
# FP64 rate of an H100 SXM outside the tensor cores (NVIDIA's data sheet)
FP64_FLOPS_PER_S = 34e12
# FP64 operations per section and sample of the biquad (3 FMA + 2 MUL + 1 ADD)
IIR_FLOPS = 9
# assumed latency of a dependent FP64 FMA (not measured): the chain-floor
# estimate is 2 such latencies per sample and pass (y → z1 → y) at the card's
# max SM clock; it is printed on phase 10's line only, never in the `kernels`
# line, where the lone series' measured time stands for the latency floor
FP64_FMA_CYCLES = 8
# int32 ALU peak of an H100 SXM, from its published 67 TFLOP/s float32 rate
# outside the tensor cores: an FMA counts 2 FLOPs, and an SM has half as
# many INT32 lanes as FP32 lanes, so 67e12 / 4 one-op-per-clock int32 ops/s
INT32_OPS_PER_S = 67e12 / 4
PLAIN_STORED_BYTES = 1 << 34    # the plain reduction's dense bool columns per call
# FP32 rate of an H100 SXM outside the tensor cores, and its special-function
# units' rate for expf: 16 results per SM and clock on 132 SMs (NVIDIA's data
# sheet and Hopper white paper)
FP32_FLOPS_PER_S = 67e12
SFU_PER_SM_CLOCK = 16
N_SMS = 132
SINKHORN_RTOL = 2e-4    # the tiered Sinkhorn's parity tolerance (tests/test_torch_ops.py)
# the tiered Sinkhorn kernel against a float64 run of the same ladder: its
# duals are float64, so only its float32 kernel matrix, matvecs and
# reciprocals round, a few float32 ULPs of <P, D>; the float32 plain
# version, whose duals round too, sits up to ~2e-4 away (phase 4b prints both)
SINKHORN_F64_RTOL = 1e-6
# the pairs on which phase 4b also holds the kernel to the float32 plain
# version (SINKHORN_RTOL): those where that version lies within this of the
# float64 ladder.  One float32 ULP of a dual at the ladder's last epsilon
# moves <P, D> by up to ~1e-4 relative (tests/test_torch_wasserstein_cuda.py),
# so past it the plain value's own rounding is what a 2e-4 gate would read;
# there the kernel is held by the float64 gate alone, 200 times tighter.
SINKHORN_PLAIN_NEAR_F64 = 1e-4
# phase 13: the un-tiered Sinkhorn kernel against its plain float32 version
# and against a float64 run of it (float64 duals: the kernel sits near the
# float64 run, so the float64 gate is the one that tells a wrong kernel; the
# distance from the float32 version is mostly that version's own rounding,
# printed beside it); the exact H0 kernel against its plain loop on the card (whose
# torch.cumsum sums in another order than the kernel's and the CPU's)
SINKHORN_LOG_RTOL = 2e-4
SINKHORN_LOG_F64_RTOL = 1e-4
H0_RTOL = 1e-6
# phase 13's sets for the exact H0 kernel: phase 4's batch of 16 recordings,
# staged pads, and four of phase 6's batches (the 4,800 pairs of a batch of 64)
H0_SETS = ("main", "staged", "batch64")
# phase 13's sets for kernel A: phase 6's control pairs, seeded pairs, and
# the seeded pairs with a NaN birth in every masked slot
SINKHORN_LOG_SETS = ("control", "seeded", "masked_nan")
# phase 14: the kernels that every shard of the runner's mesh launches (the
# wrappers' names in runner_phase)
SHARD_KERNELS = ("launches", "phase1_launches", "sinkhorn_launches", "h0_launches")
# the stage of the main path that runs the kernel at one shape only
STAGE_OF_N = {47: "features", 124: "mismatch_audio"}
# phase 10's sosfiltfilt cases: 2 ragged recordings, the main path's batch of
# 16, the runner's tuned batch of 64, one series of T = 40,000 (staged)
IIR_SHAPES = ("ragged", "main", "main64", "long")
BANDS = ("delta", "theta", "alpha", "beta", "gamma")
# the reference's artifact schemas (JSON keys, CSV columns) that phase 9 holds
# the command line's artifacts to
CMP_KEYS = ["analysis", "method", "audio_construction", "eeg_construction",
            "n_recordings", "n_subjects", "n_slow", "n_fast",
            "max_windows_per_recording", "statistical_test",
            "multiple_comparison", "band_results"]
DETAILED_COLS = ["filename", "condition", "subject", "band", "wasserstein_h0",
                 "wasserstein_h1", "n_windows", "tau"] + [
    f"corr_{f}_{s}" for f in ("mean_persistence", "total_persistence",
                              "persistence_entropy", "max_persistence",
                              "n_features") for s in ("r", "p")]
PRE_COLS = ["filename", "n_electrodes", "n_samples", "duration_sec", "fs_eeg",
            "bands", "n_windows", "condition"]
META_COLS = ["filename", "n_windows", "n_windows_used", "validation_issues",
             "window_sampling", "max_windows_per_band", "n_windows_total",
             "n_windows_used_total"]
EDA_KEYS = ["n_recordings", "n_subjects", "n_slow", "n_fast", "duration_stats",
            "coverage", "band_power", "subject_cluster_order"]
INV_COLS = ["filename", "subject", "condition", "n_samples", "duration_sec"]


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 1) -> float:
    """Mean device milliseconds of fn() over reps, by CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def feature_distances(eeg, n_e, use_idx, cfg):
    """The features stage's EEG correlation-distance windows (B·5·K, 47, 47)
    on eeg's device."""
    import torch

    from tda_eeg_audio_tpu_torch.models import programs as P

    use_idx = torch.as_tensor(use_idx, device=eeg.device).long()
    d = P.eeg_window_distances(eeg, n_e, use_idx, cfg)
    return d.reshape(-1, *d.shape[-2:]).contiguous()


def stage_inputs(batch, cfg, dev):
    """The H1 inputs of the main path: the features stage's EEG distance
    windows (B·5·K_FEAT, 47, 47) and the comparison's own-audio Takens
    distance matrices (B·5·K_CMP, 124, 124) with their valid-point counts."""
    import torch

    from tda_eeg_audio_tpu_torch.models import programs as P

    eeg = torch.as_tensor(batch["eeg"], device=dev)
    n_e = torch.as_tensor(batch["n_e"], device=dev).long()
    d47 = feature_distances(eeg, n_e, batch["use_idx"], cfg)
    n_win_e = P.window_count_program(n_e, cfg.win_samples, cfg.step_samples,
                                     eeg.shape[-1])
    aud = P.audio_takens_program(batch["audio"], batch["n_a"], cfg, N_RS_MAX,
                                 N_WIN_MAX, K_CMP, n_win_cap=n_win_e, device=dev)
    Pn = cfg.max_takens_points
    d124 = aud["dm"].reshape(-1, Pn, Pn).contiguous()
    npts = aud["n_pts"].reshape(-1)
    return d47, d124, npts


def profile_reading(prof, stamps, steps, launches, n_sms, slots, tick_slots):
    """One instrumented run read: the share of thread 0's clock ticks per
    part of the step, the counters, the busy blocks per launch (from each
    window's start/end stamps) and the time per step."""
    p = prof.double().sum(0).cpu()
    ticks = {k: float(p[i]) for i, k in enumerate(slots[:len(p)])
             if k in tick_slots}
    total = float(p[slots.index("total")])
    counts = {k: float(p[i]) for i, k in enumerate(slots[:len(p)])
              if k not in tick_slots and k != "total"}
    dur = (stamps[:, 1] - stamps[:, 0]).double()
    busy = []
    for lo, hi in launches:
        span = float(stamps[lo:hi, 1].max() - stamps[lo:hi, 0].min())
        busy.append(dict(windows=hi - lo, span_ms=span / 1e6,
                         busy_blocks=float(dur[lo:hi].sum()) / span,
                         busy_share_of_sms=float(dur[lo:hi].sum()) / span / n_sms))
    n_steps = max(float(steps.double().sum()), 1.0)
    n_fin = max(counts["steps_finish"], 1.0)
    step_us = float(dur.sum()) / 1e3 / n_steps * (1.0 - ticks["setup"] / total)
    return dict(
        share={k: v / total for k, v in ticks.items()},
        ticks_per_ns=total / float(dur.sum()),
        window_us_mean=float(dur.mean()) / 1e3,
        step_us_with_setup=float(dur.sum()) / 1e3 / n_steps, step_us=step_us,
        longest_chain_floor_ms=int(steps.max()) * step_us / 1e3,
        steps=dict(apparent=counts["steps_app"], stored=counts["steps_stored"],
                   finish=counts["steps_finish"]),
        words=dict(xor=counts["xor_words"], store=counts["store_words"],
                   extent_per_stored_column=counts["extent_words"] / n_fin,
                   nnz_per_stored_column=counts["nnz_words"] / n_fin),
        launches=busy,
        busy_share_of_sms=float(dur.sum()) / sum(b["span_ms"] for b in busy)
        / 1e6 / n_sms)


def phase1_profile_reading(prof, stamps, n_sms: int, blocks_per_sm: int):
    """The phase-1 kernel's instrumented run read: the share of thread 0's
    clock ticks per part (`phase1_cuda.PROFILE_TICKS`), Borůvka rounds per
    window, and from each window's start/end stamps the share of the
    launch's span in which each SM held at least one window (`sm_busy`)
    and the share of its resident-block slots held (`slot_busy`)."""
    from tda_eeg_audio_tpu_torch.ops import phase1_cuda as P1

    p = prof.double().sum(0).cpu()
    total = float(p[P1.PROFILE_SLOTS.index("total")])
    st = stamps.cpu().numpy()
    span, busy = sm_busy_ns(st)
    dur = float((st[:, 1] - st[:, 0]).sum())
    return dict(
        share={k: float(p[i]) / total for i, k in enumerate(P1.PROFILE_TICKS)},
        window_us_mean=dur / len(st) / 1e3,
        forest_rounds_mean=float(p[P1.PROFILE_SLOTS.index("forest_rounds")]) / len(st),
        span_ms=span / 1e6, sm_busy=busy / span / n_sms,
        slot_busy=dur / span / (n_sms * blocks_per_sm))


def sm_busy_ns(st):
    """From (start, end, SM) stamps (ns) of the work items of one launch:
    the launch's span and the summed time in which each SM held at least one
    item (the union of each SM's intervals)."""
    import numpy as np

    span = float(st[:, 1].max() - st[:, 0].min())
    busy = 0.0
    for sm in np.unique(st[:, 2]):
        iv = st[st[:, 2] == sm][:, :2]
        iv = iv[np.argsort(iv[:, 0])]
        end = iv[0, 0]
        for a, b in iv:
            busy += max(0, b - max(a, end))
            end = max(end, b)
    return span, busy


def sinkhorn_profile_reading(prof, stamps, widths, n_sms: int):
    """The Sinkhorn kernel's instrumented run read per width class: the
    share of the pair group's thread 0 clock ticks per part
    (`wasserstein_cuda.PROFILE_TICKS`), µs a pair, and from each pair's
    start/end stamps the share of the class launch's span in which each SM
    held at least one pair (`sm_busy`).  widths: (N,) class width of each
    pair."""
    import numpy as np

    from tda_eeg_audio_tpu_torch.ops import wasserstein_cuda as WC

    p = prof.double().cpu().numpy()
    st = stamps.cpu().numpy()
    widths = np.asarray(widths)
    res = {}
    for w in WC.WIDTHS:
        sel = widths == w
        if not sel.any():
            continue
        pw = p[sel].sum(0)
        total = float(pw[WC.PROFILE_SLOTS.index("total")])
        span, busy = sm_busy_ns(st[sel])
        res[w] = dict(pairs=int(sel.sum()),
                      share={k: float(pw[i]) / total for i, k in enumerate(WC.PROFILE_TICKS)},
                      pair_us_mean=float((st[sel, 1] - st[sel, 0]).mean()) / 1e3,
                      span_ms=span / 1e6, sm_busy=busy / span / n_sms)
    return res


def check_kernel(dm, n_pts, n, na_max, step_budget):
    """Kernel vs plain reduction on the same phase-1 operands, phase 1 in
    the main path's window chunks and the kernel once per chunk, as
    `h1_diagrams_cuda` runs them.  Returns a dict of the comparison, the
    timings, the two terms of the bound and the instrumented build's
    reading."""
    import torch

    from tda_eeg_audio_tpu_torch.ops import homology_cuda as HC
    from tda_eeg_audio_tpu_torch.ops import homology_h1 as H

    m = n * (n - 1) // 2
    na_eff = min(na_max, m)
    chunk = HC.phase1_chunk(n)
    chunks = []
    for c in range(0, dm.shape[0], chunk):
        npc = None if n_pts is None else n_pts[c:c + chunk]
        ph = H._phase1(dm[c:c + chunk], n, 2.0, na_max, npc)
        chunks.append((ph, H.reduction_inputs(ph)))
    torch.cuda.synchronize()

    # the whole wrapper on the kernel, against the plain reduction (timed,
    # counting the words of work each window needs; its dense bool columns
    # bound its own chunks) and the same bar extraction
    launches0 = HC.h1_diagrams_cuda.launches
    out_k = HC.h1_diagrams_cuda(dm, n_pts, n=n, thresh=2.0, na_max=na_max,
                                h1_max=na_max, step_budget=step_budget)
    launches = HC.h1_diagrams_cuda.launches - launches0
    word_ops = [torch.zeros(ph["m_cx"].shape[0], dtype=torch.int64,
                            device=dm.device) for ph, _ in chunks]
    sub = max(1, PLAIN_STORED_BYTES // (na_eff * (m * n + 1)))

    def run_plain():
        outs = []
        for (_, ins), w in zip(chunks, word_ops):
            parts = [H.reduce_plain(*(t[c:c + sub] for t in ins), n=n,
                                    step_budget=step_budget, word_ops=w[c:c + sub])
                     for c in range(0, w.shape[0], sub)]
            outs.append([torch.cat(x) for x in zip(*parts)])
        return outs

    red, plain_ms = wall_ms(run_plain)
    outs = [H._extract_bars(*r, ph, n, na_max) for r, (ph, _) in zip(red, chunks)]
    out_p = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
    mismatched = [k for k in out_k if not torch.equal(out_k[k], out_p[k])]
    # over the visible bars; equal values (an essential class's +inf death
    # included) count as 0
    vis = out_k["mask"] & out_p["mask"]
    err = 0.0
    if bool(vis.any()):
        for key in ("births", "deaths"):
            a, b = out_k[key][vis], out_p[key][vis]
            err = max(err, float(torch.where(a == b, 0.0, (a - b).abs()).max()))

    def run_kernel():
        for _, ins in chunks:
            HC.reduce_cuda(*ins, n=n, step_budget=step_budget)

    run_kernel()                                    # warm
    ms = cuda_ms(run_kernel, reps=3)

    # the instrumented build on the same operands: same outputs, and where
    # the step's time goes
    prof, stamps, bounds, lo = [], [], [], 0
    for (_, ins), r in zip(chunks, red):
        got = HC.reduce_cuda_profiled(*ins, n=n, step_budget=step_budget)
        if not all(torch.equal(a, b) for a, b in zip(got[:3], r)):
            mismatched.append("instrumented build")
        prof.append(got[3])
        stamps.append(got[4])
        bounds.append((lo, lo + got[3].shape[0]))
        lo = bounds[-1][1]
    n_sms = torch.cuda.get_device_properties(dm.device).multi_processor_count
    phases = profile_reading(torch.cat(prof), torch.cat(stamps), out_k["steps"],
                             bounds, n_sms, HC.PROFILE_SLOTS, HC.PROFILE_TICKS)

    # bound: operands read once + outputs written once over HBM, against
    # one int32 operation per column word the data needs (word_ops)
    steps = out_k["steps"].to(torch.float64)
    in_bytes = sum(t.numel() * t.element_size() for _, ins in chunks for t in ins)
    out_bytes = dm.shape[0] * (na_eff + 2) * 4
    ops = float(sum(int(w.sum()) for w in word_ops))
    plan = HC.kernel_plan(n, na_eff, min(chunk, dm.shape[0]),
                          HC.blocks_per_sm(n), n_sms)
    return dict(n=n, windows=int(dm.shape[0]), launches=launches, plan=plan,
                mismatched=mismatched, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, word_ops=ops, phases=phases,
                t_bytes=(in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3,
                t_ops=ops / INT32_OPS_PER_S * 1e3,
                steps_mean=float(steps.mean()), steps_max=int(steps.max()),
                overflow=int(out_k["overflow"].sum()),
                no_creator=int((out_k["n_na"] == 0).sum()))


def ragged_clouds(dev, n_windows: int = 6000, n: int = 24, seed: int = 0):
    """Correlation-distance clouds of 1 to n smoothed random channels
    (padding points at distance 9, beyond the threshold), made on `dev` from
    a seed: the windows a main-path batch does not have (none to a few
    creators, far more windows than blocks that can be resident)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n_windows, n, 131), generator=gen, device=dev)
    x = torch.nn.functional.avg_pool1d(x, 12, stride=1)
    x = x - x.mean(-1, keepdim=True)
    x = x / x.norm(dim=-1, keepdim=True)
    dm = torch.sqrt((2 * (1 - (x @ x.transpose(1, 2)).clamp(-1, 1))).clamp(min=0))
    dm = torch.maximum(dm, dm.transpose(1, 2))
    sizes = torch.tensor([1, 2, 3, n // 2, n - 4, n], device=dev)
    n_pts = sizes[torch.randint(len(sizes), (n_windows,), generator=gen, device=dev)]
    pad = torch.arange(n, device=dev)[None, :] >= n_pts[:, None]
    dm = torch.where(pad[:, :, None] | pad[:, None, :], 9.0, dm)
    dm = dm * (1.0 - torch.eye(n, device=dev))
    return dm.float().contiguous(), n_pts.to(torch.int32)


def grid_clouds(dev, n_windows: int = 2048, n: int = 18, seed: int = 5):
    """Clouds of n points on a 4 × 4 × 4 integer grid (many exactly tied
    float32 distances, zero ones between coincident points), made from a
    seed with numpy."""
    import numpy as np
    import torch

    pts = np.random.default_rng(seed).integers(0, 4, (n_windows, n, 3)).astype(np.float32)
    d = np.sqrt(((pts[:, :, None] - pts[:, None]) ** 2).sum(-1)) / 3.0
    d[:, np.arange(n), np.arange(n)] = 0.0
    return torch.as_tensor(d.astype(np.float32), device=dev).contiguous()


def nan_windows(d47, n_windows: int = 256):
    """The first n_windows of the features batch with what a window past a
    recording's end reads (NaN samples make every correlation NaN, the
    diagonal stays 0): a quarter all NaN, a quarter with one NaN channel."""
    import torch

    d = d47[:n_windows].clone()
    q = n_windows // 4
    eye = torch.eye(d.shape[-1], dtype=torch.bool, device=d.device)
    d[:q] = torch.where(eye, 0.0, torch.nan)
    d[q:2 * q, 5, :] = torch.nan
    d[q:2 * q, :, 5] = torch.nan
    d[q:2 * q, 5, 5] = 0.0
    return d.contiguous()


def signed_zero_windows(d47, n_windows: int = 256, seed: int = 7):
    """The first n_windows of the features batch with tied zero weights of
    both signs: in each window 12 channel pairs, chosen from a seed, at
    distance −0.0 or +0.0 (alternating, so that either sign comes first in
    static order), the diagonal −0.0 in every other window, and in half of
    the windows one channel NaN, +NaN or −NaN by turns."""
    import numpy as np
    import torch

    d = d47[:n_windows].clone()
    B, n = d.shape[0], d.shape[-1]
    rng = np.random.default_rng(seed)
    i = rng.integers(0, n, (B, 12))
    j = (i + rng.integers(1, n, (B, 12))) % n
    sign = (np.arange(12)[None, :] + np.arange(B)[:, None]) % 2 == 0
    val = torch.as_tensor(np.where(sign, -0.0, 0.0).astype(np.float32), device=d.device)
    bi = torch.as_tensor(np.repeat(np.arange(B), 12), device=d.device)
    i = torch.as_tensor(i.reshape(-1), device=d.device)
    j = torch.as_tensor(j.reshape(-1), device=d.device)
    d[bi, i, j] = val.reshape(-1)
    d[bi, j, i] = val.reshape(-1)
    diag = torch.arange(n, device=d.device)
    d[0::2, diag, diag] = -0.0
    nans = torch.as_tensor(np.array([0x7FC00000, 0xFFC00000], np.uint32)
                           .view(np.float32), device=d.device)
    c = rng.integers(0, n, B // 2)
    for w in range(B // 2):
        d[2 * w + 1, c[w], :] = nans[w % 2]
        d[2 * w + 1, :, c[w]] = nans[w % 2]
        d[2 * w + 1, c[w], c[w]] = 0.0
    return d.contiguous()


def same_bits(a, b) -> bool:
    """Equal dtype, shape and bits (floats compared as their int32 bits, so
    NaN equals NaN and −0.0 differs from +0.0)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def peak_bytes(fn):
    """Device memory a call of fn() allocates at its peak, beyond what was
    allocated before it."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def phase1_check(dm, n_pts, n, na_max, reps: int = 5, against_cpu: bool = False):
    """Phase 3b: the phase-1 kernel against the plain `_phase1` on the same
    inputs, bit for bit on every key: `_phase1` on the card, or with
    against_cpu on a CPU copy of the inputs (the edge order of the CPU's and
    JAX's stable sort; the card's plain version is then compared with the
    CPU's too, as a reading).  Also the instrumented build (same bits; the
    share of thread 0's ticks per part, the SMs' busy share); whether the
    card's own `torch.sort(stable=True)` gives the kernel's edge order (a
    reading).  Times (CUDA events): the launcher (`phase1_cuda`, one
    launch) and the plain version on the card; each one's peak memory above
    what was allocated before; the bound's two terms: dm (and n_pts) read
    once plus the dict written once over HBM, and two int32 compares per
    (edge, vertex) the sieve scans (`sieve_compares` on the plain vstar)
    at the int32 rate.  The launches made here are not counted."""
    import torch

    from tda_eeg_audio_tpu_torch.ops import cuda_build
    from tda_eeg_audio_tpu_torch.ops import homology_h1 as H
    from tda_eeg_audio_tpu_torch.ops import phase1_cuda as P1

    launches0 = P1.phase1_cuda.launches
    got = P1.phase1_cuda(dm, n, 2.0, na_max, n_pts)
    per_call = P1.phase1_cuda.launches - launches0
    want = card = H._phase1(dm, n, 2.0, na_max, n_pts)
    card_plain_matches_cpu = None
    if against_cpu:
        want = H._phase1(dm.cpu(), n, 2.0, na_max, None if n_pts is None else n_pts.cpu())
        card_plain_matches_cpu = all(same_bits(card[k].cpu(), want[k])
                                     for k in want if k != "m")
        got_cmp = {k: v if k == "m" else v.cpu() for k, v in got.items()}
    else:
        got_cmp = got
    mismatched = [k for k in want if not (
        got_cmp[k] == want[k] if k == "m" else same_bits(got_cmp[k], want[k]))]
    if card_plain_matches_cpu is False:
        mismatched.append("the card's plain _phase1 against the CPU's")
    err = 0.0
    for k in ("ew_r", "h0_deaths"):
        a, b = got_cmp[k], want[k]
        same = (a == b) | (a.isnan() & b.isnan())
        if not bool(same.all()):
            err = max(err, float((a - b).abs()[~same].nan_to_num(nan=float("inf")).max()))

    # the edge order of the card's plain _phase1 and of the card's own
    # stable sort of the static-order weights against the kernel's (static
    # index of each rank from its endpoints)
    B = dm.shape[0]
    flat = torch.as_tensor(H.static_tables(n)["flat_ut"], device=dm.device)
    card_order = torch.sort(dm.reshape(B, n * n)[:, flat], dim=-1, stable=True).indices
    i, j = got["iu_r"].long(), got["ju_r"].long()
    has_nan = dm.isnan().flatten(1).any(-1)
    neg_nan = (dm.isnan() & (dm.view(torch.int32) < 0)).flatten(1).any(-1)

    def agreement(agree):
        return dict(windows=int(agree.sum()), of=int(B),
                    nan_windows=int((agree & has_nan).sum()), of_nan=int(has_nan.sum()),
                    neg_nan_windows=int((agree & neg_nan).sum()),
                    of_neg_nan=int(neg_nan.sum()))

    card_sort_agrees = dict(
        plain=agreement(((card["iu_r"] == got["iu_r"]) & (card["ju_r"] == got["ju_r"])).all(-1)),
        torch_sort=agreement((card_order == i * n - i * (i + 1) // 2 + j - i - 1).all(-1)))

    prof = P1.phase1_cuda_profiled(dm, n, 2.0, na_max, n_pts)
    if not all(same_bits(prof[k], got[k]) for k in got if k != "m"):
        mismatched.append("instrumented build")
    n_sms = torch.cuda.get_device_properties(dm.device).multi_processor_count
    lib_p = cuda_build.load(P1.SRC, P1.SIGNATURES, P1.PROFILE_FLAGS)
    phases = phase1_profile_reading(prof["prof"], prof["stamps"], n_sms,
                                    P1.blocks_per_sm(n, lib_p))

    run_kernel = lambda: P1.phase1_cuda(dm, n, 2.0, na_max, n_pts)  # noqa: E731
    run_plain = lambda: H._phase1(dm, n, 2.0, na_max, n_pts)  # noqa: E731
    ms = cuda_ms(run_kernel, reps)
    plain_ms = cuda_ms(run_plain, 2)
    peak_kernel, peak_plain = peak_bytes(run_kernel), peak_bytes(run_plain)
    P1.phase1_cuda.launches = launches0

    in_bytes = dm.numel() * 4 + (0 if n_pts is None else n_pts.numel() * n_pts.element_size())
    out_bytes = sum(t.numel() * t.element_size() for t in want.values()
                    if torch.is_tensor(t))
    compares = int(P1.sieve_compares(want["vstar_r"], n).sum())
    plan = P1.kernel_plan(n, na_max)
    bits = dm.view(torch.int32)
    off = ~torch.eye(n, dtype=torch.bool, device=dm.device)
    return dict(n=n, windows=int(B), launches_per_call=per_call,
                mismatched=mismatched, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, peak_bytes=peak_kernel,
                plain_peak_bytes=peak_plain, bytes=in_bytes + out_bytes,
                compares=compares,
                t_bytes=(in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3,
                t_ops=compares / INT32_OPS_PER_S * 1e3,
                threads=plan["threads"], smem_bytes=plan["smem_bytes"],
                blocks_per_sm=P1.blocks_per_sm(n), phases=phases,
                against="cpu" if against_cpu else "card",
                card_sort_agrees=card_sort_agrees,
                card_plain_matches_cpu=card_plain_matches_cpu,
                m_cx_mean=float(want["m_cx"].double().mean()),
                creators_mean=float((want["na_list"] >= 0).sum(1).double().mean()),
                nan_windows=int(dm.isnan().any(-1).any(-1).sum()),
                signed_zero_edges=(int(((bits == -2**31) & off).sum()),
                                   int(((bits == 0) & off).sum())))


def main_path(batch, mis, cfg, dev):
    """One full-width batch through the three entry points, timed per stage,
    with the kernel's launches counted per stage."""
    import torch

    from tda_eeg_audio_tpu_torch.models import programs as P
    from tda_eeg_audio_tpu_torch.ops.homology_cuda import h1_diagrams_cuda
    from tda_eeg_audio_tpu_torch.ops.phase1_cuda import phase1_cuda
    from tda_eeg_audio_tpu_torch.ops.wasserstein_cuda import sinkhorn_tiered_cuda
    from tda_eeg_audio_tpu_torch.ops.wasserstein_h0_cuda import wasserstein_h0_cuda

    ms, launches, p1_launches, sk_launches, h0_launches = {}, {}, {}, {}, {}

    def stage(name, fn):
        before = h1_diagrams_cuda.launches
        before_p1 = phase1_cuda.launches
        before_sk = sinkhorn_tiered_cuda.launches
        before_h0 = wasserstein_h0_cuda.launches
        out, ms[name] = wall_ms(fn)
        launches[name] = h1_diagrams_cuda.launches - before
        p1_launches[name] = phase1_cuda.launches - before_p1
        sk_launches[name] = sinkhorn_tiered_cuda.launches - before_sk
        h0_launches[name] = wasserstein_h0_cuda.launches - before_h0
        return out

    agg, diag, ovf = stage("features", lambda: P.eeg_feature_program(
        batch["eeg"], batch["n_e"], batch["use_idx"], batch["use_mask"], cfg,
        K=K_FEAT, return_dm0=True, device=dev))
    mo = stage("mismatch_audio", lambda: P.audio_h1_program(
        mis["audio"], mis["n_a"], cfg, N_RS_MAX, N_WIN_MAX, K_CMP, device=dev))
    out = stage("comparison", lambda: P.comparison_program(
        batch["eeg"], batch["n_e"], batch["audio"], batch["n_a"],
        (mo["h1_b"], mo["h1_d"], mo["h1_m"]), mo["n_win"], mo["degen"], cfg,
        N_WIN_MAX, N_RS_MAX, K_CMP, device=dev))
    torch.cuda.synchronize()
    return dict(agg=agg, diag=diag, ovf=ovf, mo=mo, out=out, ms=ms,
                launches=launches, phase1_launches=p1_launches,
                sinkhorn_launches=sk_launches, h0_launches=h0_launches)


def float_ratio(got, ref, rtol):
    """Largest |got − ref| / (1e-5 + rtol·|ref|) over finite entries (NaN
    must sit at the same places); > 1 is a mismatch."""
    import numpy as np

    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if not np.array_equal(np.isnan(got), np.isnan(ref)):
        return float("inf")
    both = np.isfinite(got) & np.isfinite(ref)
    return float((np.abs(got - ref) / (1e-5 + rtol * np.abs(ref)))[both].max(
        initial=0.0))


def small_reference_check(dev, window_sec: float = 1.0, seed: int = 0):
    """A small batch through the slice on the card and on the CPU (plain
    reduction): floats within rtol 1e-4 / atol 1e-5 (the tiered Sinkhorn's
    w_h1 / w_h1_mis within its parity tolerance, rtol 2e-4), integers exact.

    The study's 1 s windows keep the check well conditioned: over 0.2 s
    windows the band-limited channels correlate near ±1, where
    d = sqrt(2(1 − r)) magnifies the card's and the CPU's FFT rounding to
    ~1e-5 in the distances, as large as the tolerance itself.  Returns the
    mismatched keys, each float key's largest |got − ref| / allowed, and the
    largest card − CPU difference of the features stage's distances."""
    import numpy as np
    import torch

    from tda_eeg_audio_tpu_torch.config import DEFAULT_CONFIG
    from tda_eeg_audio_tpu_torch.models import programs as P

    cfg = dataclasses.replace(DEFAULT_CONFIG, window_sec=window_sec,
                              fir_numtaps=101)
    B, n_win_max, K = 2, 12, 5
    win, step = cfg.win_samples, cfg.step_samples
    n_e = np.array([win + 7 * step, win + 8 * step], np.int32)
    T = win + (n_win_max - 1) * step
    n_rs_max = T + 100
    rng = np.random.default_rng(seed)
    eeg = np.zeros((B, 47, T), np.float32)
    for i, n in enumerate(n_e):
        eeg[i, :, :n] = rng.standard_normal((47, n))
    n_a = (n_e * cfg.fs_audio // cfg.fs_eeg).astype(np.int32)
    audio = np.zeros((B, int(n_a.max())), np.float32)
    for i, n in enumerate(n_a):
        audio[i, :n] = rng.standard_normal(n)
    use_idx = np.tile(np.arange(K, dtype=np.int32), (B, 5, 1))
    use_mask = np.ones((B, 5, K), bool)

    def run(d):
        agg, ovf = P.eeg_feature_program(eeg, n_e, use_idx, use_mask, cfg, K=K,
                                         device=d)
        mo = P.audio_h1_program(audio[::-1].copy(), n_a[::-1].copy(), cfg,
                                n_rs_max, n_win_max, K, device=d)
        out = P.comparison_program(eeg, n_e, audio, n_a,
                                   (mo["h1_b"], mo["h1_d"], mo["h1_m"]),
                                   mo["n_win"], mo["degen"], cfg, n_win_max,
                                   n_rs_max, K, device=d)
        out = dict(out, agg=agg, ovf=ovf)
        return {k: v.detach().cpu().numpy() for k, v in out.items()}

    got, ref = run(dev), run("cpu")
    bad, ratio = [], {}
    for k, r in ref.items():
        g = got[k]
        if r.dtype.kind == "f":
            rtol = 2e-4 if k in ("w_h1", "w_h1_mis") else 1e-4
            ratio[k] = float_ratio(g, r, rtol)
            ok = ratio[k] <= 1.0
        else:
            ok = np.array_equal(g, r)
        if not ok:
            bad.append(k)
    dist = [feature_distances(torch.as_tensor(eeg, device=d),
                              torch.as_tensor(n_e, device=d).long(), use_idx,
                              cfg).cpu() for d in (dev, "cpu")]
    return bad, ratio, float((dist[0] - dist[1]).abs().max())


def capture_calls(fn, *targets):
    """Run fn() with each (module, name) function wrapped so that copies of
    the tensors of every call are kept.  Returns (fn's result, one list of
    argument tuples per target)."""
    kept = [[] for _ in targets]
    saved = [getattr(m, n) for m, n in targets]

    def wrap(route, store):
        def keep(*args, **kw):
            store.append(tuple(x.clone() for x in args))
            return route(*args, **kw)
        return keep

    for (m, n), route, store in zip(targets, saved, kept):
        setattr(m, n, wrap(route, store))
    try:
        out = fn()
    finally:
        for (m, n), route in zip(targets, saved):
            setattr(m, n, route)
    return out, kept


def study_bars(rng, counts, K):
    """Study-shaped H1 bars (births 0.3–1.5, exponential persistence of mean
    0.15) with the given counts, scattered over K-slot rows (numpy)."""
    import numpy as np

    b = np.zeros((len(counts), K), np.float32)
    d = np.zeros((len(counts), K), np.float32)
    m = np.zeros((len(counts), K), bool)
    for i, c in enumerate(counts):
        pos = rng.choice(K, size=c, replace=False)
        bb = rng.uniform(0.3, 1.5, c).astype(np.float32)
        m[i, pos] = True
        b[i, pos] = bb
        d[i, pos] = bb + rng.exponential(0.15, c).astype(np.float32)
    return b, d, m


def sinkhorn_class_pairs(dev, per_class: int = 8, seed: int = 5):
    """Pairs that reach every width class of the kernel: bar counts per side
    at each class's edges (0 = the [[0, 0]] sentinel; 16 | 17, 40 | 41,
    80 | 81; 90 and 96 at the full width), study-shaped bars scattered over
    96-slot rows (`study_bars`), made from a seed with numpy."""
    import numpy as np
    import torch

    counts = [(0, 0), (0, 5), (5, 0), (1, 1), (16, 16), (17, 3), (3, 17),
              (40, 40), (41, 2), (80, 80), (81, 81), (90, 90), (96, 96),
              (96, 0)] * per_class
    rng = np.random.default_rng(seed)
    sides = [study_bars(rng, [c[side] for c in counts], 96) for side in (0, 1)]
    return tuple(torch.as_tensor(x, device=dev) for x in (*sides[0], *sides[1]))


def sinkhorn_bound(pairs, clock_hz, chunk: int = 128):
    """The tiered Sinkhorn's least time on these pairs, counted at the widths
    the function needs, each pair's own tier (S = 2 × the smallest tier that
    holds its larger side; wider pads only add zero-cost pad↔pad matches):
    FP32 operations (two S × S multiply-add matvecs, 4·S², per iteration)
    over 67 TFLOP/s; expf (S² per absorption and once at the end) over the
    SFU rate at the card's max SM clock; bytes (bars and masks read once,
    one float written per pair) over HBM.  Also, as a reading, the operation
    time at the widths the plain version runs (pairs sorted by bar count
    into 128-pair chunks, each at the tier of its widest pair), and the
    pairs per width class of both."""
    import numpy as np
    import torch

    from tda_eeg_audio_tpu_torch.ops import wasserstein_cuda as WC

    b1, _, m1, b2, _, m2 = pairs
    N, K1, K2 = b1.shape[0], b1.shape[1], b2.shape[1]
    r = torch.maximum(m1.sum(1), m2.sum(1)).cpu().numpy()
    kernel_w = np.array([WC.pair_width(int(c)) for c in r])
    ordered = np.sort(r)[::-1]
    plain_w = np.empty(N, np.int64)
    for c in range(0, N, chunk):
        plain_w[c:c + chunk] = WC.pair_width(int(ordered[c]))
    absorptions = WC.STEPS * -(-WC.ITERS // WC.ABSORB)
    sfu_rate = SFU_PER_SM_CLOCK * N_SMS * clock_hz

    def op_times(widths):
        S2 = float(((2.0 * widths) ** 2).sum())
        flops, exps = 4 * S2 * WC.STEPS * WC.ITERS, S2 * (absorptions + 1)
        return flops, exps, flops / FP32_FLOPS_PER_S * 1e3, exps / sfu_rate * 1e3

    flops, exps, t_fp32, t_sfu = op_times(kernel_w)
    bytes_ = N * (K1 + K2) * 9 + N * 4
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    tally = lambda w: {int(k): int(v) for k, v in zip(*np.unique(w, return_counts=True))}  # noqa: E731
    return dict(t_ops=max(t_fp32, t_sfu), t_bytes=t_bytes, flops=flops, exps=exps,
                bytes=bytes_, t_fp32=t_fp32, t_sfu=t_sfu,
                t_ops_at_plain_widths=max(op_times(plain_w)[2:]),
                kernel_widths=tally(kernel_w), plain_widths=tally(plain_w))


def sinkhorn_rounding(pairs, got, ref):
    """On one set of pairs, the largest relative difference of the kernel's
    result `got` and of the plain version's `ref` from a float64 run of the
    same ladder, and of the plain version from itself on the pairs reversed
    (other chunks, so other matvec widths).  The first is phase 4b's second
    gate (SINKHORN_F64_RTOL); the other two are readings.  Also returns the
    float64 values (on the CPU)."""
    import torch

    from tda_eeg_audio_tpu_torch.models import programs as P

    b1, d1, m1, b2, d2, m2 = pairs
    r64 = P.wass_sinkhorn_tiered_plain(b1.double(), d1.double(), m1,
                                       b2.double(), d2.double(), m2).cpu()
    rev = torch.arange(b1.shape[0] - 1, -1, -1, device=b1.device)
    r_rev = P.wass_sinkhorn_tiered_plain(*(x[rev] for x in pairs))[rev.argsort()]
    nz = r64 != 0

    def rel(x, y):
        return float(((x.double().cpu() - y) / y).abs()[nz].max())

    return dict(kernel_vs_float64=rel(got, r64), plain_vs_float64=rel(ref, r64),
                plain_vs_reordered=rel(r_rev, ref.double().cpu())), r64


def sinkhorn_kernel_check(main_pairs, dev, clock_hz):
    """Phase 4b: the tiered Sinkhorn kernel against its plain version on the
    card, on phase 4's pairs (`main`) and on pairs of every width class
    (`classes`), within SINKHORN_F64_RTOL of a float64 run of the ladder
    (`sinkhorn_rounding`) on every pair, and within SINKHORN_RTOL of each
    plain value on the pairs where the plain value lies within
    SINKHORN_PLAIN_NEAR_F64 of the float64 run (`held_to_plain` of `pairs`);
    the kernel path once under `torch.cuda.set_sync_debug_mode("error")`,
    which raises at any host synchronisation; timings (also of each width
    class's pairs alone) and the bound; each width class's layout as the
    library reports it (checked against `kernel_plan` at load), and the
    instrumented build's shares per part and SMs' busy share per class.
    The launches made here are not counted."""
    import torch

    from tda_eeg_audio_tpu_torch.models import programs as P
    from tda_eeg_audio_tpu_torch.ops import cuda_build
    from tda_eeg_audio_tpu_torch.ops import wasserstein_cuda as WC

    launches0 = WC.sinkhorn_tiered_cuda.launches
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib_p = cuda_build.load(WC.SRC, WC.SIGNATURES, WC.PROFILE_FLAGS)
    res = {"layout": WC.layout_report(), "layout_instrumented": WC.check_layout(lib_p)}
    for name, pairs in (("main", main_pairs), ("classes", sinkhorn_class_pairs(dev))):
        before = WC.sinkhorn_tiered_cuda.launches
        got = P._wass_sinkhorn_tiered(*pairs)
        per_call = WC.sinkhorn_tiered_cuda.launches - before
        ref, plain_ms = wall_ms(lambda: P.wass_sinkhorn_tiered_plain(*pairs))
        g, r = got.double().cpu(), ref.double().cpu()
        err = (g - r).abs()
        nz = r != 0
        rounding, r64 = sinkhorn_rounding(pairs, got, ref)
        near = (r - r64).abs() <= SINKHORN_PLAIN_NEAR_F64 * r64.abs()
        ms = cuda_ms(lambda: P._wass_sinkhorn_tiered(*pairs), reps=20)
        # the pairs of one width class alone (the other classes' launches
        # then only return): what each class costs
        counts = torch.maximum(pairs[2].sum(1), pairs[5].sum(1)).cpu()
        widths = torch.tensor([WC.pair_width(int(c)) for c in counts])
        ms_by_width = {}
        for w in WC.WIDTHS:
            idx = torch.nonzero(widths == w)[:, 0].to(pairs[0].device)
            if idx.numel():
                sub = [x[idx] for x in pairs]
                ms_by_width[w] = cuda_ms(lambda: P._wass_sinkhorn_tiered(*sub), reps=10)
        prof_out, prof, stamps = WC.sinkhorn_tiered_cuda_profiled(*pairs)
        res[name] = dict(
            phases=sinkhorn_profile_reading(prof, stamps, widths.numpy(), n_sms),
            instrumented_max_abs_diff=float((prof_out.double().cpu() - g).abs().max()),
            pairs=int(g.numel()), launches_per_call=per_call,
            finite=bool(torch.isfinite(g).all()), held_to_plain=int(near.sum()),
            within=bool((err <= SINKHORN_RTOL * r.abs())[near].all()),
            max_abs_err=float(err.max()),
            max_rel_err=float((err[nz] / r[nz].abs()).max()) if bool(nz.any()) else 0.0,
            zeros_exact=bool((g[~nz] == 0).all()), ms=ms, plain_ms=plain_ms,
            ms_by_width=ms_by_width, rounding=rounding,
            **sinkhorn_bound(pairs, clock_hz))
        res[name]["within_float64"] = \
            res[name]["rounding"]["kernel_vs_float64"] <= SINKHORN_F64_RTOL
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        P._wass_sinkhorn_tiered(*main_pairs)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize()
    res["no_host_sync"] = True
    WC.sinkhorn_tiered_cuda.launches = launches0
    return res


def plain_sinkhorn_log(pairs):
    """The plain un-tiered Sinkhorn (`sinkhorn_cost` over `build_cost_matrix`)
    on the pairs' device, in the router's pieces of SINKHORN_CHUNK pairs:
    what the router runs for CPU tensors."""
    import torch

    from tda_eeg_audio_tpu_torch.ops.wasserstein import (SINKHORN_CHUNK, build_cost_matrix,
                                                         sinkhorn_cost)

    chunk = SINKHORN_CHUNK
    return torch.cat([sinkhorn_cost(build_cost_matrix(*(x[c:c + chunk] for x in pairs)))
                      for c in range(0, pairs[0].shape[0], chunk)])


def sinkhorn_log_seeded_pairs(dev, n: int = 112, K: int = 128, seed: int = 11):
    """Phase 13's second set: n pairs made from a seed with numpy, 0–K bars
    a side drawn uniformly, the first four with side 1 empty, side 2 empty,
    both empty and both full."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    c1, c2 = rng.integers(0, K + 1, n), rng.integers(0, K + 1, n)
    c1[[0, 2, 3]], c2[[1, 2, 3]] = (0, 0, K), (0, 0, K)
    return tuple(torch.as_tensor(x, device=dev)
                 for x in (*study_bars(rng, c1, K), *study_bars(rng, c2, K)))


def masked_nan_births(pairs):
    """Phase 13's third set: `pairs` with a NaN birth in every masked slot,
    what an all-NaN window leaves in the slots of its diagram that hold no
    bar.  The kernel reads the bars of valid slots only, so its results on
    this set equal those on `pairs` bit for bit."""
    import torch

    b1, d1, m1, b2, d2, m2 = pairs
    return (torch.where(m1, b1, torch.nan), d1, m1,
            torch.where(m2, b2, torch.nan), d2, m2)


def sinkhorn_log_bound(pairs, clock_hz):
    """The un-tiered Sinkhorn's least time on these pairs: 481 S² expf a
    pair (480 logsumexp half-steps and the result) over the SFU rate at the
    card's max SM clock, S = n1 + n2 at each pair's own width (an empty side
    is the one [[0, 0]] bar) and, as a reading, S = K1 + K2 at the pad
    width; bytes (bars and masks read once, one float written a pair) over
    HBM."""
    import torch

    from tda_eeg_audio_tpu_torch.ops.sinkhorn_log_cuda import HALF_STEPS

    b1, _, m1, b2, _, m2 = pairs
    N, K1, K2 = b1.shape[0], b1.shape[1], b2.shape[1]
    S = (torch.clamp(m1.sum(1), min=1) + torch.clamp(m2.sum(1), min=1)).double().cpu()
    rate = SFU_PER_SM_CLOCK * N_SMS * clock_hz
    exps = float((S ** 2).sum()) * (HALF_STEPS + 1)
    exps_pad = float(N * (K1 + K2) ** 2 * (HALF_STEPS + 1))
    bytes_ = N * (K1 + K2) * 9 + N * 4
    return dict(t_ops=exps / rate * 1e3, t_ops_pad=exps_pad / rate * 1e3,
                t_bytes=bytes_ / HBM_BYTES_PER_S * 1e3, exps=exps, exps_pad=exps_pad,
                bytes=bytes_, S_mean=float(S.mean()), S_max=int(S.max()),
                S_pad=K1 + K2)


def sinkhorn_log_check(sets, clock_hz, same_bits=()):
    """Phase 13, kernel A: the un-tiered Sinkhorn kernel through its router
    (`sinkhorn_cost_pairs`) against the plain version on the card, on each
    set of pairs: within SINKHORN_LOG_RTOL of each plain float32 value and
    SINKHORN_LOG_F64_RTOL of a float64 run of the plain version, the same
    NaN / inf pattern, one launch a call; timed (CUDA events), the plain
    version timed, peak device memory a call of both, the bound at each
    pair's own width and at the pad width; once under
    `torch.cuda.set_sync_debug_mode("error")`; for each (a, b) of
    `same_bits`, whether the kernel's results on sets a and b are equal bit
    for bit.  The launches made here are not counted."""
    import torch

    from tda_eeg_audio_tpu_torch.ops import sinkhorn_log_cuda as SL
    from tda_eeg_audio_tpu_torch.ops.wasserstein import sinkhorn_cost_pairs

    launches0 = SL.sinkhorn_log_cuda.launches
    res = {"layout": SL.layout_report()}
    for name, pairs in sets.items():
        before = SL.sinkhorn_log_cuda.launches
        got = sinkhorn_cost_pairs(*pairs)
        per_call = SL.sinkhorn_log_cuda.launches - before
        ref, plain_ms = wall_ms(lambda: plain_sinkhorn_log(pairs))
        r64 = plain_sinkhorn_log([x.double() if x.is_floating_point() else x
                                  for x in pairs])
        g, r, r64 = got.double().cpu(), ref.double().cpu(), r64.cpu()
        fin = torch.isfinite(r)
        err, err64 = (g - r).abs()[fin], (g - r64).abs()[fin]
        nz = r[fin] != 0

        def rel(e, y):
            return float((e[nz] / y[fin][nz].abs()).max()) if bool(nz.any()) else 0.0

        b1, d1, m1, b2, d2, m2 = pairs
        nan_bars = ((m1 & ~(torch.isfinite(b1) & torch.isfinite(d1))).any(1)
                    | (m2 & ~(torch.isfinite(b2) & torch.isfinite(d2))).any(1))
        n1 = torch.clamp(m1.sum(1), min=1).cpu()
        n2 = torch.clamp(m2.sum(1), min=1).cpu()
        lanes = [SL.lanes(int(a + b)) for a, b in zip(n1, n2)]
        res[name] = dict(
            pairs=int(g.numel()), launches_per_call=per_call,
            pairs_by_lanes={L: lanes.count(L) for L in (8, 4, 2, 1)},
            table_pairs=sum(int(a) * SL.table_pitch(int(b), L) <= SL.TABLE_DOUBLES
                            for a, b, L in zip(n1, n2, lanes)),
            nonfinite_bar_pairs=int(nan_bars.sum()),
            same_nonfinite=bool(torch.equal(torch.isfinite(g), fin)),
            within=bool((err <= SINKHORN_LOG_RTOL * r[fin].abs()).all()),
            within_float64=bool((err64 <= SINKHORN_LOG_F64_RTOL * r64[fin].abs()).all()),
            max_abs_err=float(err.max()) if err.numel() else 0.0,
            max_rel_err=rel(err, r), max_rel_err_vs_float64=rel(err64, r64),
            plain_vs_float64=rel((r - r64).abs()[fin], r64),
            ms=cuda_ms(lambda: sinkhorn_cost_pairs(*pairs), reps=5), plain_ms=plain_ms,
            peak_bytes=peak_bytes(lambda: sinkhorn_cost_pairs(*pairs)),
            plain_peak_bytes=peak_bytes(lambda: plain_sinkhorn_log(pairs)),
            **sinkhorn_log_bound(pairs, clock_hz))
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for pairs in sets.values():
            sinkhorn_cost_pairs(*pairs)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize()
    res["no_host_sync"] = True
    for a, b in same_bits:
        res[a][f"same_bits_as_{b}"] = bool(torch.equal(
            sinkhorn_cost_pairs(*sets[a]), sinkhorn_cost_pairs(*sets[b])))
    SL.sinkhorn_log_cuda.launches = launches0
    return res


def h0_staged_inputs(dev, n: int = 256, seed: int = 13):
    """Phase 13's staged set for kernel B: n pairs of H0 deaths at the staged
    path's pads (64 / 128), ~70 % of the slots valid, made from a seed with
    numpy: side 1 all pad, side 2 all pad, both all pad, a single bar
    against a single bar, a single bar against a full side, and tied
    deaths."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    d1 = rng.exponential(0.5, (n, 64)).astype(np.float32)
    d2 = rng.exponential(0.5, (n, 128)).astype(np.float32)
    m1, m2 = rng.random((n, 64)) < 0.7, rng.random((n, 128)) < 0.7
    m1[0] = m2[1] = m1[2] = m2[2] = False
    m1[3], m2[3] = np.arange(64) == 7, np.arange(128) == 100
    m1[4], m2[4] = np.arange(64) == 0, True
    d1[5:9], d2[5:9] = np.round(d1[5:9] * 8) / 8, np.round(d2[5:9] * 8) / 8
    return tuple(torch.as_tensor(x, device=dev) for x in (d1, m1, d2, m2))


def h0_check(sets):
    """Phase 13, kernel B: the exact H0 DP kernel through its router
    (`wasserstein_h0_exact`) against the plain loop on the card within
    H0_RTOL, one launch a call; bit for bit against the plain loop on the
    CPU (a reading); timed (CUDA events), the plain loop timed, the bound:
    the larger of the bytes (deaths and masks read once, one float written a
    pair) and the operations (the DP's cells, the sorts' compares).  The
    launches made here are not counted."""
    import torch

    from tda_eeg_audio_tpu_torch.ops import wasserstein_h0_cuda as WH
    from tda_eeg_audio_tpu_torch.ops.wasserstein import (wasserstein_h0_exact,
                                                         wasserstein_h0_exact_plain)

    launches0 = WH.wasserstein_h0_cuda.launches
    res = {"layout": WH.layout_report()}
    for name, args in sets.items():
        before = WH.wasserstein_h0_cuda.launches
        got = wasserstein_h0_exact(*args)
        per_call = WH.wasserstein_h0_cuda.launches - before
        ref, plain_ms = wall_ms(lambda: wasserstein_h0_exact_plain(*args))
        cpu = wasserstein_h0_exact_plain(*(x.cpu() for x in args))
        g, r = got.double().cpu(), ref.double().cpu()
        err = (g - r).abs()
        N, K1, K2 = args[0].shape[0], args[0].shape[1], args[2].shape[1]
        bytes_ = N * (K1 + K2) * 5 + N * 4
        # the DP's cells at ~8 float32 operations each and a comparison
        # sort's K ceil(log2 K) compares a side, at the FP32 rate
        ops = N * (8 * K1 * (K2 + 1) + K1 * (K1 - 1).bit_length()
                   + K2 * (K2 - 1).bit_length())
        res[name] = dict(
            pairs=N, K=(K1, K2), launches_per_call=per_call,
            within=bool((err <= H0_RTOL * r.abs()).all()),
            finite=bool(torch.isfinite(g).all()),
            max_abs_err=float(err.max()), bit_for_bit_vs_cpu=bool(torch.equal(got.cpu(), cpu)),
            ms=cuda_ms(lambda: wasserstein_h0_exact(*args), reps=20), plain_ms=plain_ms,
            t_bytes=bytes_ / HBM_BYTES_PER_S * 1e3, t_ops=ops / FP32_FLOPS_PER_S * 1e3)
    WH.wasserstein_h0_cuda.launches = launches0
    return res


def study_sample_tables():
    """The features stage's sample tables of the full synthetic study (45
    subjects × 16 slow + 16 fast, `build_synthetic_device`'s index and
    durations): stems in the stage's order, nw from the EEG length, n_pair =
    min(audio windows, nw), as the runner builds them."""
    import numpy as np

    from tda_eeg_audio_tpu_torch.config import DEFAULT_CONFIG as cfg
    from tda_eeg_audio_tpu_torch.io.synthetic import synth_dataset_index
    from tda_eeg_audio_tpu_torch.ops.signal import resample_n_out
    from tda_eeg_audio_tpu_torch.ops.window_sample import SampleTables

    index = synth_dataset_index()
    order = [i for cond in ("slow", "fast") for i in sorted(
        (i for i in range(len(index)) if index[i][2] == cond), key=lambda i: index[i][0])]
    nw, n_aw = [], []
    for i in order:
        fn, subj, cond = index[i]
        r = np.random.default_rng((int(subj[2:]) * 1000003 + int(fn[7:9]) * 101
                                   + (0 if cond == "slow" else 1)) & 0x7FFFFFFF)
        dur = np.float32(r.uniform(17.0, 23.0) if cond == "slow" else r.uniform(10.6, 15.5))
        n_e = min(int(np.round(dur * np.float32(cfg.fs_eeg))), 5800)
        n_rs = int(resample_n_out(int(dur * np.float32(cfg.fs_audio)), cfg.fs_eeg,
                                  cfg.fs_audio))
        nw.append((n_e - cfg.win_samples) // cfg.step_samples + 1)
        n_aw.append(max((n_rs - cfg.win_samples) // cfg.step_samples + 1, 0))
    nw = np.array(nw)
    return SampleTables([index[i][0].replace(".mat", "") for i in order], nw,
                        np.minimum(n_aw, nw), cfg.window_sampling, cfg.window_sample_seed)


def window_sample_check(dev, batch: int = 64, reps: int = 20):
    """Phase 15: the md5 window sample kernel through its router on the
    study's 7,200 lanes (1,440 recordings, K = min nw, the bank's K_CMP
    paired columns), in one launch and in the runner's launches of `batch`
    recordings, bit for bit against NumPy's draw (`window_sample_plain`);
    its device ms (CUDA events over `reps` launches), the launch's host µs
    (the call's enqueue, no synchronisation; median of `reps`) and NumPy's
    host ms for the same lanes.  The launches made here are not counted."""
    import numpy as np
    import torch

    from tda_eeg_audio_tpu_torch.ops import window_sample_cuda as WSC
    from tda_eeg_audio_tpu_torch.ops.window_sample import window_sample, window_sample_plain

    launches0 = WSC.window_sample_cuda.launches
    layout = WSC.layout_report()
    tab = study_sample_tables()
    N = len(tab.stems)
    K = int(tab.nw.min())
    Kx = K + K_CMP
    t0 = time.perf_counter()
    ref_idx, ref_mask = window_sample_plain(tab, 0, N, K, Kx)
    numpy_ms = (time.perf_counter() - t0) * 1e3
    tab.on(dev)
    idx, mask = window_sample(tab, 0, N, K, Kx, dev)
    whole = bool(np.array_equal(idx.cpu().numpy(), ref_idx)
                 and np.array_equal(mask.cpu().numpy(), ref_mask))
    parts = [window_sample(tab, b0, min(batch, N - b0), K, Kx, dev)
             for b0 in range(0, N, batch)]
    batched = bool(np.array_equal(torch.cat([p[0] for p in parts]).cpu().numpy(), ref_idx)
                   and np.array_equal(torch.cat([p[1] for p in parts]).cpu().numpy(),
                                      ref_mask))
    torch.cuda.synchronize()
    host_us = []
    for _ in range(reps):
        t0 = time.perf_counter()
        window_sample(tab, 0, batch, K, Kx, dev)
        host_us.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    res = dict(lanes=5 * N, K=K, Kx=Kx, nw=(int(tab.nw.min()), int(tab.nw.max())),
               bit_for_bit=whole, bit_for_bit_batched=batched, numpy_ms=numpy_ms,
               ms=cuda_ms(lambda: window_sample(tab, 0, N, K, Kx, dev), reps=reps),
               ms_batch=cuda_ms(lambda: window_sample(tab, 0, batch, K, Kx, dev), reps=reps),
               host_us_batch=float(np.median(host_us)), batch=batch, layout=layout)
    WSC.window_sample_cuda.launches = launches0
    return res


FP32_FLOPS_PER_S = 67e12   # FP32 rate of an H100 SXM outside the tensor cores


def window_distance_inputs(dev, B: int = 64, T: int = 5800, K: int = K_FEAT + K_CMP,
                           seed: int = 0):
    """A features batch of the study's shapes on the card: the FIR bank's
    strided output (B, 47, 5, T) of B recordings whose neighbouring
    electrodes correlate, and a (B, 5, K) sample of its windows."""
    import torch

    from tda_eeg_audio_tpu_torch.config import DEFAULT_CONFIG as cfg
    from tda_eeg_audio_tpu_torch.models import programs as P
    from tda_eeg_audio_tpu_torch.ops.signal import bandpass_bank

    g = torch.Generator(device=dev).manual_seed(seed)
    eeg = torch.randn((B, 47, T), generator=g, device=dev)
    eeg = eeg + 0.8 * torch.roll(eeg, 1, dims=1)
    banded = bandpass_bank(eeg, P._fir_bank(cfg, dev))
    n_win = (T - cfg.win_samples) // cfg.step_samples + 1
    idx = torch.randint(0, n_win, (B, 5, K), generator=g, device=dev)
    return banded, idx


def window_distance_check(dev, reps: int = 20):
    """Phase 16: the window → correlation-distance kernel through its router
    at a features batch (64 recordings × 5 bands × 54 windows from the FIR
    bank's strided output, and window 0 as the 55th column, as the features
    program launches it) and a comparison batch (15 windows, one index set
    for every band), held as tests/test_torch_window_distance.py holds it:
    NaN and zero entries identical to the plain chain's, and r (read
    through the "standard" distance, d = 1 − r) within 1e-6 of the plain
    chain run in float64 and no farther from it than the float32 plain
    chain (whose own distance from float64 is printed beside it); the
    euclidean distance's largest difference from the float32 chain (a
    reading); CUDA-event ms of each (the kernel over `reps` calls, the plain
    chain over 3), a launch's host µs, and the bound: the banded signal read
    once and the distances written once at HBM_BYTES_PER_S, against
    C(C+1)/2 · win FMAs a window at FP32_FLOPS_PER_S.  The launches made
    here are not counted."""
    import numpy as np
    import torch

    from tda_eeg_audio_tpu_torch.config import DEFAULT_CONFIG as cfg
    from tda_eeg_audio_tpu_torch.ops import window_distance_cuda as WDC
    from tda_eeg_audio_tpu_torch.ops.geometry import window_distances, window_distances_plain

    launches0 = WDC.window_distances_cuda.launches
    layout = WDC.layout_report()
    win, step = cfg.win_samples, cfg.step_samples
    banded, idx = window_distance_inputs(dev)
    B, C = banded.shape[:2]
    feat_idx = torch.cat([idx, idx.new_zeros((B, 5, 1))], dim=2)
    cmp_idx = idx[:, :1, :K_CMP].expand(-1, 5, -1)
    res = dict(layout=layout, shape=dict(B=B, C=C, T=banded.shape[-1],
                                         band_stride=banded.stride(2)))
    for name, ix in (("features", feat_idx), ("comparison", cmp_idx)):
        got = window_distances(banded, ix, "standard", win, step)
        want = window_distances_plain(banded, ix, "standard", win, step)
        f64 = window_distances_plain(banded.double(), ix, "standard", win, step)
        ok = ~torch.isnan(f64)
        eu = [f(banded, ix, "euclidean", win, step)
              for f in (window_distances, window_distances_plain)]
        torch.cuda.synchronize()
        host_us = []
        for _ in range(reps):
            t0 = time.perf_counter()
            window_distances(banded, ix, cfg.distance_method, win, step)
            host_us.append((time.perf_counter() - t0) * 1e6)
        windows = ix.numel()
        t_bytes = (banded.numel() + windows * C * C) * 4 / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * windows * C * (C + 1) // 2 * win / FP32_FLOPS_PER_S * 1e3
        res[name] = dict(
            windows=windows,
            same_nan=bool(torch.equal(torch.isnan(got), torch.isnan(want))),
            same_zero=bool(torch.equal(got == 0, want == 0)),
            max_dr_vs_float64=float((got.double() - f64)[ok].abs().max()),
            plain_max_dr_vs_float64=float((want.double() - f64)[ok].abs().max()),
            max_dr_vs_plain=float((got - want)[ok].abs().max()),
            max_d_euclidean=float((eu[0] - eu[1]).abs().nan_to_num(0.0).max()),
            ms=cuda_ms(lambda: window_distances(banded, ix, cfg.distance_method, win, step),
                       reps=reps),
            plain_ms=cuda_ms(lambda: window_distances_plain(banded, ix, cfg.distance_method,
                                                            win, step), reps=3),
            host_us=float(np.median(host_us)),
            bound_ms=max(t_bytes, t_ops), bytes_ms=t_bytes, ops_ms=t_ops)
        r = res[name]
        r["held"] = r["same_nan"] and r["same_zero"] and r["max_dr_vs_float64"] < 1e-6 \
            and r["max_dr_vs_float64"] <= r["plain_max_dr_vs_float64"]
    WDC.window_distances_cuda.launches = launches0
    return res


def runner_phase(store, cfg, eeg_batch=B_REC, eeg_bank=True,
                 feature_na_max=NA_FEAT, comparison_spans=False,
                 control_spans=False, mesh=None):
    """The whole study on the store through the runner's three entry points
    at the given knobs, each stage between two device synchronisations, the
    kernels' launch counts zeroed just before and read per stage; with
    `comparison_spans` / `control_spans`, that stage's parts timed by its
    own spans (summed over its batches; every span synchronises, so the
    stage's seconds then include them).  With a `mesh`, the runner's
    data-parallel shards, and the launches of SHARD_KERNELS counted per
    shard (the report's `shard_launches`).  Returns (report, problems, X,
    the comparison's detailed rows)."""
    import numpy as np

    from tda_eeg_audio_tpu_torch.models.homology_exec import run_tda
    from tda_eeg_audio_tpu_torch.models.study import BAND_NAMES, StudyRunner
    from tda_eeg_audio_tpu_torch.ops.homology_cuda import h1_diagrams_cuda
    from tda_eeg_audio_tpu_torch.ops.iir_cuda import sosfiltfilt_bank_cuda
    from tda_eeg_audio_tpu_torch.ops.phase1_cuda import phase1_cuda
    from tda_eeg_audio_tpu_torch.ops.sinkhorn_log_cuda import sinkhorn_log_cuda
    from tda_eeg_audio_tpu_torch.ops.wasserstein_cuda import sinkhorn_tiered_cuda
    from tda_eeg_audio_tpu_torch.ops.wasserstein_h0_cuda import wasserstein_h0_cuda
    from tda_eeg_audio_tpu_torch.ops.window_distance_cuda import window_distances_cuda
    from tda_eeg_audio_tpu_torch.ops.window_sample_cuda import window_sample_cuda
    from tda_eeg_audio_tpu_torch.runtime import timed_spans

    n_rec = len(store)
    wrappers = dict(launches=h1_diagrams_cuda, phase1_launches=phase1_cuda,
                    sosfiltfilt_launches=sosfiltfilt_bank_cuda,
                    sinkhorn_launches=sinkhorn_tiered_cuda,
                    sinkhorn_log_launches=sinkhorn_log_cuda,
                    h0_launches=wasserstein_h0_cuda,
                    window_sample_launches=window_sample_cuda,
                    window_distance_launches=window_distances_cuda)
    counts = {k: {} for k in wrappers}
    secs = {}
    with tempfile.TemporaryDirectory() as td:
        runner = StudyRunner(store, cfg, eeg_batch=eeg_batch,
                             eeg_bank=eeg_bank, feature_na_max=feature_na_max,
                             results_dir=td, verbose=False, mesh=mesh)
        shard_launches = None
        if mesh is not None:
            # each shard's launches: those made between its turn and the next
            shard_launches = [dict.fromkeys(SHARD_KERNELS, 0) for _ in mesh]
            shards, per = runner._shards, runner.eeg_batch // len(mesh)

            def counted(idxs):
                for dev, part, sl in shards(idxs):
                    before = {k: wrappers[k].launches for k in SHARD_KERNELS}
                    yield dev, part, sl
                    for k in SHARD_KERNELS:
                        shard_launches[sl.start // per][k] += wrappers[k].launches - before[k]

            runner._shards = counted
        redone0 = run_tda.redone
        for w in wrappers.values():
            w.launches = 0

        def stage(name, fn):
            before = {k: w.launches for k, w in wrappers.items()}
            out, ms = wall_ms(fn)
            secs[name] = ms / 1e3
            for k, w in wrappers.items():
                counts[k][name] = w.launches - before[k]
            return out

        X, y, subjects, filenames, meta = stage(
            "features", runner.compute_feature_dataset)
        spans = timed_spans() if comparison_spans else contextlib.nullcontext()
        with spans as parts:
            cmp_out = stage("comparison",
                            lambda: runner.run_comparison(n_permutations=1000))
        spans = timed_spans() if control_spans else contextlib.nullcontext()
        with spans as control_parts:
            ctl = stage("control", runner.run_control)
        totals = {k: w.launches for k, w in wrappers.items()}
        launches, p1_launches = counts["launches"], counts["phase1_launches"]
        iir_launches, sk_launches = counts["sosfiltfilt_launches"], counts["sinkhorn_launches"]
        total, total_p1 = totals["launches"], totals["phase1_launches"]
        total_iir, total_sk = totals["sosfiltfilt_launches"], totals["sinkhorn_launches"]
        artifacts = sorted(p.name for p in Path(td).iterdir())
    rows = cmp_out["detailed_rows"]
    problems = []
    if X.shape != (n_rec, 220) or not np.isfinite(X).all():
        problems.append(f"X shape {X.shape} or not finite")
    if len(rows) != n_rec * 5:
        problems.append(f"{len(rows)} detailed rows, expected {n_rec * 5}")
    n_batches = -(-n_rec // eeg_batch) if eeg_bank else 0
    if runner._bank_served != n_batches or runner._bank_fallback != 0:
        problems.append(f"bank served {runner._bank_served} / fallback "
                        f"{runner._bank_fallback}, expected {n_batches} / 0")
    n_subj = len({s for _, s, _ in store.index})
    for band in BAND_NAMES:
        b, c = cmp_out["band_results"][band], ctl[band]
        ps = [b.get(k) for k in ("wass_h0_p", "wass_h1_p", "wass_h1_perm_p",
                                 "corr_p", "wass_h1_p_fdr")] + \
             [c.get("p"), c.get("p_fdr")]
        if b["n_subjects"] != n_subj or c.get("n") != n_subj or \
                not all(p is not None and np.isfinite(p) for p in ps):
            problems.append(f"band {band}: n {b['n_subjects']} / {c.get('n')}, "
                            f"p-values {ps}")
    if min(launches.values()) <= 0:
        problems.append(f"kernel launches by stage {launches}")
    # every chunk of h1_diagrams_cuda launches the phase-1 kernel, then the
    # reduction kernel
    if p1_launches != launches:
        problems.append(f"h1_phase1 launches by stage {p1_launches}, "
                        f"h1_reduce {launches}")
    # the IIR bank filters the EEG of every features batch (and of the
    # control's exact pairing); the FIR path launches it nowhere
    if (iir_launches["features"] > 0) != (cfg.filter_impl == "iir_scan"):
        problems.append(f"sosfiltfilt launches by stage {iir_launches}")
    # the comparison pass runs the tiered Sinkhorn once per batch
    if sk_launches["comparison"] <= 0:
        problems.append(f"sinkhorn_tiered launches by stage {sk_launches}")
    if runner.redo_counts["control_deviants"] < 1:
        problems.append("the control's exact redo did not run")
    # the exact H0 DP: one launch a comparison batch (and one a batch of the
    # overflow redo); the control's exact redo runs the un-tiered Sinkhorn
    if counts["h0_launches"]["comparison"] < -(-n_rec // eeg_batch):
        problems.append(f"wasserstein_h0 launches by stage {counts['h0_launches']}")
    if counts["sinkhorn_log_launches"]["control"] < 1:
        problems.append(f"sinkhorn_log launches by stage {counts['sinkhorn_log_launches']}")
    # the md5 window sample: one launch a features batch (a shard's each)
    if counts["window_sample_launches"]["features"] < -(-n_rec // eeg_batch):
        problems.append(f"window_sample launches by stage "
                        f"{counts['window_sample_launches']}")
    # the window distances: one launch a features batch (the sample and
    # window 0's diagnostics; a shard's each), one a comparison batch the
    # bank does not serve
    wd = counts["window_distance_launches"]
    if wd["features"] < -(-n_rec // eeg_batch) or \
            (not eeg_bank and wd["comparison"] < -(-n_rec // eeg_batch)):
        problems.append(f"window_distance launches by stage {wd}")
    if shard_launches is not None and not all(
            all(c[k] > 0 for k in SHARD_KERNELS) for c in shard_launches):
        problems.append(f"launches by shard {shard_launches}")
    expect = {"eeg_audio_tda_comparison.json", "eeg_audio_tda_detailed.csv",
              "matched_vs_mismatched.json"}
    if set(artifacts) != expect:
        problems.append(f"artifacts {artifacts}")
    report = dict(recordings=n_rec, filter_impl=cfg.filter_impl,
                  knobs=dict(eeg_batch=eeg_batch, eeg_bank=eeg_bank,
                             feature_na_max=feature_na_max), seconds=secs,
                  launches=launches, launches_total=total,
                  phase1_launches=p1_launches, phase1_launches_total=total_p1,
                  sosfiltfilt_launches=iir_launches,
                  sosfiltfilt_launches_total=total_iir,
                  sinkhorn_launches=sk_launches,
                  sinkhorn_launches_total=total_sk,
                  sinkhorn_log_launches=counts["sinkhorn_log_launches"],
                  sinkhorn_log_launches_total=totals["sinkhorn_log_launches"],
                  h0_launches=counts["h0_launches"],
                  h0_launches_total=totals["h0_launches"],
                  window_sample_launches=counts["window_sample_launches"],
                  window_sample_launches_total=totals["window_sample_launches"],
                  window_distance_launches=counts["window_distance_launches"],
                  window_distance_launches_total=totals["window_distance_launches"],
                  K=meta["K"],
                  bank_served=runner._bank_served,
                  bank_fallback=runner._bank_fallback,
                  control_deviants_redone=runner.redo_counts["control_deviants"],
                  overflow_recordings_redone=dict(
                      features=runner.redo_counts["features"],
                      comparison=runner.redo_counts["comparison"]),
                  overflow_windows_redone=run_tda.redone - redone0,
                  w_h1_p={b: cmp_out["band_results"][b]["wass_h1_p"]
                          for b in BAND_NAMES},
                  control_p={b: ctl[b]["p"] for b in BAND_NAMES})
    if shard_launches is not None:
        report["mesh"] = [str(d) for d in runner.mesh]
        report["shard_launches"] = shard_launches
    if comparison_spans:
        report["comparison_spans_ms"] = dict(parts)
    if control_spans:
        report["control_spans_ms"] = dict(control_parts)
    return report, problems, X, rows


def bank_vs_in_call(store, cfg):
    """One batch (the store's first B_REC recordings) through the runner's
    fused pass with the EEG side from the bank (`comparison_from_bank`) and
    computed in the call (`comparison_program`).  Returns the mismatched
    row fields and the largest error / tolerance per float field."""
    from tda_eeg_audio_tpu_torch.io.device_store import DeviceStore
    from tda_eeg_audio_tpu_torch.models.study import StudyRunner

    sub = DeviceStore(store.eeg[:B_REC], store.audio[:B_REC], store.ns_e[:B_REC],
                      store.ns_a[:B_REC], store.metas[:B_REC], store.index[:B_REC])
    banked = StudyRunner(sub, cfg, eeg_batch=B_REC, eeg_bank=True, verbose=False,
                         feature_na_max=NA_FEAT)
    banked.compute_feature_dataset()
    rows_b = banked._fused_rows()
    rows_c = StudyRunner(sub, cfg, eeg_batch=B_REC, eeg_bank=False,
                         verbose=False, feature_na_max=NA_FEAT)._fused_rows()
    if banked._bank_served != 1 or banked._bank_fallback != 0:
        return ["bank did not serve the batch"], {}
    if len(rows_b) != B_REC * 5:
        return [f"row counts {len(rows_b)} / {len(rows_c)}"], {}
    return rows_ratio(rows_b, rows_c)


def rows_ratio(rows, ref):
    """Comparison rows against reference rows: the mismatched fields (other
    integers or strings, or floats beyond phase 5's tolerances: the tiered
    Sinkhorn's rtol 2e-4, else 1e-4) and each float field's largest error /
    tolerance."""
    if len(rows) != len(ref):
        return [f"row counts {len(rows)} / {len(ref)}"], {}
    bad, ratio = set(), {}
    for rb, rc in zip(rows, ref):
        for k, v in rc.items():
            if isinstance(v, float):
                rtol = 2e-4 if k in ("wasserstein_h1", "w_mismatched") else 1e-4
                ratio[k] = max(ratio.get(k, 0.0), float_ratio(rb[k], v, rtol))
                if ratio[k] > 1.0:
                    bad.add(k)
            elif rb[k] != v:
                bad.add(k)
    return sorted(bad), ratio


def same_rows(rows, ref) -> bool:
    """Detailed rows equal field for field, bit for bit (NaN where the other
    row has NaN)."""
    def same(a, b):
        return a == b or (isinstance(a, float) and isinstance(b, float)
                          and a != a and b != b)

    return len(rows) == len(ref) and all(
        r.keys() == q.keys() and all(same(r[k], q[k]) for k in q)
        for r, q in zip(rows, ref))


def mesh_phase(store, cfg, x_ref, rows_ref):
    """Phase 14: the runner with a data-parallel mesh of two shards on this
    card (`mesh=[cuda:i, cuda:i]`) over phase 6's store, against phase 6's
    single-device run (X `x_ref`, detailed rows `rows_ref`, eeg_batch
    B_REC).  At eeg_batch 2 · B_REC each shard's batch is one of phase 6's
    batches, so X and the rows must equal phase 6's bit for bit.  At eeg_batch
    B_REC (shards of B_REC / 2) they are held under phase 12's gates (rows
    within phase 5's tolerances, X within rtol 1e-4: a batch's shape may move
    cuBLAS and cuFFT rounding), their bits a reading.  Every shard must
    launch each of SHARD_KERNELS.  Returns (readout, {name: report},
    problems)."""
    import numpy as np
    import torch

    dev = torch.device("cuda", torch.cuda.current_device())
    readout, reports, problems = {}, {}, []
    for name, batch in (("shard_batch", 2 * B_REC), ("same_batch", B_REC)):
        report, prob, X, rows = runner_phase(store, cfg, eeg_batch=batch, mesh=[dev, dev])
        reports[name] = report
        problems += [f"{name}: {p}" for p in prob]
        bad, ratio = rows_ratio(rows, rows_ref)
        readout[name] = dict(
            eeg_batch=batch, recordings_a_shard_batch=batch // 2,
            X_bit_for_bit=bool(np.array_equal(X, x_ref)),
            rows_bit_for_bit=same_rows(rows, rows_ref),
            X_max_abs_diff=float(np.abs(X - x_ref).max()),
            X_ratio=float_ratio(X, x_ref, 1e-4), rows_mismatched=bad,
            rows_ratio={k: round(v, 4) for k, v in ratio.items()},
            seconds=report["seconds"], shard_launches=report["shard_launches"])
    s = readout["shard_batch"]
    if not (s["X_bit_for_bit"] and s["rows_bit_for_bit"]):
        problems.append(f"two shards of phase 6's batch: X bit for bit "
                        f"{s['X_bit_for_bit']}, rows {s['rows_bit_for_bit']}")
    m = readout["same_batch"]
    if m["rows_mismatched"] or m["X_ratio"] > 1.0:
        problems.append(f"two shards at phase 6's eeg_batch: rows {m['rows_mismatched']}, "
                        f"X ratio {m['X_ratio']}")
    return readout, reports, problems


def throughput_phase(dev):
    """Phase 12's pass: `bench_torch.eeg_throughput` at the bench's shape
    (64 recordings × 5 bands × 40 windows, one warm and one timed pass),
    then the timed pass's first 2 recordings through `eeg_feature_program`
    on the CPU: agg within phase 5's tolerances, overflow flags equal.
    Returns (the bench's line, the CPU check, problems)."""
    import numpy as np

    import bench_torch
    from tda_eeg_audio_tpu_torch.config import DEFAULT_CONFIG
    from tda_eeg_audio_tpu_torch.models.programs import eeg_feature_program

    line, last = bench_torch.eeg_throughput(repeats=1, device=dev)
    n, K = 2, line["detail"]["K"]
    agg, ovf = eeg_feature_program(*(last[k][:n].cpu() for k in (
        "eeg", "ns", "use_idx", "use_mask")), DEFAULT_CONFIG, K=K,
        device="cpu")
    got = last["agg"][:n].cpu().numpy()
    cpu = dict(recordings=n, agg_ratio=float_ratio(got, agg.numpy(), 1e-4),
               agg_max_abs_diff=float(np.nanmax(np.abs(got - agg.numpy()))),
               ovf_equal=bool((last["ovf"][:n].cpu() == ovf).all()))
    problems = []
    if not line["ok"] or line["kernel_launches"] <= 0 \
            or line["phase1_launches"] != line["kernel_launches"]:
        problems.append(f"ok {line['ok']}, phase-1 launches "
                        f"{line['phase1_launches']}, reduction launches "
                        f"{line['kernel_launches']}")
    if line["n_windows"] != 64 * 5 * 40:
        problems.append(f"{line['n_windows']} windows")
    if cpu["agg_ratio"] > 1.0 or not cpu["ovf_equal"]:
        problems.append(f"card vs CPU {cpu}")
    return line, cpu, problems


def knobs_vs_defaults(store, cfg, knobs):
    """Phase 12's last part: the runner over the store at the defaults and
    at `knobs`, each with the comparison's spans timed.  X and the detailed
    rows must agree (bit for bit expected: every window's and pair's
    arithmetic is independent of the batch; else within phase 5's
    tolerances) and the windows and deviants redone must be equal.
    Returns (readout, {"default": report, "tuned": report}, problems)."""
    import numpy as np

    runs, problems = {}, []
    for name, kw in (("default", {}), ("tuned", knobs)):
        report, prob, X, rows = runner_phase(store, cfg, comparison_spans=True, **kw)
        runs[name] = dict(report=report, X=X, rows=rows)
        problems += [f"{name}: {p}" for p in prob]
    t, d = runs["tuned"], runs["default"]
    bad, ratio = rows_ratio(t["rows"], d["rows"])
    x_ratio = float_ratio(t["X"], d["X"], 1e-4)
    redo = {k: (t["report"][k], d["report"][k]) for k in (
        "overflow_windows_redone", "overflow_recordings_redone",
        "control_deviants_redone")}
    batches = {k: -(-len(store) // r["report"]["knobs"]["eeg_batch"])
               for k, r in runs.items()}
    readout = dict(
        knobs=knobs, X_bit_for_bit=bool(np.array_equal(t["X"], d["X"])),
        rows_equal=t["rows"] == d["rows"],
        X_max_abs_diff=float(np.abs(t["X"] - d["X"]).max()), X_ratio=x_ratio,
        rows_mismatched=bad, rows_ratio={k: round(v, 4) for k, v in ratio.items()},
        redo_tuned_vs_default=redo,
        seconds={k: r["report"]["seconds"] for k, r in runs.items()},
        comparison_batches=batches,
        comparison_spans_ms_per_batch={
            k: {s: ms / batches[k] for s, ms in r["report"]["comparison_spans_ms"].items()}
            for k, r in runs.items()},
        launches={k: r["report"]["launches"] for k, r in runs.items()},
        sinkhorn_launches={k: r["report"]["sinkhorn_launches"] for k, r in runs.items()})
    if bad or x_ratio > 1.0 or any(a != b for a, b in redo.values()):
        problems.append(f"rows {bad}, X ratio {x_ratio}, redo {redo}")
    return readout, {k: r["report"] for k, r in runs.items()}, problems


def overflow_redo_check(d47, thresh: float, na: int = 8):
    """`run_tda` on the n = 47 batch with an arena of `na` creators, too
    small for most windows (they overflow and are recomputed on the host
    engine), against the wide-arena kernel run.

    On generic distances every creator yields a visible bar, so a window
    that overflows the arena also has more than `na` bars and keeps its
    first `na` columns after the redo.  Both paths emit a window's bars in
    the same order, so (a) `run_tda`'s first `na` columns, H0 deaths and
    counts must equal the wide run's everywhere, and (b) the engine's full
    diagrams of the redone windows must equal the wide run's bar for bar."""
    import numpy as np
    import torch

    from tda_eeg_audio_tpu_torch.models.homology_exec import run_tda
    from tda_eeg_audio_tpu_torch.native.engine import rips_persistence_batch

    wide = run_tda(d47, thresh, na_max=128)
    if bool(wide["redone"].any()):
        return dict(problem="the wide-arena run overflowed")
    before = run_tda.redone
    tight = run_tda(d47, thresh, na_max=na)
    redone = tight["redone"]
    bad = []
    for k in ("births", "deaths"):
        a = torch.where(tight["mask"], tight[k], 0.0)
        b = torch.where(wide["mask"], wide[k], 0.0)[:, :na]
        if not torch.equal(a, b):
            bad.append(k)
    if not torch.equal(tight["mask"], wide["mask"][:, :na]):
        bad.append("mask")
    inf = float("inf")
    h0 = [torch.where(o["h0_mask"], o["h0_deaths"], inf).sort(dim=1).values
          for o in (tight, wide)]
    if not torch.equal(*h0):
        bad.append("h0_deaths")
    for k in ("n_essential", "n_comp"):
        if not torch.equal(tight[k], wide[k]):
            bad.append(k)
    full = wide["mask"].sum(1) <= na
    feat_err = float((tight["features"][full] - wide["features"][full]).abs().max()) \
        if bool(full.any()) else 0.0
    # (b) the engine's whole diagrams of the redone windows
    idx = torch.nonzero(redone).squeeze(1)
    host = rips_persistence_batch(d47[idx].cpu().numpy(), thresh=thresh,
                                  max_bars=128)
    want = {k: wide[k][idx].cpu().numpy() for k in ("births", "deaths", "mask")}
    if not np.array_equal(host["mask"], want["mask"]):
        bad.append("engine mask")
    for k in ("births", "deaths"):
        if not np.array_equal(np.where(host["mask"], host[k], 0.0),
                              np.where(want["mask"], want[k], 0.0)):
            bad.append(f"engine {k}")
    return dict(na_max=na, windows=int(d47.shape[0]), redone=int(redone.sum()),
                counted=run_tda.redone - before, mismatched=bad,
                untruncated_windows=int(full.sum()),
                engine_bars_compared=int(want["mask"].sum()),
                feature_max_abs_err=feat_err)


def write_mat_dataset(root: Path, n_subjects: int = 4):
    """n_subjects × {slow, fast} × 1 utterance of the port's synthetic
    recordings (full length: 65 × ~2,700–5,750 EEG samples, 10–23 s of
    44.1 kHz audio) as .mat files in the reference's layout: root/slow,
    root/fast, keys `subeeg`, `y` (a column), `Fs`.  Returns the index."""
    import numpy as np
    from scipy.io import savemat

    from tda_eeg_audio_tpu_torch.io.synthetic import SynthDataset

    ds = SynthDataset(n_subjects=n_subjects, n_per_subject=1, cache=False)
    for i, (fn, _, cond) in enumerate(ds.index):
        rec = ds.load(i)
        (root / cond).mkdir(parents=True, exist_ok=True)
        savemat(root / cond / fn, dict(subeeg=rec["eeg_raw"],
                                       y=rec["audio"][:, None],
                                       Fs=np.array([[rec["fs_audio"]]])))
    return ds.index


def _csv(path: Path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _header(path: Path):
    with open(path, newline="") as f:
        return next(csv.reader(f))


def cli_phase():
    """Phase 9: the CLI's commands on the card over .mat recordings, each
    command's kernel launches counted from 0 and read after it.  Returns
    (report, exact-vs-Sinkhorn reading, host-vs-device X ratio, problems)."""
    import numpy as np
    import torch

    from tda_eeg_audio_tpu_torch import cli
    from tda_eeg_audio_tpu_torch.models.homology_exec import run_tda
    from tda_eeg_audio_tpu_torch.ops.homology_cuda import h1_diagrams_cuda
    from tda_eeg_audio_tpu_torch.ops.phase1_cuda import phase1_cuda
    from tda_eeg_audio_tpu_torch.ops.sinkhorn_log_cuda import sinkhorn_log_cuda
    from tda_eeg_audio_tpu_torch.ops.wasserstein_cuda import sinkhorn_tiered_cuda
    from tda_eeg_audio_tpu_torch.ops.wasserstein_h0_cuda import wasserstein_h0_cuda
    from tda_eeg_audio_tpu_torch.ops.window_sample_cuda import window_sample_cuda

    report, problems = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        td = Path(tmp)
        data = td / "data"
        t0 = time.perf_counter()
        index = write_mat_dataset(data)
        n_rec = len(index)
        print(f"cli data: {n_rec} full-length recordings written as .mat files "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)

        def run(name, command, results, *extra):
            """One command in this process: seconds between two device
            synchronisations, kernel launches from 0, windows redone; its
            printout is kept, its last line reported."""
            out = io.StringIO()
            redone0 = run_tda.redone
            h1_diagrams_cuda.launches = 0
            phase1_cuda.launches = 0
            sinkhorn_tiered_cuda.launches = 0
            sinkhorn_log_cuda.launches = 0
            wasserstein_h0_cuda.launches = 0
            window_sample_cuda.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli.main([command, "--data", str(data), "--results",
                               str(td / results), *extra])
            torch.cuda.synchronize()
            lines = out.getvalue().strip().splitlines()
            report[name] = dict(seconds=time.perf_counter() - t0,
                                launches=h1_diagrams_cuda.launches,
                                phase1_launches=phase1_cuda.launches,
                                sinkhorn_launches=sinkhorn_tiered_cuda.launches,
                                sinkhorn_log_launches=sinkhorn_log_cuda.launches,
                                h0_launches=wasserstein_h0_cuda.launches,
                                window_sample_launches=window_sample_cuda.launches,
                                windows_redone=run_tda.redone - redone0,
                                said=lines[-1] if lines else "")
            if rc != 0:
                problems.append(f"{name}: rc {rc}")
            return td / results

        def need(cond, what):
            if not cond:
                problems.append(what)

        # preprocessed/ and graphs/
        pre = run("preprocess", "preprocess", "res", "--out", str(td / "pre"))
        graphs = run("graphs", "graphs", "res", "--out", str(td / "graphs"))
        need(_header(td / "pre" / "preprocessing_metadata.csv") == PRE_COLS,
             "preprocessing_metadata.csv columns")
        meta_rows = _csv(td / "pre" / "preprocessing_metadata.csv")
        need(len(meta_rows) == n_rec, "preprocessing_metadata.csv rows")
        for fn, _, cond in index:
            stem = fn.replace(".mat", "")
            d, g = td / "pre" / cond / stem, td / "graphs" / cond / stem
            need(sorted(p.name for p in d.iterdir()) == sorted(
                [f"{b}.npy" for b in BANDS] + ["audio.npy", "window_times.npy"]),
                f"preprocessed files of {cond}/{stem}")
            need(sorted(p.name for p in g.iterdir()) == sorted(
                f"{b}_{k}.npy" for b in BANDS for k in ("correlations", "distances")),
                f"graphs files of {cond}/{stem}")
            w = np.load(d / "gamma.npy", mmap_mode="r")
            dm = np.load(g / "gamma_distances.npy")
            need(w.shape[1:] == (47, 250) and dm.shape == (w.shape[0], 47, 47)
                 and np.isfinite(dm).all(), f"shapes of {cond}/{stem}")
        del pre, graphs

        # features: one shot, two partials + merge, and the host backend
        feat = run("features", "features", "feat", "--batch", "4")
        X = np.load(feat / "X.npy")
        need(X.shape == (n_rec, 220) and np.isfinite(X).all(), f"X {X.shape}")
        need(len((feat / "feature_names.txt").read_text().split()) == 220,
             "feature_names.txt")
        need(_header(feat / "metadata.csv") == META_COLS, "metadata.csv columns")
        half = str(n_rec // 2)
        run("features_partial_0", "features", "part", "--batch", "4",
            "--batch-start", "0", "--batch-end", half, "--write-partial")
        run("features_partial_1", "features", "part", "--batch", "4",
            "--batch-start", half, "--write-partial")
        part = run("features_merge", "features", "part", "--merge-partials")
        need(np.array_equal(np.load(part / "X.npy"), X)
             and (part / "filenames.txt").read_text()
             == (feat / "filenames.txt").read_text(),
             "partials + merge differ from the one-shot X")
        host = run("features_host", "features", "feat_host", "--batch", "4",
                   "--backend", "host")
        x_ratio = float_ratio(np.load(host / "X.npy"), X, 1e-4)
        need(x_ratio <= 1.0, f"--backend host X differs from the kernel's "
                             f"(largest error / tolerance {x_ratio:.3g})")

        # the comparison (fused Sinkhorn, then exact) and the exact control
        rows = {}
        # the exact commands name the device backend, the others take "auto":
        # both are the kernel's route
        for name, extra in (("compare", ()), ("compare_exact", (
                "--wasserstein", "exact", "--backend", "device"))):
            res = run(name, "compare", name, *extra)
            slim = json.loads((res / "eeg_audio_tda_comparison.json").read_text())
            need(list(slim) == CMP_KEYS and list(slim["band_results"]) == list(BANDS),
                 f"{name}: eeg_audio_tda_comparison.json keys")
            need(_header(res / "eeg_audio_tda_detailed.csv") == DETAILED_COLS,
                 f"{name}: eeg_audio_tda_detailed.csv columns")
            rows[name] = {(r["filename"], r["condition"], r["band"]): r
                          for r in _csv(res / "eeg_audio_tda_detailed.csv")}
            need(len(rows[name]) == n_rec * len(BANDS) and all(
                np.isfinite(float(r["wasserstein_h1"])) for r in rows[name].values()),
                f"{name}: detailed rows")
        need(rows["compare"].keys() == rows["compare_exact"].keys(), "row keys")
        exact_vs_sinkhorn = {}
        for band in BANDS:     # (Sinkhorn − exact) / exact per recording
            rel = np.array([(float(rows["compare"][k]["wasserstein_h1"])
                             - float(r["wasserstein_h1"])) / float(r["wasserstein_h1"])
                            for k, r in rows["compare_exact"].items() if k[2] == band])
            exact_vs_sinkhorn[band] = dict(max_abs_rel=float(np.abs(rel).max()),
                                           mean_abs_rel=float(np.abs(rel).mean()),
                                           mean_rel=float(rel.mean()))
        # the control: the fused pass and its deviants' exact pairing by the
        # un-tiered Sinkhorn kernel, then exact matching on the host
        for name, extra in (("control", ()), ("control_exact", (
                "--wasserstein", "exact", "--backend", "device"))):
            ctl = run(name, "control", name, *extra)
            res = json.loads((ctl / "matched_vs_mismatched.json").read_text())
            need(list(res) == list(BANDS) and all(
                "n" in res[b] and set(res[b].get("by_condition", {})) == {"slow", "fast"}
                for b in BANDS), f"{name}: matched_vs_mismatched.json keys")

        # EDA
        eda = run("eda", "eda", "eda")
        summary = json.loads((eda / "eda_summary.json").read_text())
        need(list(summary) == EDA_KEYS and summary["n_recordings"] == n_rec,
             "eda_summary.json keys")
        need(_header(eda / "file_inventory.csv") == INV_COLS
             and len(_csv(eda / "file_inventory.csv")) == n_rec,
             "file_inventory.csv")

    # the commands that compute diagrams on the card launch the kernel; the
    # host backend and the commands without diagrams launch none
    for name, r in report.items():
        on_card = name in ("features", "features_partial_0", "features_partial_1",
                           "compare", "compare_exact", "control", "control_exact")
        if (r["launches"] > 0) != on_card or r["phase1_launches"] != r["launches"]:
            problems.append(f"{name}: {r['launches']} h1_reduce and "
                            f"{r['phase1_launches']} h1_phase1 launches")
        # the fused Sinkhorn path's comparison runs the exact H0 DP on the
        # card; the exact commands match H0 on the host
        if (r["h0_launches"] > 0) != (name in ("compare", "control")):
            problems.append(f"{name}: {r['h0_launches']} wasserstein_h0 launches")
        # only the control's exact redo, and the comparison's overflow redo,
        # reach the un-tiered Sinkhorn
        if r["sinkhorn_log_launches"] and name not in ("compare", "control"):
            problems.append(f"{name}: {r['sinkhorn_log_launches']} sinkhorn_log launches")
    return report, exact_vs_sinkhorn, x_ratio, problems


def max_sm_clock_hz() -> float:
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(res.stdout.strip().splitlines()[0]) * 1e6


def iir_bound(n, T: int, n_bands: int, n_sections: int, edge: int, clock_hz):
    """The sosfiltfilt kernel's least time on this run's data: bytes (x read
    once, the bands written once, n and the coefficients) over HBM, FP64
    operations (IIR_FLOPS per section and sample over both passes: the
    forward pass's n + 2·edge samples and the backward's n + edge a chain)
    over the FP64 rate; and an estimate of the chain floor, 2 dependent FP64
    FMAs per sample and pass on the longest chain at an assumed
    FP64_FMA_CYCLES each.  n: one length per series."""
    n = n.reshape(-1).clamp(0, T).double()
    n_series = n.numel()
    samples = (2 * n + 3 * edge) * n_bands                   # per series
    flops = float(samples.sum()) * n_sections * IIR_FLOPS
    bytes_ = n_series * T * 4 + n_series * 4 + n_series * n_bands * T * 4 \
        + n_bands * n_sections * 8 * 8
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP64_FLOPS_PER_S * 1e3
    chain = float(2 * n.max() + 3 * edge) * 2 * FP64_FMA_CYCLES / clock_hz * 1e3
    return dict(t_bytes=t_bytes, t_ops=t_ops, chain_estimate_ms=chain,
                bytes=bytes_, flops=flops)


def iir_kernel_check(dev, eeg64, n64, clock_hz):
    """Phase 10a: the sosfiltfilt kernel against its plain recurrence on the
    card and against scipy.  Returns a dict of the comparisons, timings and
    launch plans at the ragged 2-recording shape, at the main path's
    16-recording batch (eeg64[:16]), at the runner's tuned batch of 64
    recordings (eeg64 (64, 47, T_pad), n64 (64,)) and on one series of
    T = 40,000 (the extension staged through device memory).  The launches
    made here are not counted."""
    import numpy as np
    import torch
    from scipy import signal as sps

    from tda_eeg_audio_tpu_torch.ops import cuda_build
    from tda_eeg_audio_tpu_torch.ops import iir_cuda as IC
    from tda_eeg_audio_tpu_torch.ops import signal as S

    sos, zi = S.design_butter_band_bank(250, 4)
    edge = S.sos_edge(sos)
    nb, n_sec = sos.shape[:2]
    T = eeg64.shape[-1]
    launches0 = IC.sosfiltfilt_bank_cuda.launches
    gen = torch.Generator(device=dev).manual_seed(11)

    def walk(shape):                     # random walk + noise, made on the card
        return (torch.cumsum(torch.randn(shape, generator=gen, device=dev), -1)
                + torch.randn(shape, generator=gen, device=dev))

    x = walk((2, 47, T))
    n = torch.full((2, 47), T, dtype=torch.int64, device=dev)
    n[1] = 4100
    n[1, 46] = edge - 7                                   # n ≤ edge
    x = torch.where(torch.arange(T, device=dev) < n[..., None], x, 0.0).contiguous()

    def compare(xx, nn):
        T_ = xx.shape[-1]
        before = IC.sosfiltfilt_bank_cuda.launches
        got = IC.sosfiltfilt_bank_cuda(xx, nn, sos, zi, edge)
        one_launch = IC.sosfiltfilt_bank_cuda.launches == before + 1
        ref, plain_ms = wall_ms(lambda: S.bandpass_bank_iir_plain(xx, nn, sos, zi))
        err = (got - ref).abs().amax(dim=tuple(i for i in range(got.dim()) if i != got.dim() - 2))
        scale = ref.abs().amax(dim=tuple(i for i in range(ref.dim()) if i != ref.dim() - 2))
        rel = (err / scale.clamp(min=1e-30)).max().item()
        beyond = torch.arange(T_, device=dev) >= nn[..., None, None]
        zeros = bool((got.masked_select(beyond.expand(got.shape)) == 0).all())
        del ref
        IC.sosfiltfilt_bank_cuda(xx, nn, sos, zi, edge)          # warm
        ms = cuda_ms(lambda: IC.sosfiltfilt_bank_cuda(xx, nn, sos, zi, edge), reps=5)
        plan = IC.kernel_plan(int(xx[..., 0].numel()), nb, T_, edge, n_sec)
        return got, dict(max_abs_err=err.max().item(), max_rel_err=rel,
                         zeros_beyond_n=zeros, one_launch=one_launch, ms=ms,
                         plain_ms=plain_ms, chains=plan["chains"], T=T_,
                         plan={k: plan[k] for k in ("threads", "chunk", "shared_bytes",
                                                    "blocks_per_sm", "staging",
                                                    "scratch_bytes")},
                         library=IC.check_layout(
                             cuda_build.load(IC.SRC, IC.SIGNATURES), n_sec, plan["threads"],
                             plan["shared_bytes"], plan["staging"] == "device"),
                         **iir_bound(nn.expand(xx.shape[:-1]), T_, nb, n_sec,
                                     edge, clock_hz))

    got2, ragged = compare(x, n)
    # scipy float64 sosfiltfilt on a few series longer than edge
    xs, ns = x.double().cpu().numpy(), n.cpu().numpy()
    got2 = got2.double().cpu().numpy()
    sci = 0.0
    for r, c in ((0, 0), (0, 23), (1, 5), (1, 45)):
        for b in range(nb):
            ref = sps.sosfiltfilt(sos[b], xs[r, c, :ns[r, c]])
            sci = max(sci, float(np.abs(got2[r, c, b, :ns[r, c]] - ref).max()
                                 / np.abs(ref).max()))
    ragged["scipy_max_rel_err"] = sci
    n64 = torch.as_tensor(n64, device=dev).long()[:, None]
    _, main = compare(eeg64[:B_REC].contiguous(), n64[:B_REC])
    _, main64 = compare(eeg64.contiguous(), n64)
    # one series (5 chains) at the main path's length: the time of a lone
    # chain, against which the batch's time reads as latency
    one = eeg64[:1, :1].contiguous()
    IC.sosfiltfilt_bank_cuda(one, n64[:1], sos, zi, edge)
    main["one_series_ms"] = cuda_ms(
        lambda: IC.sosfiltfilt_bank_cuda(one, n64[:1], sos, zi, edge), reps=5)
    xl = walk((1, 40_000))
    nl = torch.tensor([39_000], device=dev)
    xl[:, 39_000:] = 0.0
    _, long = compare(xl, nl)
    IC.sosfiltfilt_bank_cuda.launches = launches0
    return dict(edge=edge, ragged=ragged, main=main, main64=main64, long=long)


def fir_vs_iir(x_fir, x_iir):
    """tests/test_fir_parity.py's gates on the runner's X: correlation over
    every feature, and each band's mean total persistence (H0 and H1) within
    0.08 relative in delta and 0.02 in the other bands."""
    import numpy as np

    from tda_eeg_audio_tpu_torch.models.classify import feature_names_220

    names = feature_names_220()
    r = float(np.corrcoef(x_fir.ravel(), x_iir.ravel())[0, 1])
    rel = {}
    for band in BANDS:
        for dim in ("h0", "h1"):
            col = names.index(f"{band}_{dim}_total_persistence_mean")
            a, b = float(x_fir[:, col].mean()), float(x_iir[:, col].mean())
            rel[f"{band}_{dim}"] = abs(a - b) / (abs(b) + 1e-9)
    ok = r > 0.995 and all(v < (0.08 if k.startswith("delta") else 0.02)
                           for k, v in rel.items())
    return dict(r=r, total_persistence_rel=rel, ok=ok)


def stats_deltas():
    """The (18, 5) subject deltas of phase 11's sharded statistics step, from
    a seed (one band with no effect, four with growing ones); the CPU tests
    of the step (tests/torch_distributed_worker.py) import them from here."""
    import numpy as np

    rng = np.random.default_rng(5)
    return (rng.standard_normal((18, 5)) * 0.1
            + np.array([0.0, 0.01, 0.03, 0.06, 0.1])).astype(np.float32)


def rank_worker(argv) -> int:
    """One rank of phase 11: `cli.main(argv)` (the command line's entry
    point), then `sharded_stats_step` over the same process group on this
    rank's rows of `stats_deltas()`; prints one JSON line last."""
    from tda_eeg_audio_tpu_torch import cli
    from tda_eeg_audio_tpu_torch.parallel.sharding import sharded_stats_step
    from tda_eeg_audio_tpu_torch.runtime import process_rank_world, process_shard

    rc = cli.main(argv)
    rank, world = process_rank_world()
    d = stats_deltas()
    lo, hi = process_shard(len(d))
    res = sharded_stats_step(device="cuda")(d[lo:hi])
    print(json.dumps(dict(rc=rc, rank=rank, world=world, rows=[lo, hi],
                          stats=res.cpu().tolist())), flush=True)
    return rc


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env() -> dict:
    """Phase 11's ranks' environment: gloo pinned to the loopback interface,
    where the ranks meet (127.0.0.1), instead of the one the host name
    resolves to."""
    return dict(os.environ, GLOO_SOCKET_IFNAME="lo")


def distributed_phase(timeout_s: float = 300.0):
    """Phase 11: two ranks of `features` on the card over gloo, partials +
    merge against one single-process run, and the sharded statistics step
    in the same ranks against this process's.  Returns (report, problems)."""
    import numpy as np
    import torch

    from tda_eeg_audio_tpu_torch import cli
    from tda_eeg_audio_tpu_torch.ops.stats import bh_fdr, wilcoxon

    problems, report = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        td = Path(tmp)
        data = td / "data"
        index = write_mat_dataset(data)
        common = ["features", "--data", str(data), "--batch", "4"]
        port = free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--phase11-rank",
             *common, "--results", str(td / "part"), "--coordinator",
             f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(i)],
            env=rank_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
            for i in range(2)]
        outs = []
        try:
            for proc in procs:
                out, err = proc.communicate(timeout=timeout_s)
                outs.append((proc.returncode, out, err))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        report["ranks_seconds"] = time.perf_counter() - t0
        ranks = []
        for i, (rc, out, err) in enumerate(outs):
            lines = out.strip().splitlines()
            if rc != 0 or not lines:
                problems.append(f"rank {i}: rc {rc}: {err[-2000:]}")
                continue
            ranks.append(json.loads(lines[-1]))
            report[f"rank_{i}_said"] = [ln for ln in lines[:-1]
                                        if ln.startswith(("distributed", "process shard",
                                                          "partial"))]
        if problems:
            return report, problems
        with contextlib.redirect_stdout(io.StringIO()):
            merge_rc = cli.main(["features", "--results", str(td / "part"),
                                 "--merge-partials"])
            t1 = time.perf_counter()
            one_rc = cli.main([*common, "--results", str(td / "one")])
            report["one_process_seconds"] = time.perf_counter() - t1
        if merge_rc or one_rc:
            problems.append(f"merge rc {merge_rc}, one-shot rc {one_rc}")
        for f in ("X.npy", "y.npy", "subjects.npy"):
            a = np.load(td / "part" / f, allow_pickle=True)
            b = np.load(td / "one" / f, allow_pickle=True)
            if a.shape != b.shape or not np.array_equal(a, b):
                problems.append(f"{f}: partials + merge differ from one process")
        report["rows"] = int(np.load(td / "one" / "X.npy").shape[0])
        if report["rows"] != len(index):
            problems.append(f"{report['rows']} rows for {len(index)} recordings")
        parts = sorted(q.name for q in (td / "part" / "partials").iterdir())
        report["partials"] = parts
        if parts != ["batch_0_4.npz", "batch_4_8.npz"]:
            problems.append(f"partials {parts}")
    # the sharded statistics in the two ranks against this process's
    d = torch.as_tensor(stats_deltas(), device="cuda").T
    _, p = wilcoxon(d, torch.ones_like(d, dtype=torch.bool))
    _, p_adj = bh_fdr(p[None, :], 0.05)
    want = torch.stack([p, p_adj[0]], dim=-1).cpu().tolist()
    report["stats"] = want
    report["ranks"] = [dict(rank=r["rank"], world=r["world"], rows=r["rows"])
                       for r in ranks]
    if [r["stats"] for r in ranks] != [want, want]:
        problems.append(f"sharded stats {[r['stats'] for r in ranks]} != {want}")
    if sorted(r["rank"] for r in ranks) != [0, 1] or any(r["world"] != 2 for r in ranks):
        problems.append(f"ranks {report['ranks']}")
    return report, problems


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    import numpy as np

    from tda_eeg_audio_tpu_torch.config import DEFAULT_CONFIG
    from tda_eeg_audio_tpu_torch.io.synthetic import SynthDataset, load_batch
    from tda_eeg_audio_tpu_torch.ops import cuda_build
    from tda_eeg_audio_tpu_torch.ops import homology_cuda as HC
    from tda_eeg_audio_tpu_torch.ops import iir_cuda as IC
    from tda_eeg_audio_tpu_torch.models import programs as P
    from tda_eeg_audio_tpu_torch.models import study as study_mod
    from tda_eeg_audio_tpu_torch.ops import phase1_cuda as P1
    from tda_eeg_audio_tpu_torch.ops import sinkhorn_log_cuda as SL
    from tda_eeg_audio_tpu_torch.ops import wasserstein_cuda as WC
    from tda_eeg_audio_tpu_torch.ops import wasserstein_h0_cuda as WH
    from tda_eeg_audio_tpu_torch.ops import window_distance_cuda as WD
    from tda_eeg_audio_tpu_torch.ops import window_sample_cuda as WS
    from tda_eeg_audio_tpu_torch.runtime import timed_spans

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # ── phase 2: build every kernel, one nvcc each, side by side ──
    t0 = time.perf_counter()
    libs = [(HC, ()), (HC, HC.PROFILE_FLAGS), (P1, ()), (P1, P1.PROFILE_FLAGS),
            (IC, ()), (WC, ()), (WC, WC.PROFILE_FLAGS), (SL, ()), (WH, ()), (WS, ()),
            (WD, ())]
    _, nvcc_s = cuda_build.build_libraries([(m.SRC, f) for m, f in libs], verbose=True)
    for m, flags in libs:
        cuda_build.load(m.SRC, m.SIGNATURES, flags)
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{nvcc_s if nvcc_s is not None else 'cached'})", flush=True)

    cfg = DEFAULT_CONFIG
    # 8 subjects × {slow, fast} utterance 1: 16 recordings; each one's
    # mismatch audio is its subject's other-condition recording
    ds = SynthDataset(n_subjects=8, n_per_subject=1, cfg=cfg)
    t0 = time.perf_counter()
    batch = load_batch(ds, list(range(B_REC)), K_FEAT, cfg)
    perm = np.arange(B_REC) ^ 1
    mis = dict(audio=batch["audio"][perm], n_a=batch["n_a"][perm])
    print(f"data: {B_REC} recordings staged in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # ── phase 3: kernel vs plain on the card ──
    d47, d124, npts = stage_inputs(batch, cfg, dev)
    dm24, npts24 = ragged_clouds(dev)
    checks = {}
    for name, (dm, np_, n, na, budget) in {
            "n47": (d47, None, 47, 128, 8192),
            "n124": (d124, npts, 124, 96, 8192),
            "ragged": (dm24, npts24, 24, 64, 32)}.items():
        r = check_kernel(dm, np_, n, na, budget)
        checks[name] = r
        ph = r["phases"]
        print(f"kernel vs plain {name} (n={n}): {r['windows']} windows in "
              f"{r['launches']} launch(es) of {r['plan']['grid']} blocks x "
              f"{r['plan']['threads']} threads, arena "
              f"{r['plan']['arena_bytes'] / 2**20:.0f} MiB, "
              f"mismatched={r['mismatched']}, "
              f"max_abs_err={r['max_abs_err']}, kernel {r['ms']:.3f} ms "
              f"({r['ms'] / r['windows'] * 1e3:.2f} us/window), plain "
              f"{r['plain_ms']:.1f} ms, bound bytes {r['t_bytes']:.4f} ms / "
              f"operations {r['t_ops']:.4f} ms ({r['word_ops']:.0f} word ops), "
              f"steps/window mean {r['steps_mean']:.1f} max {r['steps_max']}, "
              f"{ph['step_us']:.3f} us/step, longest-chain floor "
              f"{ph['longest_chain_floor_ms']:.3f} ms, overflow {r['overflow']}, "
              f"windows without creators {r['no_creator']}", flush=True)
        if r["mismatched"]:
            print(f"FAIL: kernel and plain disagree at {name} (n={n}) on "
                  f"{r['mismatched']}", file=sys.stderr)
            return 1
    rag = checks["ragged"]
    if not (rag["plan"]["grid"] < rag["windows"] and rag["no_creator"] > 0
            and 0 < rag["overflow"] < rag["windows"]):
        print("FAIL: the ragged case does not cover slot reuse, windows "
              "without creators and a mix of finished and overflowed windows",
              file=sys.stderr)
        return 1
    print("kernel phases (share of thread 0's clock ticks, instrumented build): "
          + json.dumps({k: dict(
              share={p: round(v, 4) for p, v in checks[k]["phases"]["share"].items()},
              step_us=checks[k]["phases"]["step_us"],
              busy_share_of_sms=checks[k]["phases"]["busy_share_of_sms"],
              words=checks[k]["phases"]["words"]) for k in ("n47", "n124")}),
          flush=True)

    # ── phase 3b: the phase-1 kernel vs the plain phase 1 on the card ──
    p1 = {}
    for name, (dm, np_, n, na) in {
            "n47": (d47, None, 47, 128),
            "n124": (d124, npts, 124, 96),
            "ragged": (dm24, npts24, 24, 64),
            "tied": (grid_clouds(dev), None, 18, 64),
            "nan": (nan_windows(d47), None, 47, 128),
            "signed_zero": (signed_zero_windows(d47), None, 47, 128)}.items():
        r = phase1_check(dm, np_, n, na, against_cpu=name == "signed_zero")
        p1[name] = r
        print(f"h1_phase1 vs plain {name} (n={n}, plain on the {r['against']}): "
              f"{r['windows']} windows in {r['launches_per_call']} launch(es), "
              f"mismatched={r['mismatched']}, max_abs_err={r['max_abs_err']}, "
              f"launcher {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, peak "
              f"{r['peak_bytes'] / 1e6:.1f} MB (plain {r['plain_peak_bytes'] / 1e6:.1f}"
              f" MB), bound bytes {r['t_bytes']:.4f} ms / operations "
              f"{r['t_ops']:.4f} ms ({r['compares']} sieve compares), block "
              f"{r['threads']} threads {r['smem_bytes']} B, {r['blocks_per_sm']} "
              f"blocks/SM, SMs busy {r['phases']['sm_busy']:.3f}, m_cx mean "
              f"{r['m_cx_mean']:.1f}, creators mean {r['creators_mean']:.2f}, NaN "
              f"windows {r['nan_windows']}, -0.0 / +0.0 edges "
              f"{r['signed_zero_edges']}; the kernel's edge order is the card's "
              + "; ".join(f"{route} in {a['windows']} of {a['of']} windows "
                          f"({a['nan_windows']} of {a['of_nan']} with NaN, "
                          f"{a['neg_nan_windows']} of {a['of_neg_nan']} with -NaN)"
                          for route, a in (("plain _phase1", r['card_sort_agrees']['plain']),
                                           ("torch.sort(stable=True)",
                                            r['card_sort_agrees']['torch_sort'])))
              + ("" if r["card_plain_matches_cpu"] is None else
                 f", the card's plain _phase1 equals the CPU's: "
                 f"{r['card_plain_matches_cpu']}"), flush=True)
    print("h1_phase1 phases (share of thread 0's clock ticks, instrumented build): "
          + json.dumps({k: dict(
              share={p: round(v, 4) for p, v in p1[k]["phases"]["share"].items()},
              window_us_mean=p1[k]["phases"]["window_us_mean"],
              forest_rounds_mean=p1[k]["phases"]["forest_rounds_mean"],
              sm_busy=p1[k]["phases"]["sm_busy"],
              slot_busy=p1[k]["phases"]["slot_busy"],
              blocks_per_sm=p1[k]["blocks_per_sm"]) for k in ("n47", "n124")}),
          flush=True)
    bad_p1 = [k for k, r in p1.items() if r["mismatched"] or r["launches_per_call"] != 1]
    if bad_p1 or p1["nan"]["nan_windows"] == 0 \
            or min(p1["signed_zero"]["signed_zero_edges"]) == 0:
        print(f"FAIL: h1_phase1 kernel vs plain phase 1: "
              f"{ {k: (p1[k]['mismatched'], p1[k]['launches_per_call']) for k in bad_p1} }",
              file=sys.stderr)
        return 1

    # ── phase 4: the main path, its comparison stage's parts timed ──
    # warm-up (cuFFT plans etc.), keeping the pairs the comparison hands to
    # the tiered Sinkhorn for phase 4b
    # and its exact H0 DP for phase 13
    _, (sk_calls, h0_calls) = capture_calls(
        lambda: main_path(batch, mis, cfg, dev), (P, "_wass_sinkhorn_tiered"),
        (P, "wasserstein_h0_exact"))
    sk_pairs, h0_main = sk_calls[-1], h0_calls[-1]
    HC.h1_diagrams_cuda.launches = 0
    P1.phase1_cuda.launches = 0
    WC.sinkhorn_tiered_cuda.launches = 0
    WH.wasserstein_h0_cuda.launches = 0
    SL.sinkhorn_log_cuda.launches = 0
    with timed_spans() as parts:
        res = main_path(batch, mis, cfg, dev)
    total = HC.h1_diagrams_cuda.launches
    p1_total = P1.phase1_cuda.launches
    sk_total = WC.sinkhorn_tiered_cuda.launches
    h0_total = WH.wasserstein_h0_cuda.launches
    sl_total = SL.sinkhorn_log_cuda.launches
    launches = res["launches"]
    p1_launches = res["phase1_launches"]
    sk_launches = res["sinkhorn_launches"]
    h0_launches = res["h0_launches"]
    out, mo = res["out"], res["mo"]
    expect = dict(agg=(B_REC, 5, 2, 11, 2), diag=(B_REC, 5, 8), ovf=(B_REC,))
    problems = [f"{k} shape {tuple(res[k].shape)}" for k, s in expect.items()
                if tuple(res[k].shape) != s]
    for k, s in dict(w_h0=(B_REC, 5), w_h1=(B_REC, 5), w_h1_mis=(B_REC, 5),
                     corr_r=(B_REC, 5, 5), corr_p=(B_REC, 5, 5), tau=(B_REC, 5),
                     n_pair=(B_REC,), a_degen=(B_REC, 5),
                     overflow=(B_REC,)).items():
        if tuple(out[k].shape) != s:
            problems.append(f"{k} shape {tuple(out[k].shape)}")
        if out[k].is_floating_point() and not bool(torch.isfinite(out[k]).all()):
            problems.append(f"{k} not finite")
    if not bool(torch.isfinite(res["agg"]).all()):
        problems.append("agg not finite")
    # features runs the kernel at n = 47 only, mismatch audio at n = 124 only
    if total <= 0 or min(launches.values()) <= 0:
        problems.append(f"kernel launches by stage {launches}")
    # each h1_diagrams_cuda chunk: one phase-1 launch, one reduction launch
    if p1_launches != launches or p1_total != total:
        problems.append(f"h1_phase1 launches by stage {p1_launches}, "
                        f"h1_reduce {launches}")
    # one tiered Sinkhorn call per batch, in the comparison stage only
    if sk_launches["comparison"] <= 0 or sk_total != sk_launches["comparison"]:
        problems.append(f"sinkhorn_tiered launches by stage {sk_launches}")
    # one exact H0 DP launch per batch, in the comparison stage only
    if h0_launches["comparison"] != 1 or h0_total != 1:
        problems.append(f"wasserstein_h0 launches by stage {h0_launches}")
    ms = res["ms"]
    n_feat_win = B_REC * 5 * K_FEAT
    n_cmp_win = B_REC * 5 * K_CMP
    print(f"main path (B={B_REC}): features {ms['features']:.1f} ms "
          f"({n_feat_win / ms['features'] * 1e3:.0f} windows/s), mismatch audio "
          f"{ms['mismatch_audio']:.1f} ms ({n_cmp_win / ms['mismatch_audio'] * 1e3:.0f}"
          f" windows/s), comparison {ms['comparison']:.1f} ms "
          f"({2 * n_cmp_win / ms['comparison'] * 1e3:.0f} windows/s); total "
          f"{sum(ms.values()):.1f} ms", flush=True)
    print(f"overflow: features {int(res['ovf'].sum())}/{B_REC} recordings, "
          f"mismatch audio {int(mo['overflow'].sum())}/{n_cmp_win} windows, "
          f"comparison {int(out['overflow'].sum())}/{B_REC} recordings "
          f"(flags of the entry points; the runner redoes them, phase 6)",
          flush=True)
    print(f"kernel launches on the main path: h1_reduce {total} (by stage "
          f"{launches}), h1_phase1 {p1_total} (by stage {p1_launches}), "
          f"sinkhorn_tiered {sk_total} per batch (by stage {sk_launches}), "
          f"wasserstein_h0 {h0_total} per batch (by stage {h0_launches}), "
          f"sinkhorn_log {sl_total} (the entry points redo no overflow; the "
          f"runner does, phase 6)", flush=True)
    print("comparison parts (wall ms, timed spans): " + json.dumps(
        {k: round(v, 2) for k, v in parts.items()}), flush=True)
    print("w_h1 band means: " + json.dumps(
        [round(float(x), 5) for x in out["w_h1"].mean(0)]), flush=True)
    if problems:
        print(f"FAIL: main path: {problems}", file=sys.stderr)
        return 1

    # ── phase 4b: the tiered Sinkhorn kernel vs plain on the card ──
    clock_hz = max_sm_clock_hz()
    sk = sinkhorn_kernel_check(sk_pairs, dev, clock_hz)
    for name in ("main", "classes"):
        r = sk[name]
        print(f"sinkhorn_tiered vs plain {name} ({r['pairs']} pairs; by kernel "
              f"width {r['kernel_widths']}, by the plain version's chunk width "
              f"{r['plain_widths']}): {r['launches_per_call']} launches a call, "
              f"max_rel_err {r['max_rel_err']:.3e} (a reading), max_abs_err "
              f"{r['max_abs_err']:.3e}; within rtol {SINKHORN_RTOL} on the "
              f"{r['held_to_plain']} pairs where the plain version lies within "
              f"{SINKHORN_PLAIN_NEAR_F64} of float64: {r['within']}, "
              f"finite {r['finite']}, zeros exact {r['zeros_exact']}, kernel "
              f"{r['ms']:.4f} ms (by width class alone "
              f"{ {w: round(t, 4) for w, t in r['ms_by_width'].items()} }), plain "
              f"{r['plain_ms']:.1f} ms, bound at the pairs' own widths: bytes "
              f"{r['t_bytes']:.4f} ms / operations {r['t_ops']:.4f} ms (FP32 "
              f"{r['t_fp32']:.4f}, expf {r['t_sfu']:.4f}); operations at the "
              f"plain version's chunk widths {r['t_ops_at_plain_widths']:.4f} ms "
              f"(a reading)", flush=True)
        print(f"sinkhorn_tiered vs a float64 ladder {name} (largest relative "
              f"difference; kernel_vs_float64 gated at rtol {SINKHORN_F64_RTOL}, "
              f"within {r['within_float64']}): " + json.dumps(r["rounding"]), flush=True)
    print(f"sinkhorn_tiered under set_sync_debug_mode('error'): no host "
          f"synchronisation ({sk['no_host_sync']})", flush=True)
    print("sinkhorn_tiered layout by width class, as the library reports it "
          "(blocks/SM by design; occupancy = what the card's calculator allows): "
          + json.dumps(sk["layout"]), flush=True)
    print("sinkhorn phases (share of the pair group's thread 0 clock ticks per "
          "part, instrumented build; pair_us, SMs busy per class launch): "
          + json.dumps({k: dict(sk[k]["phases"],
                                instrumented_max_abs_diff=sk[k]["instrumented_max_abs_diff"])
                        for k in ("main", "classes")}), flush=True)
    # each call: one bucketing launch, then one launch per width class
    bad_sk = [k for k in ("main", "classes") if not (
        sk[k]["within"] and sk[k]["within_float64"] and sk[k]["finite"]
        and sk[k]["zeros_exact"] and 2 * sk[k]["held_to_plain"] >= sk[k]["pairs"]
        and sk[k]["launches_per_call"] == WC.launches_per_call(WC.MAX_WIDTH))]
    if bad_sk or sk["main"]["pairs"] != 2 * B_REC * 5 * K_CMP \
            or len(sk["classes"]["kernel_widths"]) != len(WC.WIDTHS):
        print(f"FAIL: sinkhorn_tiered kernel vs plain: {bad_sk}, pairs "
              f"{sk['main']['pairs']}, classes {sk['classes']['kernel_widths']}",
              file=sys.stderr)
        return 1

    # ── phase 5: small batch, card vs CPU ──
    bad, ratio, dist_err = small_reference_check(dev)
    print(f"small batch card vs CPU: mismatched={bad}, largest error / "
          f"tolerance {json.dumps({k: round(v, 3) for k, v in ratio.items()})}, "
          f"distances differ by {dist_err:.3g}", flush=True)
    if bad:
        print(f"FAIL: card and CPU runs disagree on {bad}", file=sys.stderr)
        return 1

    # ── phase 6: the study runner, full width ──
    from tda_eeg_audio_tpu_torch.io.device_store import build_synthetic_device

    store, ingest_ms = wall_ms(lambda: build_synthetic_device(
        n_subjects=6, n_per_subject=8, device=dev))
    store_gb = (store.eeg.numel() + store.audio.numel()) * 4 / 1e9
    # one recording's audio loses one window step (62 samples at 250 Hz), so
    # its two sides count different windows and the control's exact per-side
    # pairing runs on the card whatever the generated durations
    cut = 10_937
    store.audio[0, store.ns_a[0] - cut:store.ns_a[0]] = 0.0
    store.ns_a[0] -= cut
    # the control stage's parts timed by its spans; the pairs its exact
    # redo hands the un-tiered Sinkhorn and the comparison's exact-H0 pairs
    # kept for phase 13
    (report, problems, x_fir, rows_fir), (wass_calls, h0_batches) = capture_calls(
        lambda: runner_phase(store, cfg, control_spans=True),
        (study_mod, "sinkhorn_cost_pairs"), (P, "wasserstein_h0_exact"))
    runner_launches = report["launches_total"]
    print(f"runner ({report['recordings']} recordings, store {store_gb:.2f} GB "
          f"generated on the card in {ingest_ms / 1e3:.1f} s): "
          + json.dumps(report), flush=True)
    print(f"control stage (96 recordings, spans on): {report['seconds']['control']:.4f} s, "
          f"{report['control_deviants_redone']} deviants redone in "
          f"{len(wass_calls)} un-tiered Sinkhorn call(s) of "
          f"{[int(c[0].shape[0]) for c in wass_calls]} pairs; spans (ms): "
          + json.dumps({k: round(v, 3) for k, v in report["control_spans_ms"].items()}),
          flush=True)
    if not wass_calls:
        problems.append("the control's exact redo handed no pairs to the un-tiered Sinkhorn")
    if problems:
        print(f"FAIL: runner: {problems}", file=sys.stderr)
        return 1
    ctl_pairs = tuple(torch.cat([c[k] for c in wass_calls]) for k in range(6))
    # four comparison batches' exact-H0 pairs: the 4,800 of one batch of 64
    # recordings, for phase 13
    h0_batch64 = tuple(torch.cat([c[k] for c in h0_batches[:4]]) for k in range(4))

    # ── phase 7: bank path against in-call path on the card ──
    bad, ratio = bank_vs_in_call(store, cfg)
    print(f"bank vs in-call path on the card: mismatched={bad}, largest error / "
          f"tolerance {json.dumps({k: round(v, 3) for k, v in ratio.items()})}",
          flush=True)
    if bad:
        print(f"FAIL: bank and in-call paths disagree on {bad}", file=sys.stderr)
        return 1

    # ── phase 8: exact redo of overflowed windows on the card ──
    redo = overflow_redo_check(d47, cfg.max_edge_length)
    print("overflow redo (n=47): " + json.dumps(redo), flush=True)
    if redo.get("problem") or redo["mismatched"] or redo["redone"] <= 0 \
            or redo["counted"] != redo["redone"]:
        print(f"FAIL: overflow redo: {redo}", file=sys.stderr)
        return 1

    # ── phase 9: the command line on the card ──
    cli_report, exact_vs_sinkhorn, x_ratio, problems = cli_phase()
    cli_launches = sum(r["launches"] for r in cli_report.values())
    print("cli (seconds, kernel launches, windows redone per command): "
          + json.dumps({k: dict(seconds=round(r["seconds"], 3),
                                launches=r["launches"],
                                phase1_launches=r["phase1_launches"],
                                sinkhorn_launches=r["sinkhorn_launches"],
                                sinkhorn_log_launches=r["sinkhorn_log_launches"],
                                h0_launches=r["h0_launches"],
                                windows_redone=r["windows_redone"])
                        for k, r in cli_report.items()}), flush=True)
    print("cli said: " + json.dumps({k: r["said"] for k, r in cli_report.items()}),
          flush=True)
    print(f"cli features --backend host vs kernel: largest error / tolerance "
          f"{x_ratio:.4g} (rtol 1e-4, atol 1e-5)", flush=True)
    print("cli wasserstein_h1 exact vs Sinkhorn, relative difference by band "
          "(a reading): " + json.dumps(exact_vs_sinkhorn), flush=True)
    if problems:
        print(f"FAIL: cli: {problems}", file=sys.stderr)
        return 1

    # ── phase 10: the exact IIR bank, kernel vs plain, then the runner ──
    iir = iir_kernel_check(dev, store.eeg[:64], store.ns_e[:64], clock_hz)
    for shape in IIR_SHAPES:
        r = iir[shape]
        print(f"sosfiltfilt vs plain {shape} ({r['chains']} chains, "
              f"T {r['T']}, edge {iir['edge']}): "
              f"max_abs_err {r['max_abs_err']:.3g}, max_rel_err (of each band's "
              f"max|ref|) {r['max_rel_err']:.3g}, zeros beyond n "
              f"{r['zeros_beyond_n']}, one launch {r['one_launch']}, kernel "
              f"{r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.1f} ms, bound bytes {r['t_bytes']:.4f} ms / "
              f"operations {r['t_ops']:.4f} ms, chain floor estimate "
              f"{r['chain_estimate_ms']:.4f} ms (assumed {FP64_FMA_CYCLES} cycles "
              f"per dependent FP64 FMA at the max SM clock, not measured), "
              f"plan {json.dumps(r['plan'])}, library {json.dumps(r['library'])}"
              + (f", scipy max_rel_err {r['scipy_max_rel_err']:.3g}"
                 if "scipy_max_rel_err" in r else "")
              + (f", one series (5 chains) {r['one_series_ms']:.4f} ms"
                 if "one_series_ms" in r else ""), flush=True)
    bad_iir = [k for k in IIR_SHAPES if iir[k]["max_rel_err"] > 1e-6
               or not iir[k]["zeros_beyond_n"] or not iir[k]["one_launch"]]
    if iir["main"]["plan"]["scratch_bytes"] or iir["long"]["plan"]["staging"] != "device":
        bad_iir.append("plan")
    if bad_iir or iir["ragged"]["scipy_max_rel_err"] > 1e-5:
        print(f"FAIL: sosfiltfilt kernel vs plain / scipy: {bad_iir}, scipy "
              f"{iir['ragged']['scipy_max_rel_err']}", file=sys.stderr)
        return 1
    cfg_iir = dataclasses.replace(cfg, filter_impl="iir_scan")
    iir_report, problems, x_iir, _ = runner_phase(store, cfg_iir)
    print("runner iir_scan: " + json.dumps(iir_report), flush=True)
    parity = fir_vs_iir(x_fir, x_iir)
    print("FIR vs IIR X (tests/test_fir_parity.py gates: r > 0.995, mean total "
          "persistence within 0.08 delta / 0.02 other bands): "
          + json.dumps(parity), flush=True)
    if problems or not parity["ok"]:
        print(f"FAIL: iir_scan runner: {problems}, parity ok {parity['ok']}",
              file=sys.stderr)
        return 1

    # ── phase 11: two processes on the card ──
    dist_report, problems = distributed_phase()
    print("two processes: " + json.dumps(dist_report), flush=True)
    if problems:
        print(f"FAIL: two processes: {problems}", file=sys.stderr)
        return 1

    # ── phase 12: the knobs, the EEG feature pass in windows/s, and the
    # runner at the tuned knobs against the defaults ──
    from tda_eeg_audio_tpu_torch import tuning

    print("knobs in force (tuning.py): " + json.dumps(
        {k: dict(value=v, source=tuning.SOURCE[k]) for k, v in tuning.KNOBS.items()}),
        flush=True)
    HC.h1_diagrams_cuda.launches = 0
    P1.phase1_cuda.launches = 0
    thr_line, thr_cpu, problems = throughput_phase(dev)
    thr_launches = HC.h1_diagrams_cuda.launches
    thr_p1_launches = P1.phase1_cuda.launches
    print("eeg throughput: " + json.dumps(thr_line), flush=True)
    print("eeg throughput, first 2 recordings card vs CPU (agg rtol 1e-4, "
          "atol 1e-5; overflow flags equal): " + json.dumps(thr_cpu), flush=True)
    if problems:
        print(f"FAIL: eeg throughput: {problems}", file=sys.stderr)
        return 1
    knob_reports = None
    if tuning.KNOBS != tuning._DEFAULTS:
        readout, knob_reports, problems = knobs_vs_defaults(store, cfg, tuning.KNOBS)
        print("runner at the tuned knobs vs the defaults: " + json.dumps(readout),
              flush=True)
        if problems:
            print(f"FAIL: tuned knobs vs defaults: {problems}", file=sys.stderr)
            return 1
    else:
        print("runner at the tuned knobs vs the defaults: not run, tuning.json "
              "holds the defaults", flush=True)

    # ── phase 13: the un-tiered Sinkhorn and the exact H0 DP vs plain ──
    seeded = sinkhorn_log_seeded_pairs(dev)
    sl = sinkhorn_log_check({"control": ctl_pairs, "seeded": seeded,
                             "masked_nan": masked_nan_births(seeded)}, clock_hz,
                            same_bits=[("masked_nan", "seeded")])
    for name in SINKHORN_LOG_SETS:
        r = sl[name]
        print(f"sinkhorn_log vs plain {name} ({r['pairs']} pairs, S mean "
              f"{r['S_mean']:.1f} max {r['S_max']} at the pairs' own width, pad "
              f"{r['S_pad']}; pairs by lanes a line {json.dumps(r['pairs_by_lanes'])}, "
              f"costs from the table {r['table_pairs']}): {r['launches_per_call']} "
              f"launch(es) a call, "
              f"max_rel_err {r['max_rel_err']:.3e} (rtol {SINKHORN_LOG_RTOL}, margin "
              f"{SINKHORN_LOG_RTOL - r['max_rel_err']:.3e}, within {r['within']}; the "
              f"plain version's own distance from float64 {r['plain_vs_float64']:.3e}), "
              f"vs float64 {r['max_rel_err_vs_float64']:.3e} (rtol "
              f"{SINKHORN_LOG_F64_RTOL}, within {r['within_float64']}: the gate that "
              f"tells a wrong kernel), pairs with a non-finite bar "
              f"{r['nonfinite_bar_pairs']}, max_abs_err {r['max_abs_err']:.3e}, "
              f"same NaN / inf {r['same_nonfinite']}, kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.1f} ms, peak {r['peak_bytes'] / 1e6:.3f} MB a call "
              f"(plain {r['plain_peak_bytes'] / 1e6:.1f} MB), bound: expf at the "
              f"own width {r['t_ops']:.4f} ms, at the pad width {r['t_ops_pad']:.4f} "
              f"ms, bytes {r['t_bytes']:.5f} ms", flush=True)
    print(f"sinkhorn_log under set_sync_debug_mode('error'): no host "
          f"synchronisation ({sl['no_host_sync']}); layout as the library reports "
          f"it: {json.dumps(sl['layout'])}", flush=True)
    h0 = h0_check({"main": h0_main, "staged": h0_staged_inputs(dev),
                   "batch64": h0_batch64})
    for name in H0_SETS:
        r = h0[name]
        print(f"wasserstein_h0 vs plain {name} ({r['pairs']} pairs at {r['K']}): "
              f"{r['launches_per_call']} launch(es) a call, max_abs_err "
              f"{r['max_abs_err']:.3e} (rtol {H0_RTOL}, within {r['within']}), bit for "
              f"bit vs the plain loop on the CPU {r['bit_for_bit_vs_cpu']}, kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.2f} ms, bound bytes "
              f"{r['t_bytes']:.5f} ms / operations {r['t_ops']:.5f} ms", flush=True)
    print(f"wasserstein_h0 layout as the library reports it: {json.dumps(h0['layout'])}",
          flush=True)
    print(f"sinkhorn_log with a NaN birth in every masked slot: results bit for bit "
          f"those of the seeded set {sl['masked_nan']['same_bits_as_seeded']}", flush=True)
    bad = [k for k in SINKHORN_LOG_SETS if not (
        sl[k]["within"] and sl[k]["within_float64"] and sl[k]["same_nonfinite"]
        and sl[k]["launches_per_call"] == 1)]
    if not sl["masked_nan"]["same_bits_as_seeded"]:
        bad.append("masked_nan: not the seeded set's bits")
    bad += [k for k in H0_SETS if not (
        h0[k]["within"] and h0[k]["finite"] and h0[k]["launches_per_call"] == 1)]
    if bad or h0["main"]["pairs"] != B_REC * 5 * K_CMP \
            or h0["batch64"]["pairs"] != 4 * B_REC * 5 * K_CMP:
        print(f"FAIL: phase 13 kernels vs plain: {bad}", file=sys.stderr)
        return 1

    # ── phase 14: the runner's data-parallel mesh, two shards on this card ──
    mesh_readout, mesh_reports, problems = mesh_phase(store, cfg, x_fir, rows_fir)
    print("runner mesh launches by shard (H1 reduction, H1 phase 1, tiered "
          "Sinkhorn, exact H0): " + json.dumps(
              {k: r["shard_launches"] for k, r in mesh_readout.items()}), flush=True)
    print("runner mesh=[cuda, cuda] vs phase 6's single-device run: "
          + json.dumps(mesh_readout), flush=True)
    if problems:
        print(f"FAIL: runner mesh: {problems}", file=sys.stderr)
        return 1
    del store

    # ── phase 15: the md5 window sample on the study's 7,200 lanes ──
    ws = window_sample_check(dev)
    print(f"window_sample vs NumPy ({ws['lanes']} lanes, nw {ws['nw'][0]}-{ws['nw'][1]}, "
          f"K {ws['K']}, Kx {ws['Kx']}): bit for bit in one launch {ws['bit_for_bit']}, "
          f"in launches of {ws['batch']} {ws['bit_for_bit_batched']}; kernel "
          f"{ws['ms']:.4f} ms for all lanes, {ws['ms_batch']:.4f} ms a batch of "
          f"{ws['batch']}, launch {ws['host_us_batch']:.1f} us on the host; NumPy "
          f"{ws['numpy_ms']:.1f} ms; layout {json.dumps(ws['layout'])}", flush=True)
    if not (ws["bit_for_bit"] and ws["bit_for_bit_batched"]):
        print("FAIL: phase 15 window_sample vs NumPy", file=sys.stderr)
        return 1

    # ── phase 16: the window → correlation-distance kernel ──
    wd = window_distance_check(dev)
    print("window_distance vs plain: " + json.dumps(wd), flush=True)
    wd_bad = [k for k in ("features", "comparison") if not wd[k]["held"]]
    if wd_bad:
        print(f"FAIL: phase 16 window_distance vs plain: {wd_bad}", file=sys.stderr)
        return 1

    # one kernel at the main path's two shapes: the line sums both checks
    r47, r124 = checks["n47"], checks["n124"]
    t_bytes = r47["t_bytes"] + r124["t_bytes"]
    t_ops = r47["t_ops"] + r124["t_ops"]
    kernels = [dict(
        name="h1_reduce", route="cuda",
        source="tda_eeg_audio_tpu_torch/csrc/h1_reduce.cu",
        replaces="tda_eeg_audio_tpu/ops/homology_pallas.py:190",
        launches=total + runner_launches + cli_launches
        + iir_report["launches_total"] + thr_launches
        + sum(r["launches_total"] for r in (knob_reports or {}).values())
        + sum(r["launches_total"] for r in mesh_reports.values()),
        launches_by_path=dict(one_batch=launches, runner=report["launches"],
                              cli={k: r["launches"] for k, r in cli_report.items()},
                              runner_iir_scan=iir_report["launches"],
                              eeg_throughput=thr_launches,
                              runner_knobs={k: r["launches"] for k, r in
                                            (knob_reports or {}).items()},
                              runner_mesh={k: r["launches"] for k, r in
                                           mesh_reports.items()}),
        max_abs_err=max(r47["max_abs_err"], r124["max_abs_err"]),
        ms=r47["ms"] + r124["ms"], plain_ms=r47["plain_ms"] + r124["plain_ms"],
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=None,
        by_n={f"n={r['n']}": dict(
            windows=r["windows"], ms=r["ms"], plain_ms=r["plain_ms"],
            stage=STAGE_OF_N[r["n"]], stage_launches=launches[STAGE_OF_N[r["n"]]],
            longest_chain_floor_ms=r["phases"]["longest_chain_floor_ms"],
            bound_ms=max(r["t_bytes"], r["t_ops"]), word_ops=r["word_ops"],
            steps_mean=r["steps_mean"], steps_max=r["steps_max"])
              for r in (r47, r124)},
        held_against_plain=not (r47["mismatched"] or r124["mismatched"])),
        dict(
        name="h1_phase1", route="cuda",
        source="tda_eeg_audio_tpu_torch/csrc/h1_phase1.cu",
        replaces="tda_eeg_audio_tpu/ops/homology_h1.py:181 _phase1 (XLA, not Pallas)",
        launches=p1_total + report["phase1_launches_total"]
        + sum(r["phase1_launches"] for r in cli_report.values())
        + iir_report["phase1_launches_total"] + thr_p1_launches
        + sum(r["phase1_launches_total"] for r in (knob_reports or {}).values())
        + sum(r["phase1_launches_total"] for r in mesh_reports.values()),
        launches_by_path=dict(
            one_batch=p1_launches, runner=report["phase1_launches"],
            cli={k: r["phase1_launches"] for k, r in cli_report.items()},
            runner_iir_scan=iir_report["phase1_launches"],
            eeg_throughput=thr_p1_launches,
            runner_knobs={k: r["phase1_launches"] for k, r in
                          (knob_reports or {}).items()},
            runner_mesh={k: r["phase1_launches"] for k, r in mesh_reports.items()}),
        max_abs_err=max(r["max_abs_err"] for r in p1.values()),
        # the main path's two shapes, summed: the launcher (one launch)
        # against the plain _phase1, the function the bound counts
        ms=p1["n47"]["ms"] + p1["n124"]["ms"],
        plain_ms=p1["n47"]["plain_ms"] + p1["n124"]["plain_ms"],
        bound_ms=max(p1["n47"]["t_bytes"] + p1["n124"]["t_bytes"],
                     p1["n47"]["t_ops"] + p1["n124"]["t_ops"]),
        bound_by="bytes" if p1["n47"]["t_bytes"] + p1["n124"]["t_bytes"]
        >= p1["n47"]["t_ops"] + p1["n124"]["t_ops"] else "operations",
        library_ms=None,
        phases={k: dict(share=p1[k]["phases"]["share"],
                        sm_busy=p1[k]["phases"]["sm_busy"],
                        blocks_per_sm=p1[k]["blocks_per_sm"])
                for k in ("n47", "n124")},
        by_case={k: dict(n=r["n"], windows=r["windows"], ms=r["ms"],
                         plain_ms=r["plain_ms"], peak_bytes=r["peak_bytes"],
                         plain_peak_bytes=r["plain_peak_bytes"],
                         bound_ms=max(r["t_bytes"], r["t_ops"]),
                         t_bytes=r["t_bytes"], t_ops=r["t_ops"],
                         against=r["against"], card_sort_agrees=r["card_sort_agrees"],
                         mismatched=r["mismatched"])
                 for k, r in p1.items()},
        held_against_plain=not any(r["mismatched"] for r in p1.values())),
        dict(
        name="sosfiltfilt", route="cuda",
        source="tda_eeg_audio_tpu_torch/csrc/sosfiltfilt.cu",
        replaces="tda_eeg_audio_tpu/ops/signal.py:401 _biquad_scan "
                 "(XLA associative scan, not Pallas)",
        launches=iir_report["sosfiltfilt_launches_total"],
        launches_by_path=dict(runner_iir_scan=iir_report["sosfiltfilt_launches"]),
        max_abs_err=max(iir[k]["max_abs_err"] for k in IIR_SHAPES),
        ms=iir["main"]["ms"], ms_64=iir["main64"]["ms"], plain_ms=iir["main"]["plain_ms"],
        bound_ms=max(iir["main"]["t_bytes"], iir["main"]["t_ops"]),
        bound_by="bytes" if iir["main"]["t_bytes"] >= iir["main"]["t_ops"]
        else "operations", library_ms=None,
        by_shape={k: dict(chains=iir[k]["chains"], T=iir[k]["T"], ms=iir[k]["ms"],
                          plain_ms=iir[k]["plain_ms"],
                          bound_ms=max(iir[k]["t_bytes"], iir[k]["t_ops"]),
                          max_rel_err=iir[k]["max_rel_err"], plan=iir[k]["plan"])
                  for k in IIR_SHAPES},
        one_series_ms=iir["main"]["one_series_ms"],
        scipy_max_rel_err=iir["ragged"]["scipy_max_rel_err"],
        held_against_plain=True),
        dict(
        name="sinkhorn_tiered", route="cuda",
        source="tda_eeg_audio_tpu_torch/csrc/sinkhorn_tiered.cu",
        replaces="tda_eeg_audio_tpu/models/programs.py:324 _wass_chunk_tiered / "
                 ":358 _wass_sinkhorn_tiered + tda_eeg_audio_tpu/ops/"
                 "wasserstein.py:134 sinkhorn_cost_stab (XLA, not Pallas)",
        launches=sk_total + report["sinkhorn_launches_total"]
        + sum(r["sinkhorn_launches"] for r in cli_report.values())
        + iir_report["sinkhorn_launches_total"]
        + sum(r["sinkhorn_launches_total"] for r in (knob_reports or {}).values())
        + sum(r["sinkhorn_launches_total"] for r in mesh_reports.values()),
        launches_by_path=dict(
            one_batch=sk_launches, runner=report["sinkhorn_launches"],
            cli={k: r["sinkhorn_launches"] for k, r in cli_report.items()},
            runner_iir_scan=iir_report["sinkhorn_launches"],
            runner_knobs={k: r["sinkhorn_launches"] for k, r in
                          (knob_reports or {}).items()},
            runner_mesh={k: r["sinkhorn_launches"] for k, r in mesh_reports.items()}),
        max_abs_err=max(sk[k]["max_abs_err"] for k in ("main", "classes")),
        max_rel_err=max(sk[k]["max_rel_err"] for k in ("main", "classes")),
        ms=sk["main"]["ms"], plain_ms=sk["main"]["plain_ms"],
        bound_ms=max(sk["main"]["t_bytes"], sk["main"]["t_ops"]),
        bound_by="bytes" if sk["main"]["t_bytes"] >= sk["main"]["t_ops"]
        else "operations", library_ms=None,
        by_set={k: dict(pairs=sk[k]["pairs"], ms=sk[k]["ms"],
                        plain_ms=sk[k]["plain_ms"], ms_by_width=sk[k]["ms_by_width"],
                        bound_ms=max(sk[k]["t_bytes"], sk[k]["t_ops"]),
                        kernel_widths=sk[k]["kernel_widths"],
                        plain_widths=sk[k]["plain_widths"],
                        max_rel_err=sk[k]["max_rel_err"],
                        max_rel_err_vs_float64=sk[k]["rounding"]["kernel_vs_float64"])
                for k in ("main", "classes")},
        layout=sk["layout"], phases=sk["main"]["phases"],
        no_host_sync=sk["no_host_sync"], held_against_plain=True),
        dict(
        name="sinkhorn_log", route="cuda",
        source="tda_eeg_audio_tpu_torch/csrc/sinkhorn_log.cu",
        replaces="tda_eeg_audio_tpu/ops/wasserstein.py:93 sinkhorn_cost (XLA, not Pallas)",
        launches=sl_total + report["sinkhorn_log_launches_total"]
        + sum(r["sinkhorn_log_launches"] for r in cli_report.values())
        + iir_report["sinkhorn_log_launches_total"]
        + sum(r["sinkhorn_log_launches_total"] for r in (knob_reports or {}).values())
        + sum(r["sinkhorn_log_launches_total"] for r in mesh_reports.values()),
        launches_by_path=dict(
            one_batch=sl_total, runner=report["sinkhorn_log_launches"],
            cli={k: r["sinkhorn_log_launches"] for k, r in cli_report.items()},
            runner_iir_scan=iir_report["sinkhorn_log_launches"],
            runner_knobs={k: r["sinkhorn_log_launches"] for k, r in
                          (knob_reports or {}).items()},
            runner_mesh={k: r["sinkhorn_log_launches"] for k, r in mesh_reports.items()}),
        max_abs_err=max(sl[k]["max_abs_err"] for k in SINKHORN_LOG_SETS),
        max_rel_err=max(sl[k]["max_rel_err"] for k in SINKHORN_LOG_SETS),
        ms=sl["control"]["ms"], plain_ms=sl["control"]["plain_ms"],
        bound_ms=max(sl["control"]["t_bytes"], sl["control"]["t_ops"]),
        bound_by="bytes" if sl["control"]["t_bytes"] >= sl["control"]["t_ops"]
        else "operations", library_ms=None,
        by_set={k: dict(pairs=sl[k]["pairs"], ms=sl[k]["ms"], plain_ms=sl[k]["plain_ms"],
                        bound_ms=max(sl[k]["t_bytes"], sl[k]["t_ops"]),
                        bound_ms_at_pad_width=sl[k]["t_ops_pad"],
                        S_mean=sl[k]["S_mean"], S_max=sl[k]["S_max"],
                        peak_bytes=sl[k]["peak_bytes"],
                        plain_peak_bytes=sl[k]["plain_peak_bytes"],
                        max_rel_err=sl[k]["max_rel_err"],
                        max_rel_err_vs_float64=sl[k]["max_rel_err_vs_float64"],
                        plain_vs_float64=sl[k]["plain_vs_float64"],
                        nonfinite_bar_pairs=sl[k]["nonfinite_bar_pairs"])
                for k in SINKHORN_LOG_SETS},
        layout=sl["layout"], no_host_sync=sl["no_host_sync"], held_against_plain=True),
        dict(
        name="wasserstein_h0", route="cuda",
        source="tda_eeg_audio_tpu_torch/csrc/wasserstein_h0.cu",
        replaces="tda_eeg_audio_tpu/ops/wasserstein.py:190 wasserstein_h0_exact "
                 "(XLA, not Pallas)",
        launches=h0_total + report["h0_launches_total"]
        + sum(r["h0_launches"] for r in cli_report.values())
        + iir_report["h0_launches_total"]
        + sum(r["h0_launches_total"] for r in (knob_reports or {}).values())
        + sum(r["h0_launches_total"] for r in mesh_reports.values()),
        launches_by_path=dict(
            one_batch=h0_launches, runner=report["h0_launches"],
            cli={k: r["h0_launches"] for k, r in cli_report.items()},
            runner_iir_scan=iir_report["h0_launches"],
            runner_knobs={k: r["h0_launches"] for k, r in (knob_reports or {}).items()},
            runner_mesh={k: r["h0_launches"] for k, r in mesh_reports.items()}),
        max_abs_err=max(h0[k]["max_abs_err"] for k in H0_SETS),
        ms=h0["main"]["ms"], plain_ms=h0["main"]["plain_ms"],
        bound_ms=max(h0["main"]["t_bytes"], h0["main"]["t_ops"]),
        bound_by="bytes" if h0["main"]["t_bytes"] >= h0["main"]["t_ops"]
        else "operations", library_ms=None,
        by_set={k: dict(pairs=h0[k]["pairs"], K=h0[k]["K"], ms=h0[k]["ms"],
                        plain_ms=h0[k]["plain_ms"],
                        bound_ms=max(h0[k]["t_bytes"], h0[k]["t_ops"]),
                        bit_for_bit_vs_cpu=h0[k]["bit_for_bit_vs_cpu"])
                for k in H0_SETS},
        layout=h0["layout"], held_against_plain=True),
        dict(
        name="window_sample", route="cuda",
        source="tda_eeg_audio_tpu_torch/csrc/window_sample.cu",
        replaces="tda_eeg_audio_tpu/models/classify.py:48 window_sample_indices "
                 "(host NumPy, not Pallas)",
        launches=report["window_sample_launches_total"]
        + sum(r["window_sample_launches"] for r in cli_report.values())
        + iir_report["window_sample_launches_total"]
        + sum(r["window_sample_launches_total"] for r in (knob_reports or {}).values())
        + sum(r["window_sample_launches_total"] for r in mesh_reports.values()),
        launches_by_path=dict(
            runner=report["window_sample_launches"],
            cli={k: r["window_sample_launches"] for k, r in cli_report.items()},
            runner_iir_scan=iir_report["window_sample_launches"],
            runner_knobs={k: r["window_sample_launches"] for k, r in
                          (knob_reports or {}).items()},
            runner_mesh={k: r["window_sample_launches"] for k, r in mesh_reports.items()}),
        ms=ws["ms"], ms_batch=ws["ms_batch"], host_us_batch=ws["host_us_batch"],
        plain_ms=ws["numpy_ms"], bound_ms=None,
        bound_by="latency: ~80 dependent PCG64 steps a lane", library_ms=None,
        lanes=ws["lanes"], layout=ws["layout"], held_against_plain=True),
        dict(
        name="window_distance", route="cuda",
        source="tda_eeg_audio_tpu_torch/csrc/window_distance.cu",
        replaces="the window selection's sliding_windows / gather / correlation_matrix / "
                 "correlation_to_distance chain (XLA and torch generics, not Pallas)",
        launches=report["window_distance_launches_total"]
        + iir_report["window_distance_launches_total"]
        + sum(r["window_distance_launches_total"] for r in mesh_reports.values()),
        launches_by_path=dict(
            runner=report["window_distance_launches"],
            runner_iir_scan=iir_report["window_distance_launches"],
            runner_mesh={k: r["window_distance_launches"] for k, r in mesh_reports.items()}),
        ms=wd["features"]["ms"], ms_comparison=wd["comparison"]["ms"],
        plain_ms=wd["features"]["plain_ms"], bound_ms=wd["features"]["bound_ms"],
        bound_by="bytes" if wd["features"]["bytes_ms"] >= wd["features"]["ops_ms"]
        else "operations", library_ms=None, layout=wd["layout"],
        max_dr_vs_float64=wd["features"]["max_dr_vs_float64"],
        plain_max_dr_vs_float64=wd["features"]["plain_max_dr_vs_float64"],
        held_against_plain=True)]
    print(f"smoke: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase11-rank"]:
        sys.exit(rank_worker(sys.argv[2:]))
    sys.exit(main())
