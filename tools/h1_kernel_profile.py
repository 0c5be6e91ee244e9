#!/usr/bin/env python3
"""Where the H1 kernels' time goes on the card, at the main path's shapes.

    python3 tools/h1_kernel_profile.py [--reps 3] [--out FILE]

Needs one CUDA card and nvcc.  Builds the reduction kernel
(`tda_eeg_audio_tpu_torch/csrc/h1_reduce.cu`) and the phase-1 kernel
(`csrc/h1_phase1.cu`), each with its instrumented twin (-DH1_PROFILE,
-DH1_PHASE1_PROFILE), side by side.  On the operands of one 16-recording
study batch (3120 EEG windows at n = 47, 1200 Takens clouds at n = 124) it
  * splits the plain phase 1 (`homology_h1._phase1`) into its parts, each
    timed by CUDA events on the previous part's outputs with its peak
    memory: the stable sort and rank scatter (`_edge_ranks`), the forest
    (`_boruvka_forest`), the sieve (`_sieve`), the compactions
    (`_compact`); beside them the phase-1 kernel (one launch, its sort
    inside) with peak memory, held bit for bit against the plain version,
    and its instrumented build's split: the share of thread 0's clock ticks
    per part (radius and keys, sort, ranks, rank matrix out, forest, sieve,
    H0 deaths, creators) and the SMs' busy share (chip_smoke.py's
    `phase1_check`);
  * holds the kernel and its instrumented twin against each other (pair
    keys, steps, overflow: equal) and times the kernel by CUDA events;
  * reads the instrumented build: the share of thread 0's clock ticks per
    part of the step, the words moved by stored-column XORs and stores, the
    nonzero words per stored column, and from each window's start/end stamps
    the busy blocks over the launch and the time per step;
  * list-schedules the measured window times on the kernel's grid in several
    window orders (the most that handing windows out in another order than
    the batch's could gain), with each key's correlation with the steps.
One JSON line per reading; all of them also go to --out (default
build/h1_kernel_profile.json).
"""

from __future__ import annotations

import argparse
import heapq
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
STEP_BUDGET = 8192
SHAPES = {"n47": (47, 128), "n124": (124, 96)}


def makespan_ms(dur_ns, key, grid: int) -> float:
    """End of the last window when windows are handed to `grid` blocks in
    descending order of key (stable), each block taking the next when free."""
    import torch

    free = [0.0] * grid
    for i in torch.argsort(key, descending=True, stable=True).tolist():
        heapq.heappush(free, heapq.heappop(free) + float(dur_ns[i]))
    return max(free) / 1e6


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "h1_kernel_profile.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("h1_kernel_profile: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import (B_REC, K_FEAT, card_line, cuda_ms, phase1_check,
                            profile_reading, stage_inputs)
    from tda_eeg_audio_tpu_torch.config import DEFAULT_CONFIG
    from tda_eeg_audio_tpu_torch.io.synthetic import SynthDataset, load_batch
    from tda_eeg_audio_tpu_torch.ops import cuda_build
    from tda_eeg_audio_tpu_torch.ops import homology_cuda as HC
    from tda_eeg_audio_tpu_torch.ops import homology_h1 as H
    from tda_eeg_audio_tpu_torch.ops import phase1_cuda as P1

    dev = torch.device("cuda")
    out = [dict(card=card_line(), torch=torch.__version__)]
    print(json.dumps(out[0]), flush=True)

    def emit(**rec):
        out.append(rec)
        print(json.dumps(rec), flush=True)

    _, build_s = cuda_build.build_libraries(
        [(HC.SRC, ()), (HC.SRC, HC.PROFILE_FLAGS), (P1.SRC, ()),
         (P1.SRC, P1.PROFILE_FLAGS)], verbose=True)
    emit(build_s=build_s)

    cfg = DEFAULT_CONFIG
    ds = SynthDataset(n_subjects=8, n_per_subject=1, cfg=cfg)
    batch = load_batch(ds, list(range(B_REC)), K_FEAT, cfg)
    d47, d124, npts = stage_inputs(batch, cfg, dev)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ok = True

    for name, dm, n_pts in (("n47", d47, None), ("n124", d124, npts)):
        n, na = SHAPES[name]
        B = dm.shape[0]

        def timed(fn):
            """(CUDA-event ms over args.reps, peak bytes above the start)."""
            fn()                                    # warm
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            fn()
            torch.cuda.synchronize()
            return cuda_ms(fn, args.reps), torch.cuda.max_memory_allocated() - before

        rk = H._edge_ranks(dm, n, 2.0, n_pts)
        tree = H._boruvka_forest(rk["key_mat"])
        vstar = H._sieve(rk["rank_mat"], rk["e_rank"], n)
        parts = dict(
            sort_and_ranks=lambda: H._edge_ranks(dm, n, 2.0, n_pts),
            forest=lambda: H._boruvka_forest(rk["key_mat"]),
            sieve=lambda: H._sieve(rk["rank_mat"], rk["e_rank"], n),
            compactions=lambda: H._compact(rk, tree, vstar, n, na),
            whole=lambda: H._phase1(dm, n, 2.0, na, n_pts))
        split = {}
        for part, fn in parts.items():
            ms, peak = timed(fn)
            split[part] = dict(ms=ms, peak_bytes=peak)
        del rk, tree, vstar
        m = n * (n - 1) // 2
        kernel = phase1_check(dm, n_pts, n, na, args.reps)
        ok &= not kernel["mismatched"]
        emit(shape=name, windows=B, phase1_plain=split,
             plain_bytes_per_edge_vertex=split["whole"]["peak_bytes"] / B / (m * n),
             chunk_windows=HC.phase1_chunk(n), phase1_kernel=kernel)
        ins = H.reduction_inputs(P1.phase1_cuda(dm, n, 2.0, na, n_pts))

        run = lambda: HC.reduce_cuda(*ins, n=n, step_budget=STEP_BUDGET)
        ref = run()
        rn = HC.reduce_cuda_profiled(*ins, n=n, step_budget=STEP_BUDGET)
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for a, b in zip(rn[:3], ref))
        ok &= equal
        steps = ref[1]
        plan = HC.kernel_plan(n, na, B, HC.blocks_per_sm(n), n_sms)
        emit(shape=name, windows=B, plan=plan, instrumented_equal=equal,
             kernel_ms=[cuda_ms(run, args.reps) for _ in range(2)],
             steps_mean=float(steps.double().mean()), steps_max=int(steps.max()),
             overflow=int(ref[2].sum()))
        emit(shape=name, profile=profile_reading(
            rn[3], rn[4], steps, [(0, B)], n_sms, HC.PROFILE_SLOTS,
            HC.PROFILE_TICKS))

        dur = (rn[4][:, 1] - rn[4][:, 0]).double().cpu()
        keys = dict(window_order=-torch.arange(B).double(),
                    creators=(ins[4] >= 0).sum(1).double().cpu(),
                    edges_in_complex=ins[5].double().cpu(),
                    measured_time=dur)
        emit(shape=name, schedule_ms={k: makespan_ms(dur, v, plan["grid"])
                                      for k, v in keys.items()},
             mean_load_ms=float(dur.sum()) / plan["grid"] / 1e6,
             longest_window_ms=float(dur.max()) / 1e6,
             corr_with_steps={k: float(torch.corrcoef(torch.stack(
                 [v, steps.double().cpu()]))[0, 1]) for k, v in keys.items()})

    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(dict(ok=bool(ok))))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
