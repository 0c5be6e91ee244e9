#!/usr/bin/env python3
"""The phase-1 kernel of this checkout against other builds of it, in turns,
in one call.

    python3 tools/h1_phase1_ab.py [--reps 20] [--out FILE] \
        [--variant NAME=SOURCE[:THREADS][:FLAG,FLAG...]] ...

Needs one CUDA card and nvcc.  A variant is another copy of
`csrc/h1_phase1.cu` with the same C interface (a saved earlier design, say),
built with the port's nvcc flags plus FLAGs, and launched with THREADS
threads a block at n = 124 (default: `kernel_plan`'s).  Each build and its
instrumented twin (-DH1_PHASE1_PROFILE) are built side by side.  On the
operands of one 16-recording study batch (3120 EEG windows at n = 47, 1200
Takens clouds at n = 124, as chip_smoke.py's phase 3) it runs this build,
the variants, the variants again in reverse and this build again, and for
each: the launcher's CUDA-event ms over --reps calls, whether its dict has
this build's bits, the blocks an SM holds, and the instrumented build's
shares of thread 0's ticks per part with the SMs' busy share.  One JSON
line per shape; all of them also go to --out (default
build/h1_phase1_ab.json).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
SHAPES = {"n47": (47, 128), "n124": (124, 96)}


def parse_variant(text: str):
    name, _, rest = text.partition("=")
    src, _, rest = rest.partition(":")
    threads, _, flags = rest.partition(":")
    return name, Path(src), int(threads) if threads else None, \
        tuple(f for f in flags.split(",") if f)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--variant", action="append", default=[], type=parse_variant)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "h1_phase1_ab.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("h1_phase1_ab: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import (B_REC, K_FEAT, card_line, cuda_ms, phase1_profile_reading,
                            same_bits, stage_inputs)
    from tda_eeg_audio_tpu_torch.config import DEFAULT_CONFIG
    from tda_eeg_audio_tpu_torch.io.synthetic import SynthDataset, load_batch
    from tda_eeg_audio_tpu_torch.ops import cuda_build
    from tda_eeg_audio_tpu_torch.ops import phase1_cuda as P1

    builds = [("this", P1.SRC, None, ())] + args.variant
    jobs = [(src.resolve(), flags + extra) for _, src, _, flags in builds
            for extra in ((), P1.PROFILE_FLAGS)]
    unique = list(dict.fromkeys(jobs))          # one nvcc per library
    cuda_build.build_libraries(unique, verbose=True)
    libs = {name: tuple(cuda_build.load(src.resolve(), P1.SIGNATURES, flags + extra)
                        for extra in ((), P1.PROFILE_FLAGS))
            for name, src, _, flags in builds}
    threads_124 = {name: t for name, _, t, _ in builds}

    dev = torch.device("cuda")
    cfg = DEFAULT_CONFIG
    batch = load_batch(SynthDataset(n_subjects=8, n_per_subject=1, cfg=cfg),
                       list(range(B_REC)), K_FEAT, cfg)
    d47, d124, npts = stage_inputs(batch, cfg, dev)
    inputs = {"n47": (d47, None), "n124": (d124, npts)}
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan0 = P1.kernel_plan
    out = [dict(card=card_line(), torch=torch.__version__)]
    print(json.dumps(out[0]), flush=True)
    order = [b[0] for b in builds] + [b[0] for b in reversed(builds)]
    ok = True
    try:
        for shape, (n, na) in SHAPES.items():
            dm, n_pts = inputs[shape]
            rows = {}
            ref = None
            for name in order:
                threads = threads_124[name] if n > 64 else None
                P1.kernel_plan = (lambda n_, na_, t=threads: dict(plan0(n_, na_), threads=t)
                                  if t else plan0(n_, na_))
                lib, lib_p = libs[name]
                got = P1.run(lib, dm, n_pts, n, 2.0, na)
                ref = got if ref is None else ref
                same = all(same_bits(got[k], ref[k]) for k in ref if k != "m")
                ok &= same
                ms = cuda_ms(lambda: P1.run(lib, dm, n_pts, n, 2.0, na), args.reps)
                t = P1.kernel_plan(n, na)["threads"]
                prof = P1.run(lib_p, dm, n_pts, n, 2.0, na, profile=True)
                ph = phase1_profile_reading(prof["prof"], prof["stamps"], n_sms,
                                            P1.check_layout(lib_p, n)["occupancy"])
                rows.setdefault(name, []).append(dict(
                    ms=ms, same_bits=same, threads=t,
                    blocks_per_sm=P1.check_layout(lib, n)["occupancy"],
                    share=ph["share"], window_us=ph["window_us_mean"],
                    sm_busy=ph["sm_busy"]))
            rec = dict(shape=shape, windows=int(dm.shape[0]), reps=args.reps, builds=rows)
            out.append(rec)
            print(json.dumps(rec), flush=True)
    finally:
        P1.kernel_plan = plan0
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(dict(ok=bool(ok))))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
