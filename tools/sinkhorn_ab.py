#!/usr/bin/env python3
"""The tiered Sinkhorn kernel of this checkout against other builds of it, in
turns, in one call.

    python3 tools/sinkhorn_ab.py [--reps 10] [--out FILE] [--no-this] \
        [--variant NAME=SOURCE[:FLAG,FLAG...]] ...

Needs one CUDA card and nvcc.  A variant is another copy of
`csrc/sinkhorn_tiered.cu` with the same C interface (`sinkhorn_tiered_launch`
and `sinkhorn_tiered_layout`), built with the port's nvcc flags plus FLAGs;
a source without `sinkhorn_tiered_layout` is read as the first design's
interface (one `sinkhorn_tiered_launch` per width class over all pairs),
timed only.  Each build and its instrumented twin (-DSINKHORN_PROFILE) are
built side by side.  On the 2,400 pairs that one 16-recording study batch's
comparison hands the kernel (chip_smoke.py's phase 4b `main`) and on its
pairs of every width class (`classes`), it runs this build, the variants,
the variants again in reverse and this build again, and for each: the
CUDA-event ms of a call over --reps calls and of each width class's pairs
alone, the largest relative difference from the plain version and from a
float64 run of the ladder, each class's threads, shared bytes, blocks an SM,
registers and spill bytes as its library reports them, and the instrumented
build's shares of the pair group's thread 0 ticks per part with the SMs'
busy share per class.  One JSON line per set of pairs; all of them also go
to --out (default build/sinkhorn_ab.json).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def parse_variant(text: str):
    name, _, rest = text.partition("=")
    src, _, flags = rest.partition(":")
    return name, Path(src), tuple(f for f in flags.split(",") if f)


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--variant", action="append", default=[], type=parse_variant)
    ap.add_argument("--no-this", action="store_true",
                    help="time the variants only, not this checkout's kernel")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "sinkhorn_ab.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sinkhorn_ab: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import (B_REC, K_FEAT, card_line, cuda_ms, main_path,
                            sinkhorn_class_pairs, sinkhorn_profile_reading)
    from tda_eeg_audio_tpu_torch.config import DEFAULT_CONFIG
    from tda_eeg_audio_tpu_torch.io.synthetic import SynthDataset, load_batch
    from tda_eeg_audio_tpu_torch.models import programs as P
    from tda_eeg_audio_tpu_torch.ops import cuda_build
    from tda_eeg_audio_tpu_torch.ops import wasserstein_cuda as WC

    builds = ([] if args.no_this else [("this", WC.SRC, ())]) + args.variant
    jobs = [(src.resolve(), flags + extra) for _, src, flags in builds
            for extra in ((), WC.PROFILE_FLAGS)]
    unique = list(dict.fromkeys(jobs))          # one nvcc per library
    cuda_build.build_libraries(unique, verbose=True)
    Pt, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    legacy_sig = {"sinkhorn_tiered_launch": (
        [Pt, Pt, Pt, I, Pt, Pt, Pt, I, I, Pt, I, F, I, I, Pt, I, Pt], I)}
    libs = {}
    for name, src, flags in builds:
        legacy = "sinkhorn_tiered_layout" not in src.read_text()
        sig = legacy_sig if legacy else WC.SIGNATURES
        libs[name] = (cuda_build.load(src.resolve(), sig, flags),
                      cuda_build.load(src.resolve(), sig, flags + WC.PROFILE_FLAGS), legacy)

    def run_legacy(lib, pairs):
        b1, d1, m1, b2, d2, m2 = pairs
        N, K1 = b1.shape
        K2 = b2.shape[1]
        out = torch.empty(N, dtype=torch.float32, device=b1.device)
        ladder = WC.eps_ladder()
        stream = torch.cuda.current_stream().cuda_stream
        for w in WC.WIDTHS[:WC.WIDTHS.index(WC.pair_width(max(K1, K2))) + 1]:
            rc = lib.sinkhorn_tiered_launch(
                b1.data_ptr(), d1.data_ptr(), m1.data_ptr(), K1, b2.data_ptr(),
                d2.data_ptr(), m2.data_ptr(), K2, N,
                ladder.ctypes.data_as(ctypes.c_void_p), WC.STEPS, WC.EPS_LO,
                WC.ITERS, WC.ABSORB, out.data_ptr(), w, stream)
            if rc != 0:
                raise RuntimeError(f"legacy sinkhorn_tiered_launch failed: {rc}")
        return out

    def call(name, pairs):
        lib, _, legacy = libs[name]
        return run_legacy(lib, pairs) if legacy else WC.run(lib, pairs)

    dev = torch.device("cuda")
    cfg = DEFAULT_CONFIG
    batch = load_batch(SynthDataset(n_subjects=8, n_per_subject=1, cfg=cfg),
                       list(range(B_REC)), K_FEAT, cfg)
    perm = np.arange(B_REC) ^ 1
    mis = dict(audio=batch["audio"][perm], n_a=batch["n_a"][perm])
    route, kept = P._wass_sinkhorn_tiered, []

    def keep(*pairs):                   # the comparison's pairs; no kernel run
        kept.append(tuple(x.clone() for x in pairs))
        return torch.zeros(pairs[0].shape[0], device=pairs[0].device)

    P._wass_sinkhorn_tiered = keep
    try:
        main_path(batch, mis, cfg, dev)
    finally:
        P._wass_sinkhorn_tiered = route
    sets = {"main": kept[-1], "classes": sinkhorn_class_pairs(dev)}
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count

    out = [dict(card=card_line(), torch=torch.__version__)]
    print(json.dumps(out[0]), flush=True)
    order = [b[0] for b in builds] + [b[0] for b in reversed(builds)]
    ok = True
    for set_name, pairs in sets.items():
        plain = P.wass_sinkhorn_tiered_plain(*pairs).double().cpu()
        f64 = P.wass_sinkhorn_tiered_plain(*(x.double() if x.is_floating_point() else x
                                             for x in pairs)).cpu()
        nz = f64 != 0
        counts = torch.maximum(pairs[2].sum(1), pairs[5].sum(1)).cpu()
        widths = np.array([WC.pair_width(int(c)) for c in counts])
        rows = {}
        for name in order:
            lib, lib_p, legacy = libs[name]
            got = call(name, pairs).double().cpu()
            rel_plain = float(((got - plain).abs() / plain.abs())[nz].max())
            rel_f64 = float(((got - f64).abs() / f64.abs())[nz].max())
            ok &= bool(torch.isfinite(got).all()) and rel_plain <= 2e-4
            ms = cuda_ms(lambda: call(name, pairs), args.reps)
            by_width = {}
            for w in WC.WIDTHS:
                idx = torch.as_tensor(np.flatnonzero(widths == w), device=dev)
                if idx.numel():
                    sub = [x[idx] for x in pairs]
                    by_width[w] = cuda_ms(lambda: call(name, sub), args.reps)
            row = dict(ms=ms, ms_by_width=by_width, max_rel_vs_plain=rel_plain,
                       max_rel_vs_float64=rel_f64)
            if not legacy:
                row["layout"] = {w: cuda_build.library_layout(
                    lib, "sinkhorn_tiered_layout", WC.LAYOUT_FIELDS, w) for w in WC.WIDTHS}
                prof = torch.zeros((len(widths), len(WC.PROFILE_SLOTS)),
                                   dtype=torch.int64, device=dev)
                stamps = torch.zeros((len(widths), 3), dtype=torch.int64, device=dev)
                WC.run(lib_p, pairs, prof, stamps)
                row["phases"] = sinkhorn_profile_reading(prof, stamps, widths, n_sms)
            rows.setdefault(name, []).append(row)
        rec = dict(set=set_name, pairs=len(widths), reps=args.reps,
                   pairs_by_width={int(w): int((widths == w).sum()) for w in WC.WIDTHS},
                   builds=rows)
        out.append(rec)
        print(json.dumps(rec), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(dict(ok=bool(ok))))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
