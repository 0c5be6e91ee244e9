#!/usr/bin/env python3
"""The window → correlation-distance kernel of this checkout against other
builds of it, in turns, in one call.

    python3 tools/window_distance_ab.py [--reps 20] [--out FILE] [--no-this] \
        [--variant NAME=SOURCE[:FLAG,FLAG...]] ...

Needs one CUDA card and nvcc.  A variant is another copy of
`csrc/window_distance.cu` with the same C interface (`window_distance_launch`
and `window_distance_layout`), built with the port's nvcc flags plus FLAGs.
On three sets of windows — `features`: a features batch of the study's
shapes (64 recordings × 5 bands × 54 windows of the FIR bank's strided
output, `chip_smoke.window_distance_inputs`), `comparison`: its first 15
windows of band 0 for every band (the in-call comparison's index), and
`synthetic`: 16 recordings of the port's synthetic EEG with the features
stage's md5 sample — it runs this build, the variants, the variants again in
reverse and this build again, and for each: the CUDA-event ms of a call over
--reps calls, the largest |Δr| (read through the "standard" distance, d =
1 − r) from the plain chain on the card and from the plain chain in float64,
whether its NaN and zero entries are the plain chain's, and its layout as its
library reports it.  The plain chain's own largest |Δr| from float64 and its
ms are read once a set.  One JSON line per set; all of them also go to --out
(default build/window_distance_ab.json).
"""

from __future__ import annotations

import argparse
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
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--variant", action="append", default=[], type=parse_variant)
    ap.add_argument("--no-this", action="store_true",
                    help="time the variants only, not this checkout's kernel")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "window_distance_ab.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("window_distance_ab: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import K_CMP, K_FEAT, card_line, cuda_ms, window_distance_inputs
    from tda_eeg_audio_tpu_torch.config import DEFAULT_CONFIG as cfg
    from tda_eeg_audio_tpu_torch.io.synthetic import SynthDataset, load_batch
    from tda_eeg_audio_tpu_torch.models import programs as P
    from tda_eeg_audio_tpu_torch.ops import cuda_build
    from tda_eeg_audio_tpu_torch.ops import window_distance_cuda as WDC
    from tda_eeg_audio_tpu_torch.ops.geometry import window_distances_plain
    from tda_eeg_audio_tpu_torch.ops.signal import bandpass_bank

    builds = ([] if args.no_this else [("this", WDC.SRC, ())]) + args.variant
    cuda_build.build_libraries(list(dict.fromkeys((src.resolve(), flags)
                                                  for _, src, flags in builds)), verbose=True)
    libs = {name: cuda_build.load(src.resolve(), WDC.SIGNATURES, flags)
            for name, src, flags in builds}
    layouts = {name: cuda_build.library_layout(lib, "window_distance_layout",
                                               WDC.LAYOUT_FIELDS, WDC.STUDY_WIN)
               for name, lib in libs.items()}

    dev = torch.device("cuda")
    win, step = cfg.win_samples, cfg.step_samples
    banded, idx = window_distance_inputs(dev)
    batch = load_batch(SynthDataset(n_subjects=8, n_per_subject=1, cfg=cfg),
                       list(range(16)), K_FEAT, cfg)
    syn = bandpass_bank(torch.as_tensor(batch["eeg"], device=dev), P._fir_bank(cfg, dev))
    sets = {"features": (banded, idx),
            "comparison": (banded, idx[:, :1, :K_CMP].expand(-1, 5, -1)),
            "synthetic": (syn, torch.as_tensor(batch["use_idx"], device=dev).long())}

    out = [dict(card=card_line(), torch=torch.__version__, layouts=layouts)]
    print(json.dumps(out[0]), flush=True)
    order = [b[0] for b in builds] + [b[0] for b in reversed(builds)]
    for set_name, (x, ix) in sets.items():
        plain = window_distances_plain(x, ix, "standard", win, step)
        f64 = window_distances_plain(x.double(), ix, "standard", win, step)
        ok = ~torch.isnan(f64)
        row = dict(set=set_name, windows=ix.numel(),
                   plain_vs_f64=float((plain.double() - f64)[ok].abs().max()),
                   plain_ms=cuda_ms(lambda: window_distances_plain(x, ix, cfg.distance_method,
                                                                   win, step), reps=3),
                   builds={})
        plan = WDC.kernel_plan(x.shape[0], x.shape[2], ix.shape[2], x.shape[1], win)
        for name in order:
            lib = libs[name]
            got = WDC.run(lib, x, ix, "standard", win, step, plan)
            ms = cuda_ms(lambda: WDC.run(lib, x, ix, cfg.distance_method, win, step, plan),
                         reps=args.reps)
            rec = row["builds"].setdefault(name, dict(ms=[]))
            rec["ms"].append(ms)
            rec.update(
                vs_plain=float((got - plain)[ok].abs().max()),
                vs_f64=float((got.double() - f64)[ok].abs().max()),
                same_nan=bool(torch.equal(torch.isnan(got), torch.isnan(plain))),
                same_zero=bool(torch.equal(got == 0, plain == 0)))
        out.append(row)
        print(json.dumps(row), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text("\n".join(json.dumps(r) for r in out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
