#!/usr/bin/env python3
"""Card vs CPU agreement of the port's slice on small batches, over seeds
and window lengths: the conditioning behind `chip_smoke.py` phase 5.

    python3 tools/card_vs_cpu.py [--windows 0.2 1.0] [--seeds 4]

Needs one CUDA card.  Prints one JSON line per (window length, seed): the
outputs that miss phase 5's tolerances, each float output's largest
|card − CPU| over its tolerance, and the largest card − CPU difference of
the features stage's correlation distances.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch

    from chip_smoke import card_line, small_reference_check

    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=float, nargs="+", default=[0.2, 1.0])
    ap.add_argument("--seeds", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("card_vs_cpu: no CUDA device", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", flush=True)
    for window_sec in args.windows:
        for seed in range(args.seeds):
            bad, ratio, dist_err = small_reference_check(
                torch.device("cuda"), window_sec=window_sec, seed=seed)
            print(json.dumps(dict(window_sec=window_sec, seed=seed,
                                  mismatched=bad, dist_err=dist_err,
                                  ratio=ratio)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
