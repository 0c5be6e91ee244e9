#!/usr/bin/env python3
"""Readings for the limits of `correct`: the program's numbers over many
seeds, and the control's (the reference computed in bfloat16 in the
program's place), at the cell's own size, in one process.

    python3 benchmark/limits.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--out FILE]

For each seed: the study made from the seed, one job of the cell's traffic
through the port (the first also warms up), the numbers of the check; for
each control seed the same with the control in the program's place (the
statistics' control reads the program's rows in bfloat16).  One JSON line a
seed on standard output, and all of them in --out.  The benchmark's own
runs never run the control."""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import cell as C
    from benchmark.harness import check, spec
    from benchmark.reference.study import Study

    if not torch.cuda.is_available():
        print("limits: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(spec.load(ROOT), ROOT, args.workload)
    import tempfile
    cell["tmp"] = tempfile.mkdtemp(prefix="limits-")
    port = C._port()
    pipeline = spec.reference_pipeline(cell)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    lines = []
    for seed in sorted(set(seeds) | set(controls)):
        t0 = time.perf_counter()
        study, job = C.make_job(cell, seed, "cuda", port)
        outputs = job()["outputs"]
        ref = Study(study, pipeline)
        for role, precision in (("program", "float64"), ("control", "bfloat16")):
            if seed not in (seeds if role == "program" else controls):
                continue
            t1 = time.perf_counter()
            numbers, drawn = check.check(study, pipeline, cell["config"]["compare"], outputs,
                                         seed, precision=precision, reference=ref)
            line = dict(workload=args.workload, seed=seed, role=role, numbers=numbers,
                        drawn=drawn, reference_s=dict(ref.seconds),
                        check_s=time.perf_counter() - t1,
                        seed_s=time.perf_counter() - t0)
            print(json.dumps(line), flush=True)
            lines.append(line)
        del job, study, outputs, ref
        gc.collect()
        torch.cuda.empty_cache()
    import shutil
    shutil.rmtree(cell["tmp"], ignore_errors=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
