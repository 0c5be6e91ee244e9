"""Command line of the port, with the reference CLI's commands and artifacts:

  preprocess — banded windows      (notebooks/1_preprocesamiento.ipynb cell 3)
  graphs     — distance matrices   (notebooks/2_graph_construction.ipynb cell 8)
  features   — feature export      (scripts/tda_eeg_classification_v2.py front half)
  classify   — classification      (scripts/classification_rerun.py)
  ablate     — per-band ablation   (results/gamma_investigation.json)
  compare    — EEG↔audio comparison (scripts/tda_eeg_audio_comparison.py)
  control    — matched/mismatched  (scripts/matched_vs_mismatched.py)
  eda        — dataset inventory/PSD (notebooks/0_eda.ipynb)
  study      — features+classify+compare+control+figures

    python -m tda_eeg_audio_tpu_torch.cli study --data DATA --results OUT
    python -m tda_eeg_audio_tpu_torch.cli features --device cpu --backend host

It runs on the CUDA card unless `--device cpu` is given; without a card the
default raises, nothing falls back.  `classify`, `ablate` and `study` need
scikit-learn on the host, figures need matplotlib (skipped with a logged
`figures_skipped` without it).

Batch sharding (reference tda_eeg_classification_v2.py:54-60,608-668): the
env vars BATCH_START / BATCH_END / WRITE_PARTIAL / MERGE_PARTIALS — or the
equivalent flags — shard the features stage across independent invocations
with .npz partials merged by `--merge-partials`, which builds no runner and
touches no device.  Multi-process runs automate it: with
`--coordinator HOST:PORT --num-processes P --process-id I` (or torchrun's
MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK), each process joins one gloo
group, binds to its card, takes `runtime.process_shard` of the recordings
for `features` / `study` (unless a batch range is given) and writes its
partial; `--merge-partials` then joins them.  In one process, `--mesh auto`
(the default) shards each batch of the fused programs over every visible
card when there are several (`StudyRunner(mesh=...)`).
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import json
import os
import sys
from pathlib import Path

import numpy as np

from . import tuning


def _build_runner(args):
    import dataclasses

    from .config import DEFAULT_CONFIG, GOOD_ELECTRODES
    from .io.device_store import build_from_dataset
    from .models.study import StudyRunner
    from .runtime import init_distributed, resolve_device

    # a no-op for one process; else joins the group and binds to a card
    info = init_distributed(args.coordinator, args.num_processes,
                            args.process_id, device=args.device)
    if info["num_processes"] > 1:
        print(f"distributed: process {info['process_id']}/"
              f"{info['num_processes']}")
    dev = resolve_device(args.device)
    cfg = DEFAULT_CONFIG
    if args.wasserstein:
        cfg = dataclasses.replace(cfg, wasserstein_backend=(
            "sinkhorn" if args.wasserstein == "sinkhorn" else "host_exact"))
    if args.data:
        from .io.matfiles import MatDataset

        ds = MatDataset(args.data)
    else:
        from .io.synthetic import SynthDataset

        ds = SynthDataset(n_subjects=args.subjects,
                          n_per_subject=args.per_subject)
    # the dataset is staged into the device's memory once, so every stage
    # reads each file once and multi-stage commands (study) never cross the
    # host↔device link again
    store = build_from_dataset(ds, GOOD_ELECTRODES, args.t_eeg_pad, args.t_audio_pad,
                               device=dev, verbose=True)
    return StudyRunner(store, cfg, eeg_batch=args.batch, results_dir=args.results,
                       backend=args.backend, t_eeg_pad=args.t_eeg_pad,
                       t_audio_pad=args.t_audio_pad, n_rs_max=args.n_rs_max,
                       device=dev, mesh="auto" if args.mesh == "auto" else None)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="tda-eeg-audio-tpu-torch")
    ap.add_argument("command", choices=["preprocess", "graphs", "features",
                                        "classify", "ablate", "compare",
                                        "control", "eda", "study"])
    ap.add_argument("--data", default=None,
                    help=".mat data root (data/slow, data/fast); default: synthetic")
    ap.add_argument("--subjects", type=int, default=45)
    ap.add_argument("--per-subject", type=int, default=16)
    ap.add_argument("--results", default="results")
    ap.add_argument("--out", default=None,
                    help="artifact dir for preprocess/graphs stages")
    ap.add_argument("--batch", type=int, default=tuning.EEG_BATCH,
                    help="recordings per device batch (default: tuning.py)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    # multi-process runs (torch.distributed over gloo); default to torchrun's
    # MASTER_ADDR:MASTER_PORT / WORLD_SIZE / RANK
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 for multi-process runs")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--mesh", choices=["auto", "off"], default="auto",
                    help="auto (default): shard each batch of the fused "
                         "features and comparison programs over every "
                         "visible CUDA card when there are several (one "
                         "process); off = one device")
    ap.add_argument("--backend", choices=["auto", "device", "host"],
                    default=None,
                    help="homology backend (default auto: the CUDA kernel on "
                         "the card, the plain reduction on the CPU; host = "
                         "every diagram on the host engine, staged path)")
    ap.add_argument("--wasserstein", choices=["exact", "sinkhorn"],
                    default=None,
                    help="sinkhorn (default) = fused on-device OT (the "
                         "benchmarked path); exact = persim's assignment on "
                         "the host (parity, slower)")
    ap.add_argument("--permutations", type=int, default=None)
    ap.add_argument("--bootstrap", type=int, default=None)
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace, the spans' timings "
                         "and the counters to DIR")
    ap.add_argument("--log", default=None, metavar="FILE",
                    help="structured JSON-lines event log")
    # padded shapes of the device batches: the study's defaults hold its
    # longest recordings (≈ 23 s); short recordings may take smaller pads
    ap.add_argument("--t-eeg-pad", type=int, default=5800)
    ap.add_argument("--t-audio-pad", type=int, default=44100 * 24)
    ap.add_argument("--n-rs-max", type=int, default=5900)
    # job-level sharding (reference BATCH_START/BATCH_END/WRITE_PARTIAL/
    # MERGE_PARTIALS env vars, tda_eeg_classification_v2.py:54-60,608-668)
    ap.add_argument("--batch-start", type=int,
                    default=int(os.environ.get("BATCH_START", -1)))
    ap.add_argument("--batch-end", type=int,
                    default=int(os.environ.get("BATCH_END", -1)))
    ap.add_argument("--write-partial", action="store_true",
                    default=os.environ.get("WRITE_PARTIAL", "0") == "1")
    ap.add_argument("--merge-partials", action="store_true",
                    default=os.environ.get("MERGE_PARTIALS", "0") == "1")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.log:
        from .utils import logging as tlog
        tlog.configure(args.log)

    out_dir = Path(args.results)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.command == "features" and args.merge_partials:
        # pure file work: the merge runs wherever the partials are, after
        # the per-process feature jobs, without a runner or a device
        _merge_partials(out_dir)
        return 0
    runner = _build_runner(args)

    from .runtime import last_record, logged_span, timed_spans
    from .utils import logging as tlog
    from .utils.profiling import device_trace

    tlog.LOGGER.event("command_start", command=args.command,
                      n_recordings=len(runner.store))
    # --profile: the command is the top span of one timed block, whose
    # record (every span's ms, calls, parent and self ms; the counters) is
    # written beside the trace
    timed = timed_spans() if args.profile else contextlib.nullcontext()
    with device_trace(args.profile), timed:
        with logged_span(args.command, runner.device):
            rc = _dispatch(args, runner, out_dir)
    if args.profile:
        rec = last_record()
        prof = Path(args.profile)
        (prof / "stage_times.json").write_text(json.dumps(rec["spans"], indent=2))
        (prof / "counters.json").write_text(json.dumps(rec["counters"], indent=2))
    return rc


def _load_features(out_dir: Path):
    return (np.load(out_dir / "X.npy"), np.load(out_dir / "y.npy"),
            np.load(out_dir / "subjects.npy", allow_pickle=True))


def _dispatch(args, runner, out_dir: Path) -> int:
    if args.command == "preprocess":
        rows = runner.write_preprocessed(args.out or "preprocessed")
        print(f"preprocess: {len(rows)} recordings → {args.out or 'preprocessed'}")
        return 0
    if args.command == "graphs":
        n = runner.write_graphs(args.out or "graphs")
        print(f"graphs: {n} recordings → {args.out or 'graphs'}")
        return 0
    if args.command == "eda":
        from .models.eda import run_eda

        out = run_eda(runner.store, runner.cfg, results_dir=out_dir,
                      eeg_batch=args.batch, t_pad=runner.t_eeg_pad,
                      device=runner.device)
        print(f"eda: {out['n_recordings']} recordings, "
              f"{out['n_subjects']} subjects → eda_summary.json")
        return 0
    if args.command in ("features", "study"):
        bs = args.batch_start if args.batch_start >= 0 else None
        be = args.batch_end if args.batch_end >= 0 else None
        # multi-process: each process takes its deterministic slice and
        # writes a partial; --merge-partials joins them afterwards — the
        # reference's BATCH_START/BATCH_END contract, automated
        from .runtime import process_rank_world, process_shard

        if process_rank_world()[1] > 1 and bs is None and be is None:
            bs, be = process_shard(len(runner.store))
            args.write_partial = True
            print(f"process shard: recordings [{bs}, {be})")
        X, y, subjects, filenames, meta = runner.compute_feature_dataset(
            batch_start=bs, batch_end=be)
        from .models.classify import feature_names_220

        if args.write_partial:
            pdir = out_dir / "partials"
            pdir.mkdir(parents=True, exist_ok=True)
            np.savez(pdir / f"batch_{bs or 0}_{be if be is not None else len(X)}.npz",
                     X=X, y=y, subjects=subjects,
                     filenames=np.array(filenames),
                     feature_names=np.array(feature_names_220()))
            print(f"partial: {X.shape[0]} rows → {pdir}")
            return 0
        np.save(out_dir / "X.npy", X)
        np.save(out_dir / "y.npy", y)
        np.save(out_dir / "subjects.npy", subjects)
        (out_dir / "feature_names.txt").write_text(
            "\n".join(feature_names_220()) + "\n")
        (out_dir / "filenames.txt").write_text("\n".join(filenames) + "\n")
        _write_feature_metadata(out_dir, meta.get("file_metadata", []))
        print(f"features: X {X.shape} → {out_dir}")
    if args.command == "ablate":
        from .models import classify as cls

        if (out_dir / "X.npy").exists():
            X, y, subjects = _load_features(out_dir)
        else:
            X, y, subjects, _, _ = runner.compute_feature_dataset()
        res = cls.run_band_ablation(X, y, subjects, cls.feature_names_220(),
                                    runner.cfg)
        (out_dir / "gamma_investigation.json").write_text(json.dumps(res, indent=2))
        print(f"ablate: gamma-only "
              f"{res['classifier_gamma_only']['mean_accuracy']:.4f} vs "
              f"no-gamma {res['classifier_without_gamma']['mean_accuracy']:.4f}")
        return 0
    if args.command in ("classify", "study"):
        if args.command == "classify" and (out_dir / "X.npy").exists():
            from .models import classify as cls

            X, y, subjects = _load_features(out_dir)
            res = cls.run_classification(
                X, y, subjects, cls.feature_names_220(), runner.cfg,
                n_permutations=args.permutations, n_bootstrap=args.bootstrap)
            (out_dir / "results_summary.json").write_text(json.dumps(res, indent=2))
        else:
            res = runner.run_classification(args.permutations, args.bootstrap)
        print(f"classify: acc {res['cv_accuracy_mean']:.4f} "
              f"p {res['p_value']:.4g} → results_summary.json")
    if args.command in ("compare", "study"):
        out = runner.run_comparison(args.permutations)
        sig = [b for b, s in out["band_results"].items()
               if s.get("wass_h1_sig_fdr")]
        print(f"compare: significant bands after FDR: {sig or 'none'}")
    if args.command in ("control", "study"):
        res = runner.run_control()
        for band, s in res.items():
            if "p_fdr" in s:
                print(f"control {band}: matched {s['w_matched']:.4f} vs "
                      f"mismatched {s['w_mismatched']:.4f} p_fdr {s['p_fdr']:.4g}")
    if args.command == "study":
        written = runner.write_sample_figures()
        print(f"figures: {len(written)} sample figures → {out_dir}/figures")
    return 0


def _write_feature_metadata(out_dir: Path, fmeta: list[dict]) -> None:
    """metadata.csv + metadata.json: per-file window counts and runtime
    validation issues (reference tda_eeg_classification_v2.py:684-690)."""
    if not fmeta:
        return
    with open(out_dir / "metadata.csv", "w", newline="") as f:
        wr = csv.DictWriter(f, fieldnames=list(fmeta[0].keys()))
        wr.writeheader()
        wr.writerows(fmeta)
    (out_dir / "metadata.json").write_text(
        json.dumps(fmeta, indent=2, ensure_ascii=False))


def _partial_start(path: Path) -> int:
    return int(path.stem.split("_")[1])


def _merge_partials(out_dir: Path) -> None:
    """Merge partials/batch_*.npz into the X/y/subjects arrays with a
    feature-name consistency check (reference
    tda_eeg_classification_v2.py:608-668), in the order of their first
    recording, so the merge equals the one-shot run row for row."""
    pdir = out_dir / "partials"
    parts = sorted(pdir.glob("batch_*.npz"), key=_partial_start)
    if not parts:
        raise SystemExit(f"no partials under {pdir}")
    Xs, ys, subjs, fns, names_ref = [], [], [], [], None
    for p in parts:
        z = np.load(p, allow_pickle=True)
        names = list(z["feature_names"])
        if names_ref is None:
            names_ref = names
        elif names != names_ref:
            raise SystemExit(f"feature-name mismatch in {p.name}")
        Xs.append(z["X"])
        ys.append(z["y"])
        subjs.append(z["subjects"])
        fns.extend(list(z["filenames"]))
    X = np.vstack(Xs)
    np.save(out_dir / "X.npy", X)
    np.save(out_dir / "y.npy", np.concatenate(ys))
    np.save(out_dir / "subjects.npy", np.concatenate(subjs))
    (out_dir / "feature_names.txt").write_text(
        "\n".join(str(n) for n in names_ref) + "\n")
    (out_dir / "filenames.txt").write_text("\n".join(str(f) for f in fns) + "\n")
    print(f"merged {len(parts)} partials → X {X.shape}")


if __name__ == "__main__":
    sys.exit(main())
