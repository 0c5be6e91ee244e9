"""One run of one cell: set-up, the measured window of whole jobs, the
traced extras, the check against the reference, the result line.

A job is what a researcher submits: a fresh `StudyRunner` over the study's
`DeviceStore`, built as the port's CLI builds it, and the stages the cell's
traffic names, in the configuration's order, each between two
synchronisations of the card.  Jobs run back to back until `--seconds` have
passed; `recordings_per_s` is the recordings each job takes through all of
its stages, summed over the jobs, over the seconds from the window's start
to the end of its last job."""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import io
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

from . import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "tda_eeg_audio_tpu")


def forbidden_modules(names=None) -> list[str]:
    """The top-level names among `names` (the loaded modules by default),
    compared whole, that are JAX's or the JAX package's."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _dir_bytes(path: Path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


class Job:
    """The program under test: the port's runner over one store."""

    def __init__(self, cell: dict, store, port):
        self.cell = cell
        self.sync = (lambda: None) if store.device.type == "cpu" else _sync
        self.store = store
        self.port = port
        cfg = cell["config"]
        self.cfg = dataclasses.replace(port["DEFAULT_CONFIG"], **cfg["pipeline"])
        self.analysis = [s for s in cfg["analysis"] if s["stage"] in cell["traffic"]["stages"]]
        self.results = Path(tempfile.mkdtemp(prefix="results-", dir=cell["tmp"]))
        self.bytes_written = 0

    def __call__(self):
        """One job: {"stage_s": {stage: seconds}, "outputs": {...},
        "cards": the cards the runner's mesh spans (1 without one)}."""
        from torch.profiler import record_function

        runner = self.port["StudyRunner"](self.store, self.cfg, results_dir=self.results,
                                          verbose=False, **self.cell["config"]["runner"])
        outputs, stage_s = {}, {}
        cards = len(runner.mesh) if runner.mesh else 1
        # the rows the control's statistics read: run_control returns only
        # the statistics, so the private method that computes them is wrapped
        original = runner._control_stats

        def control_stats(rows):
            outputs["control_rows"] = rows
            return original(rows)

        runner._control_stats = control_stats
        sink = io.StringIO()
        try:
            for st in self.analysis:
                self.sync()
                t0 = time.perf_counter()
                with record_function(f"stage.{st['stage']}"), contextlib.redirect_stdout(sink):
                    out = getattr(runner, st["method"])(**st["args"])
                self.sync()
                stage_s[st["stage"]] = time.perf_counter() - t0
                if st["stage"] == "features":
                    X, y, _, filenames, _ = out
                    outputs["X"] = X
                    outputs["X_keys"] = [(fn, "slow" if lab == 0 else "fast")
                                         for fn, lab in zip(filenames, y)]
                else:
                    outputs[st["stage"]] = out
        finally:
            # the wrapper holds the runner's bound method: without this the
            # runner and its device tensors would wait for the cyclic GC
            del runner._control_stats
        self.bytes_written += _dir_bytes(self.results)
        return dict(stage_s=stage_s, outputs=outputs, cards=cards)


def make_job(cell: dict, seed: int, device, port):
    """(study, job): the study made from the seed on `device`, handed to
    the port as a `DeviceStore`, and the cell's job over it."""
    from . import generator

    study = generator.make_study(cell["config"]["dataset"], seed, device)
    store = port["DeviceStore"](study["eeg"], study["audio"], study["ns_e"], study["ns_a"],
                                [dict(filename=f, subject=s, condition=c, failed=False)
                                 for f, s, c in study["index"]], study["index"])
    return study, Job(cell, store, port)


def _sync():
    import torch

    torch.cuda.synchronize()


def _port():
    """Import the port (and nothing of the JAX package)."""
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    from tda_eeg_audio_tpu_torch.config import DEFAULT_CONFIG
    from tda_eeg_audio_tpu_torch.io.device_store import DeviceStore
    from tda_eeg_audio_tpu_torch.models.study import StudyRunner
    from tda_eeg_audio_tpu_torch.ops import homology_cuda, phase1_cuda, sinkhorn_log_cuda
    from tda_eeg_audio_tpu_torch.ops import wasserstein_cuda, wasserstein_h0_cuda
    from tda_eeg_audio_tpu_torch.runtime import timed_spans

    return dict(DEFAULT_CONFIG=DEFAULT_CONFIG, DeviceStore=DeviceStore,
                StudyRunner=StudyRunner, timed_spans=timed_spans,
                builds=(homology_cuda.build, phase1_cuda.build, wasserstein_cuda.build,
                        sinkhorn_log_cuda.build, wasserstein_h0_cuda.build))


def _metric_reader(root: Path, name: str):
    path = root / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def run(args, root: Path, t_process: float) -> int:
    """The whole run of `--workload`; prints the result line; returns the
    exit code."""
    import torch

    bench = spec.load(root)
    cell = spec.cell(bench, root, args.workload)
    if not torch.cuda.is_available():
        print("benchmark: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {cell['chips']} cards needed, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    tmp = Path(tempfile.mkdtemp(prefix="benchmark-", dir=os.environ.get("TMPDIR")))
    cell["tmp"] = str(tmp)
    try:
        return _run(args, root, bench, cell, t_process)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(args, root, bench, cell, t_process, device="cuda"):
    """The run after the look for the cards; `device` "cpu" drives the
    port's plain path (the benchmark's own tests)."""
    import torch

    from . import check as C
    from . import trace, work
    from ..reference.study import Study

    parts = {"interpreter_and_torch_s": time.perf_counter() - t_process}
    t = time.perf_counter()
    port = _port()
    on_card = device != "cpu"
    if on_card:
        for build in port["builds"]:
            build()
        torch.cuda.init()
    parts["imports_and_libraries_s"] = time.perf_counter() - t

    t = time.perf_counter()
    study, job = make_job(cell, args.seed, device, port)
    job.sync()
    parts["store_s"] = time.perf_counter() - t

    t = time.perf_counter()
    cards = job()["cards"]
    parts["warmup_job_s"] = time.perf_counter() - t
    if on_card and cards != cell["chips"]:
        print(f"benchmark: the runner spans {cards} cards, the cell asks for "
              f"{cell['chips']}", file=sys.stderr)
        return 4
    t_window = time.perf_counter()
    setup_s = t_window - t_process
    print("[benchmark] setup " + json.dumps(dict(parts, setup_s=setup_s)),
          file=sys.stderr, flush=True)

    n_rec = len(study["index"])
    attempted = failed = 0
    stage_runs, last, ends = [], None, []
    while True:
        attempted += 1
        try:
            res = job()
        except Exception as e:       # noqa: BLE001 - a failed job is counted, the run goes on
            failed += 1
            print(f"[benchmark] job failed: {e!r}", file=sys.stderr, flush=True)
            res = None
        t_end = time.perf_counter()
        ends.append(t_end)
        if res is not None:
            stage_runs.append(res["stage_s"])
            last = res
        if t_end - t_window >= args.seconds:
            break
    window_s = t_end - t_window
    done = attempted - failed
    metrics = {}
    ctx = dict(stage_runs=stage_runs, stages=cell["traffic"]["stages"])

    extra = {}
    if args.trace:
        res, tr, size = trace.profile_job(job, cell["tmp"])
        job.bytes_written += size
        with port["timed_spans"]() as spans:
            job()
        ctx.update(trace=tr, spans_ms=dict(spans))
        extra["device"] = dict(busy_s=tr["busy_s"], window_s=tr["window_s"])
        ops = {}
        for k, v in tr["device_ops"].items():
            ops[trace.short_name(k)] = ops.get(trace.short_name(k), 0.0) + v
        extra["breakdown"] = dict(
            device_ops=sorted(([k, v] for k, v in ops.items()), key=lambda x: -x[1])[:10],
            idle_gaps=[list(x) for x in tr["idle_gaps"][:10]])

    peak = torch.cuda.max_memory_allocated() if on_card else 0
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}", file=sys.stderr)
        return 3

    pipeline = spec.reference_pipeline(cell)
    ref = Study(study, pipeline)
    if args.trace:
        ctx["h1_windows"] = work.h1_windows(ref, cell["traffic"]["stages"])
    outputs = last["outputs"] if last else {}
    written = job.bytes_written
    del job, last
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = {}
    if outputs:
        t = time.perf_counter()
        numbers, drawn = C.check(study, pipeline, cell["config"]["compare"], outputs,
                                 args.seed, reference=ref)
        print(f"[benchmark] reference {time.perf_counter() - t:.1f} s "
              + json.dumps(dict(drawn, seconds=ref.seconds)), file=sys.stderr, flush=True)
    limits = cell["config"]["limits"]
    compared = {k: dict(value=v, limit=limits[k]) for k, v in numbers.items()}
    correct = bool(outputs) and failed == 0 and all(
        v["limit"] is not None and v["value"] <= v["limit"] for v in compared.values())

    if args.trace:
        for m in cell["per_layer"]:
            v = _metric_reader(root, m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
    else:
        metrics["recordings_per_s"] = dict(value=n_rec * done / window_s,
                                           unit="recordings/s")
        metrics["setup_s"] = dict(value=setup_s, unit="s")
    print("[benchmark] run " + json.dumps(dict(
        jobs=attempted, failed=failed, window_s=window_s, recordings=n_rec,
        job_s=[round(b - a, 4) for a, b in zip([t_window] + ends, ends)],
        stage_median_s={k: statistics.median(r[k] for r in stage_runs)
                        for k in (stage_runs[0] if stage_runs else {})},
        bytes_written=written)), file=sys.stderr, flush=True)
    for k, v in compared.items():
        print(f"[benchmark] {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    device = dict(platform="gpu" if on_card else "cpu",
                  kind=torch.cuda.get_device_name(0) if on_card else "cpu", count=cards,
                  memory_peak_bytes=int(peak), **extra.get("device", {}))
    line = dict(correct=correct, attempted=attempted, failed=failed, metrics=metrics,
                device=device)
    if "breakdown" in extra:
        line["breakdown"] = extra["breakdown"]
    line["compared"] = compared
    print(json.dumps(line), flush=True)
    return 0
