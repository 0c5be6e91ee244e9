"""Measured knobs of the runner, the CLI and the bench.

`tuning.json` (next to this file) holds the values that
`tools/tuning_sweep.py` measured on the H100 with `bench_torch.py`, and a
`measured` object with the readings behind them.  A value other than the
default enters the file only when every reading of it beat every reading
of the default in the same calls, with equal windows redone (PERF.md §5).
No knob changes a result: each window's and each pair's arithmetic is
independent of the batch, and a window that overflows the feature arena is
redone exactly.

Resolution, read once at import: an environment variable, then the file,
then the defaults.  A missing file, a file that is not JSON, JSON that is
not an object, or one value that cannot be coerced gives the whole default
set: a partial write must not ship half a configuration.  Unknown keys are
ignored.  The variables carry the port's own prefix (`TDA_TORCH_*`), so a
shell that also runs the JAX package, whose variables are `TDA_TPU_*`,
tunes each package apart:

    TDA_TORCH_TUNING_FILE     another file in place of tuning.json
    TDA_TORCH_EEG_BATCH       recordings per device batch
    TDA_TORCH_EEG_BANK        "", "0" or "false" turn the bank off
    TDA_TORCH_FEATURE_NA_MAX  the features stage's H1 creator arena width

The reference's `pallas_min_n` and `tda_chunk` have no counterpart, and a
file holding them loads with the keys ignored: the CUDA reduction kernel
serves both the n = 47 and the n = 124 clouds, and
`ops/homology_cuda.phase1_chunk` sizes phase 1's chunks by memory.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

_DEFAULTS = dict(
    # recordings per batch of the runner's stages
    eeg_batch=16,
    # the comparison reuses the features stage's per-window EEG diagrams
    # (models/study.py eeg_bank path)
    eeg_bank=True,
    # the features stage's H1 arena width; a window with more creators
    # overflows into the exact redo, so the knob trades speed for redo work
    feature_na_max=128,
)

_ENV = dict(eeg_batch="TDA_TORCH_EEG_BATCH", eeg_bank="TDA_TORCH_EEG_BANK",
            feature_na_max="TDA_TORCH_FEATURE_NA_MAX")

_PATH = Path(os.environ.get("TDA_TORCH_TUNING_FILE",
                            Path(__file__).with_name("tuning.json")))


def _read() -> tuple[dict, set]:
    """(the knobs, the names the file set): the file's knobs over the
    defaults, or the defaults whole and no name."""
    try:
        data = json.loads(_PATH.read_text())
        if not isinstance(data, dict):
            return dict(_DEFAULTS), set()
        merged = {**_DEFAULTS, **data}
        # coerced eagerly: one bad value degrades the whole file
        return dict(eeg_batch=int(merged["eeg_batch"]),
                    eeg_bank=bool(merged["eeg_bank"]),
                    feature_na_max=int(merged["feature_na_max"])), \
            set(_DEFAULTS) & set(data)
    except (OSError, ValueError, TypeError):
        return dict(_DEFAULTS), set()


def _load() -> dict:
    return _read()[0]


_DATA, _FROM_FILE = _read()

EEG_BATCH = int(os.environ.get(_ENV["eeg_batch"], _DATA["eeg_batch"]))
EEG_BANK = (os.environ[_ENV["eeg_bank"]] not in ("", "0", "false")
            if _ENV["eeg_bank"] in os.environ else _DATA["eeg_bank"])
FEATURE_NA_MAX = int(os.environ.get(_ENV["feature_na_max"],
                                    _DATA["feature_na_max"]))
KNOBS = dict(eeg_batch=EEG_BATCH, eeg_bank=EEG_BANK,
             feature_na_max=FEATURE_NA_MAX)

# where each knob in force came from: "env", "file" or "default"
SOURCE = {k: "env" if _ENV[k] in os.environ else
          "file" if k in _FROM_FILE else "default" for k in _DEFAULTS}
