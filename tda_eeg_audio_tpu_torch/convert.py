"""Carrying state across from the reference package.

The pipeline has no learned weights: its state is the configuration (the
designed filter taps follow from it deterministically) and its data is the
padded recording batch.  `config_from_jax` rebuilds the port's config from
`dataclasses.asdict` of the reference one; `batch_from_numpy` turns the
numpy arrays the reference programs are fed into device tensors, and
`store_from_numpy` the arrays of a reference device store into the port's,
so both sides compute on identical inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import PipelineConfig
from .runtime import resolve_device


def config_from_jax(fields: dict) -> PipelineConfig:
    """Port PipelineConfig from the reference's field dict.  Unknown fields
    raise, so a config knob the port does not know cannot be dropped."""
    known = {f.name for f in dataclasses.fields(PipelineConfig)}
    extra = set(fields) - known
    if extra:
        raise ValueError(f"config fields unknown to the port: {sorted(extra)}")
    return PipelineConfig(**fields)


def batch_from_numpy(eeg=None, n_e=None, audio=None, n_a=None, use_idx=None,
                     use_mask=None, mis_h1=None, mis_n_win=None,
                     mis_degen=None, device=None) -> dict:
    """numpy batch → tensors on `device` (None = CUDA): float32 waveforms,
    int64 lengths/indices, bool masks; mis_h1 is a (b, d, m) triple.
    Arguments left None are omitted from the result."""
    dev = resolve_device(device)
    kinds = dict(eeg=torch.float32, audio=torch.float32, n_e=torch.int64,
                 n_a=torch.int64, use_idx=torch.int64, use_mask=torch.bool,
                 mis_n_win=torch.int64, mis_degen=torch.bool)
    given = dict(eeg=eeg, n_e=n_e, audio=audio, n_a=n_a, use_idx=use_idx,
                 use_mask=use_mask, mis_n_win=mis_n_win, mis_degen=mis_degen)
    out = {k: torch.as_tensor(np.asarray(v), device=dev, dtype=kinds[k])
           for k, v in given.items() if v is not None}
    if mis_h1 is not None:
        b, d, m = (np.asarray(x) for x in mis_h1)
        out["mis_h1"] = (torch.as_tensor(b, device=dev, dtype=torch.float32),
                         torch.as_tensor(d, device=dev, dtype=torch.float32),
                         torch.as_tensor(m, device=dev, dtype=torch.bool))
    return out


def store_from_numpy(eeg, audio, ns_e, ns_a, metas, index, device=None):
    """The arrays of a reference `DeviceStore` (as numpy: eeg (N, 47, T),
    audio (N, T_a), true lengths, metas, and the dataset's index) → the
    port's store on `device` (None = CUDA), so both runners compute on the
    same recordings."""
    from .io.device_store import DeviceStore

    dev = resolve_device(device)
    return DeviceStore(
        torch.as_tensor(np.array(eeg, np.float32), device=dev),
        torch.as_tensor(np.array(audio, np.float32), device=dev),
        np.asarray(ns_e, np.int64), np.asarray(ns_a, np.int64),
        [dict(m) for m in metas], [tuple(t) for t in index])
