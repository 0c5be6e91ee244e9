"""Homology execution with the exact redo of overflowed windows.

Backends of `run_tda`:
  * "auto" / "device" — the diagrams of a batch of distance matrices come
    from `programs.h1_diagrams_routed` (the CUDA kernel for CUDA tensors,
    the plain reduction for CPU tensors); every window the reduction
    flagged — creator arena, step budget or bar count exceeded — is then
    recomputed on the host engine (`native/engine.py`), which has no such
    limits, and scattered back.  The flags are read back once per call;
    nothing else leaves the device unless a window overflowed.
  * "host" — every window on the host engine (the reference's staged
    parity path); the diagrams come back to the matrices' device.

Both produce the same padded diagram dict and the 11-feature tensors."""

from __future__ import annotations

import torch

from ..native.engine import rips_persistence_batch
from ..ops.features import diagram_features

_KEYS = ("births", "deaths", "mask", "h0_deaths", "h0_mask", "n_essential",
         "n_tree")


def _features_from(out, n: int, n_pts=None):
    """Padded diagrams → the (B, 2, 11) H0/H1 features, with the reference's
    degenerate-cloud sentinel: a window of fewer than 3 valid points gets the
    single (0, 0) bar in both dimensions and no essential class.

    out: dict of tensors births/deaths/mask (B, K), h0_deaths/h0_mask
    (B, n − 1), n_essential, n_tree (B,).  Returns the dict with the sentinel
    applied, h0_deaths made finite, plus fin_mask, n_comp and features."""
    births = out["births"]
    dev = births.device
    B = births.shape[0]
    if n_pts is None:
        n_pts = torch.full((B,), n, dtype=torch.int32, device=dev)
    n_pts = torch.as_tensor(n_pts, device=dev)
    degenerate = (n_pts < 3)[:, None]
    n_comp = torch.where(degenerate[:, 0], 0,
                         n_pts - out["n_tree"]).to(torch.int32)
    h0_deaths = torch.where(torch.isfinite(out["h0_deaths"]), out["h0_deaths"], 0.0)
    first0 = torch.arange(h0_deaths.shape[1], device=dev)[None, :] == 0
    h0_deaths = torch.where(degenerate, 0.0, h0_deaths)
    h0_mask = torch.where(degenerate, first0, out["h0_mask"])
    f_h0 = diagram_features(torch.zeros_like(h0_deaths), h0_deaths, h0_mask, n_comp)

    first1 = torch.arange(births.shape[1], device=dev)[None, :] == 0
    births = torch.where(degenerate, 0.0, births)
    deaths = torch.where(degenerate, 0.0, out["deaths"])
    h1_mask = torch.where(degenerate, first1, out["mask"])
    n_ess = torch.where(degenerate[:, 0], 0, out["n_essential"])
    fin = h1_mask & torch.isfinite(deaths)
    f_h1 = diagram_features(births, torch.where(fin, deaths, 0.0), fin, n_ess)
    return dict(births=births, deaths=deaths, mask=h1_mask, fin_mask=fin,
                h0_deaths=h0_deaths, h0_mask=h0_mask, n_comp=n_comp,
                n_essential=n_ess,
                features=torch.stack([f_h0, f_h1], dim=1))


BACKENDS = ("auto", "device", "host")


def run_tda(dms: torch.Tensor, thresh: float, n_pts=None, na_max: int = 96,
            step_budget: int = 4096, verbose: bool = False,
            backend: str = "auto") -> dict:
    """Exact H0 + H1 diagrams and features of (N, n, n) distance matrices on
    their device; overflowed windows are redone on the host engine.

    Returns `_features_from`'s dict plus `redone` (N,) bool, the windows that
    were recomputed.  `run_tda.redone` counts them over the process (the
    host backend computes every window there and redoes none)."""
    from .programs import h1_diagrams_routed

    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    N, n, _ = dms.shape
    dev = dms.device
    if n_pts is not None:
        n_pts = torch.as_tensor(n_pts, device=dev)
    if backend == "host":
        host = rips_persistence_batch(dms.detach().cpu().numpy(), thresh=thresh,
                                      max_bars=max(na_max, 128))
        out = {k: torch.as_tensor(host[k], device=dev) for k in _KEYS}
        res = _features_from(out, n, n_pts)
        res["redone"] = torch.zeros(N, dtype=torch.bool, device=dev)
        return res
    out = h1_diagrams_routed(dms, n_pts, n=n, thresh=thresh, na_max=na_max,
                             h1_max=na_max, step_budget=step_budget)
    out = {k: out[k] for k in _KEYS + ("overflow",)}
    flagged = out.pop("overflow")
    bad = torch.nonzero(flagged).squeeze(1)         # the call's one read-back
    if bad.numel():
        if verbose:
            print(f"  homology: {bad.numel()} overflow windows → host engine")
        K = out["births"].shape[1]
        host = rips_persistence_batch(dms[bad].cpu().numpy(), thresh=thresh,
                                      max_bars=max(K, 256))
        # keep the device path's column count (a window with more than K
        # visible bars keeps its first K)
        host["births"], host["deaths"], host["mask"] = (
            host[k][:, :K] for k in ("births", "deaths", "mask"))
        for k in _KEYS:
            out[k] = out[k].clone()
            out[k][bad] = torch.as_tensor(host[k], device=dev).to(out[k].dtype)
        run_tda.redone += int(bad.numel())
    res = _features_from(out, n, n_pts)
    res["redone"] = flagged
    return res


run_tda.redone = 0
