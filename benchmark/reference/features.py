"""The 11 features of a persistence diagram and their mean / std over a
recording's windows (the reference's `extract_features` and
`create_dataset`, scripts/utils.py:144-177 and
tda_eeg_classification_v2.py:407-436): finite bars only, population std,
normalised entropy, an empty diagram all zeros but its essential count.
Plain PyTorch in the caller's dtype; imports nothing of the program."""

from __future__ import annotations

import torch

N_FEATURES = 11


def diagram_features(births, deaths, mask, n_essential):
    """(..., K) padded diagrams → (..., 11): n_features, n_essential,
    mean / std birth, mean / std death, mean / std persistence, max
    persistence, total persistence, persistence entropy."""
    m = mask.to(births.dtype)
    n = m.sum(dim=-1)
    nz = n.clamp(min=1.0)
    b = torch.where(mask, births, 0.0)
    d = torch.where(mask, deaths, 0.0)
    pers = d - b

    def mean(x):
        return (x * m).sum(dim=-1) / nz

    def std(x):
        var = (m * (x - mean(x)[..., None]) ** 2).sum(dim=-1) / nz
        return torch.where(n > 1, torch.sqrt(var.clamp(min=0.0)), 0.0)

    total = (pers * m).sum(dim=-1)
    mx = torch.where(mask, pers, -torch.inf).amax(dim=-1)
    mx = torch.where(n > 0, mx, 0.0)
    p = pers / torch.where(total > 0, total, 1.0)[..., None]
    plog = torch.where(mask & (p > 0), p * torch.log(p + 1e-10), 0.0)
    ent = -plog.sum(dim=-1) / torch.log(nz + 1e-10)
    ent = torch.where((n > 1) & (total > 0), ent, 0.0)
    f = torch.stack([n, n_essential.to(births.dtype), mean(b), std(b), mean(d),
                     std(d), mean(pers), std(pers), mx, total, ent], dim=-1)
    keep = torch.arange(N_FEATURES, device=f.device) == 1
    return torch.where((n == 0)[..., None] & ~keep, 0.0, f)


def window_features(dg, resolution: float = 0.0):
    """(B, 2, 11) H0 / H1 features of the windows in `persistence.diagrams`'s
    output: H0 bars (0, death) with the components left at the threshold as
    its essential count; H1 finite bars, the essential ones counted.  Bars
    whose persistence is at most `resolution` are left out (0: every bar
    with death > birth, as ripser reports them)."""
    n = dg["h0_deaths"].shape[-1] + 1
    n_comp = n - dg["n_tree"]
    h0_mask = dg["h0_mask"] & (dg["h0_deaths"] > resolution)
    h0 = diagram_features(torch.zeros_like(dg["h0_deaths"]),
                          torch.where(h0_mask, dg["h0_deaths"], 0.0),
                          h0_mask, n_comp)
    fin = dg["mask"] & torch.isfinite(dg["deaths"]) & \
        ((dg["deaths"] - dg["births"]) > resolution)
    h1 = diagram_features(dg["births"], torch.where(fin, dg["deaths"], 0.0),
                          fin, dg["n_essential"])
    return torch.stack([h0, h1], dim=-2)


def mean_std(x):
    """(..., W, F) → (..., F, 2) [mean, population std] over the windows."""
    mu = x.mean(dim=-2)
    sd = torch.sqrt(((x - mu[..., None, :]) ** 2).mean(dim=-2).clamp(min=0.0))
    return torch.stack([mu, sd], dim=-1)


def feature_row(agg):
    """(5, 2, 11, 2) [band, H0 / H1, feature, mean / std] → the 220 columns
    in the reference's order: feature-major within a band, H0 / H1
    interleaved, mean / std innermost."""
    return agg.permute(0, 2, 1, 3).reshape(-1)
