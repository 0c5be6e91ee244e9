"""Persistence-diagram scalar features over padded (birth, death, mask)
tensors (counterpart of the reference's `ops/features.py`; reference
scripts/utils.py:144-177 semantics: finite bars only, population std,
normalized entropy, empty diagram → zeros except n_essential)."""

from __future__ import annotations

import torch

from ..config import DIAGRAM_FEATURES

N_FEATURES = len(DIAGRAM_FEATURES)  # 11


def diagram_features(births: torch.Tensor, deaths: torch.Tensor, mask: torch.Tensor,
                     n_essential: torch.Tensor) -> torch.Tensor:
    """(..., K) padded diagrams → (..., 11) features, order = DIAGRAM_FEATURES.
    Computed in float64 and rounded once to the input's dtype: a float32 sum
    over the arena's K columns rounds by K on a card (the reduction's order
    follows the width), so `feature_na_max` moved the features by an ULP and
    a Spearman rank over near-tied windows with them."""
    dtype = births.dtype
    births, deaths = births.double(), deaths.double()
    m = mask.to(births.dtype)
    n = m.sum(dim=-1)
    nz = torch.clamp(n, min=1.0)
    zero = torch.zeros_like(births)
    b = torch.where(mask, births, zero)
    d = torch.where(mask, deaths, zero)
    pers = d - b

    def mean_(x):
        return (x * m).sum(dim=-1) / nz

    def std_(x):
        mu = mean_(x)
        var = (m * (x - mu[..., None]) ** 2).sum(dim=-1) / nz
        return torch.where(n > 1, torch.sqrt(torch.clamp(var, min=0.0)),
                           torch.zeros_like(var))

    total_pers = (pers * m).sum(dim=-1)
    max_pers = torch.where(mask, pers, torch.full_like(pers, -3.4e38)).amax(dim=-1)
    max_pers = torch.where(n > 0, max_pers, torch.zeros_like(max_pers))

    tp = total_pers[..., None]
    p = pers / torch.where(tp > 0, tp, torch.ones_like(tp))
    plog = torch.where(mask & (p > 0), p * torch.log(p + 1e-10), torch.zeros_like(p))
    ent = -plog.sum(dim=-1) / torch.log(nz + 1e-10)
    ent = torch.where((n > 1) & (total_pers > 0), ent, torch.zeros_like(ent))

    feats = torch.stack([
        n, n_essential.to(births.dtype),
        mean_(b), std_(b),
        mean_(d), std_(d),
        mean_(pers), std_(pers),
        max_pers, total_pers,
        ent,
    ], dim=-1)
    empty = (n == 0.0)[..., None]
    keep_col = torch.arange(N_FEATURES, device=births.device) == 1
    return torch.where(empty & ~keep_col, torch.zeros_like(feats), feats).to(dtype)


def aggregate_mean_std(x: torch.Tensor, wmask: torch.Tensor) -> torch.Tensor:
    """(..., W, F) per-window features, (..., W) mask → (..., F, 2)
    [mean, population std] (reference tda_eeg_classification_v2.py:429-436)."""
    m = wmask[..., None].to(x.dtype)
    n = torch.clamp(m.sum(dim=-2), min=1.0)
    mu = (x * m).sum(dim=-2) / n
    var = (m * (x - mu[..., None, :]) ** 2).sum(dim=-2) / n
    sd = torch.sqrt(torch.clamp(var, min=0.0))
    return torch.stack([mu, sd], dim=-1)
