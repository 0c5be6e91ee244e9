"""Statistics of the comparison stage (counterpart of the reference's
`ops/stats.py`, slice subset): average ranks and Spearman correlation with
its two-sided Student-t p-value.  Wilcoxon, BH-FDR, sign-flip, Cohen's d
and the bootstrap CI are not ported yet."""

from __future__ import annotations

import math

import torch


def _rankdata_avg(x, valid=None):
    """Average ranks (1-based) along the last axis, scipy rankdata-style.
    Invalid entries are pushed to the end; callers mask them downstream."""
    n = x.shape[-1]
    dev = x.device
    if valid is not None:
        x = torch.where(valid, x, torch.finfo(x.dtype).max)
    order = torch.argsort(x, dim=-1, stable=True)
    inv = torch.argsort(order, dim=-1)
    xs = x.gather(-1, order)
    idx = torch.arange(n, device=dev).expand_as(xs)
    false = torch.zeros_like(xs[..., :1], dtype=torch.bool)
    eq_prev = torch.cat([false, xs[..., 1:] == xs[..., :-1]], dim=-1)
    eq_next = torch.cat([xs[..., :-1] == xs[..., 1:], false], dim=-1)
    run_start = torch.cummax(torch.where(eq_prev, -1, idx), dim=-1).values
    run_end = torch.cummin(torch.where(eq_next, n, idx).flip(-1),
                           dim=-1).values.flip(-1)
    avg_rank_sorted = (run_start + run_end) / 2.0 + 1.0
    return avg_rank_sorted.gather(-1, inv).to(x.dtype)


def _t_sf(t, df):
    """Student-t survival function P(T > t) for integer degrees of freedom,
    by the closed-form series (Abramowitz & Stegun 26.7.3-4) in float64:
    with θ = atan(t/√ν), P(|T| < t) is 2/π·(θ + sinθ·cosθ·Σ) for odd ν and
    sinθ·Σ for even ν, Σ a finite series in cos²θ.  Exact where the
    regularized incomplete beta of the reference is; df here is n − 2."""
    t64 = t.to(torch.float64)
    nu = torch.round(df.to(torch.float64))
    th = torch.atan(t64.abs() / torch.sqrt(nu))
    s, c = torch.sin(th), torch.cos(th)
    c2 = c * c
    odd = torch.remainder(nu, 2) == 1
    term = torch.ones_like(t64)
    acc = torch.ones_like(t64)
    # odd: Σ = 1 + (2/3)c² + (2·4)/(3·5)c⁴ + ... up to c^{ν−3}
    # even: Σ = 1 + (1/2)c² + (1·3)/(2·4)c⁴ + ... up to c^{ν−2}
    k_max = int(nu.max().item()) if nu.numel() else 0
    for k in range(1, k_max // 2 + 1):
        num = torch.where(odd, 2.0 * k, 2.0 * k - 1.0)
        den = torch.where(odd, 2.0 * k + 1.0, 2.0 * k)
        term = term * c2 * num / den
        last = torch.where(odd, nu - 3.0, nu - 2.0)      # highest power of c
        acc = acc + torch.where(2.0 * k <= last, term, 0.0)
    a_odd = torch.where(nu == 1, 2.0 * th / math.pi,
                        2.0 / math.pi * (th + s * c * acc))
    a = torch.where(odd, a_odd, s * acc)
    p = 0.5 * (1.0 - a)
    return torch.where(t64 >= 0, p, 1.0 - p).to(t.dtype)


def spearmanr(x, y, valid=None):
    """Spearman correlation + two-sided p along the last axis (scipy-style:
    average ranks, Pearson on ranks, t-test with df = n − 2)."""
    if valid is None:
        valid = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    n = valid.sum(dim=-1).to(x.dtype)
    rx = torch.where(valid, _rankdata_avg(x, valid), 0.0)
    ry = torch.where(valid, _rankdata_avg(y, valid), 0.0)
    mx = rx.sum(dim=-1, keepdim=True) / n[..., None]
    my = ry.sum(dim=-1, keepdim=True) / n[..., None]
    dx = torch.where(valid, rx - mx, 0.0)
    dy = torch.where(valid, ry - my, 0.0)
    num = (dx * dy).sum(dim=-1)
    den = torch.sqrt((dx * dx).sum(dim=-1) * (dy * dy).sum(dim=-1))
    r = torch.where(den > 0, num / den, 0.0).clamp(-1.0, 1.0)
    df = torch.clamp(n - 2.0, min=1.0)
    t = r * torch.sqrt(df / torch.clamp(1.0 - r * r, min=1e-12))
    p = (2.0 * _t_sf(t.abs(), df)).clamp(0.0, 1.0)
    return r, p
