"""Statistics of the study (counterpart of the reference's `ops/stats.py`):
average ranks, Spearman correlation with its two-sided Student-t p-value,
the Wilcoxon signed-rank test, Benjamini–Hochberg FDR, the sign-flip
permutation p-value, paired Cohen's d and the percentile bootstrap CI.

The two randomized statistics take their draws explicitly (`signs`, `idx`)
or make them from a `torch.Generator`: the reference draws from its own
counter-based streams, which no torch generator reproduces, so a parity
test draws once and feeds both sides the same numbers."""

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


def _t_sf(t, df, nu_max: int):
    """Student-t survival function P(T > t) for integer degrees of freedom,
    by the closed-form series (Abramowitz & Stegun 26.7.3-4) in float64:
    with θ = atan(t/√ν), P(|T| < t) is 2/π·(θ + sinθ·cosθ·Σ) for odd ν and
    sinθ·Σ for even ν, Σ a finite series in cos²θ.  Exact where the
    regularized incomplete beta of the reference is; df here is n − 2.

    nu_max: a bound on every df, known without reading df (the caller's
    static sizes), so the series' length costs no host synchronisation;
    the terms past an entry's own ν add exact zeros."""
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
    for k in range(1, nu_max // 2 + 1):
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
    p = (2.0 * _t_sf(t.abs(), df, max(x.shape[-1] - 2, 1))).clamp(0.0, 1.0)
    return r, p


def _norm_sf(z):
    """Standard normal survival function."""
    return 0.5 * torch.erfc(z / math.sqrt(2.0))


def _wilcoxon_exact_counts(n_max: int) -> torch.Tensor:
    """(n_max + 1, max_sum + 1) float64 table: row n holds, per sum k, the
    number of subsets of {1..n} with that sum (the null distribution of W+
    without ties).  Counts stay below 2^53 for n ≤ 53 and the p-value only
    needs them to float32 precision beyond that."""
    max_sum = n_max * (n_max + 1) // 2
    c = torch.zeros(max_sum + 1, dtype=torch.float64)
    c[0] = 1.0
    rows = [c]
    for i in range(1, n_max + 1):
        nxt = c.clone()
        nxt[i:] += c[:-i]
        c = nxt
        rows.append(c)
    return torch.stack(rows)


def wilcoxon(d, valid=None, n_max: int = 64):
    """Two-sided Wilcoxon signed-rank test along the last axis.

    d: (..., n) paired differences; valid: mask.  Returns (W, p), mirroring
    scipy.stats.wilcoxon(d): zeros dropped; the exact null distribution
    when n ≤ 50 with no ties among |d| and no zeros, else the normal
    approximation with tie correction and no continuity correction.

    The exact branch counts subset sums in float64 (the reference runs the
    same recurrence in float32, where counts above 2^24 round): the result
    is at least as close to scipy's and within 1e-6 relative of the
    reference's."""
    if valid is None:
        valid = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    nz = valid & (d != 0.0)
    n = nz.sum(dim=-1)
    absd = d.abs()
    ranks = torch.where(nz, _rankdata_avg(absd, nz), 0.0)
    w_plus = torch.where(d > 0, ranks, 0.0).sum(dim=-1)
    w_minus = torch.where(d < 0, ranks, 0.0).sum(dim=-1)
    W = torch.minimum(w_plus, w_minus)

    big = torch.finfo(d.dtype).max
    a_sorted = torch.sort(torch.where(nz, absd, big), dim=-1).values
    eq = (a_sorted[..., 1:] == a_sorted[..., :-1]) & (a_sorted[..., 1:] < big)
    ties = eq.any(dim=-1)
    had_zeros = (valid & (d == 0.0)).any(dim=-1)

    nf = n.to(d.dtype)
    mn = nf * (nf + 1.0) * 0.25
    se2 = nf * (nf + 1.0) * (2.0 * nf + 1.0) / 24.0
    # tie correction Σ (t³ − t) over runs of equal |d|: each sorted element's
    # run length from the run's first and last index
    L = a_sorted.shape[-1]
    idx = torch.arange(L, device=d.device).expand(a_sorted.shape)
    false = torch.zeros_like(eq[..., :1])
    eq_prev = torch.cat([false, eq], dim=-1)
    eq_next = torch.cat([eq, false], dim=-1)
    run_start = torch.cummax(torch.where(eq_prev, -1, idx), dim=-1).values
    run_end = torch.cummin(torch.where(eq_next, L, idx).flip(-1),
                           dim=-1).values.flip(-1)
    t = (run_end - run_start + 1).to(d.dtype)
    tie_corr = torch.where(~eq_prev & (t > 1), t ** 3 - t, 0.0).sum(dim=-1)
    se = torch.sqrt(torch.clamp(se2 - tie_corr / 48.0, min=1e-30))
    z = (W - mn) / se
    p_norm = (2.0 * _norm_sf(z.abs())).clamp(0.0, 1.0)

    counts = _wilcoxon_exact_counts(n_max).to(d.device)
    ks = torch.arange(counts.shape[1], device=d.device)
    c = counts[n.clamp(max=n_max)]                              # (..., S)
    cdf = torch.where(ks <= W[..., None], c, 0.0).sum(dim=-1) / \
        torch.pow(torch.tensor(2.0, dtype=torch.float64, device=d.device),
                  n.to(torch.float64))
    p_exact = (2.0 * cdf).clamp(0.0, 1.0).to(d.dtype)
    use_exact = (n <= 50) & ~ties & ~had_zeros
    p = torch.where(use_exact, p_exact, p_norm)
    return W, torch.where(n < 1, 1.0, p)


def bh_fdr(pvals, alpha: float = 0.05):
    """Benjamini–Hochberg step-up (statsmodels multipletests 'fdr_bh')
    along the last axis.  Returns (reject, p_adjusted).  The sort is stable,
    so tied p-values keep their order as in the reference."""
    n = pvals.shape[-1]
    order = torch.argsort(pvals, dim=-1, stable=True)
    ps = pvals.gather(-1, order)
    ranks = torch.arange(1, n + 1, dtype=pvals.dtype, device=pvals.device)
    adj = ps * n / ranks
    adj = torch.cummin(adj.flip(-1), dim=-1).values.flip(-1).clamp(0.0, 1.0)
    below = ps <= ranks / n * alpha
    kmax = torch.where(below, ranks, 0.0).amax(dim=-1, keepdim=True)
    rej_sorted = ranks <= kmax
    inv = torch.argsort(order, dim=-1)
    return rej_sorted.gather(-1, inv), adj.gather(-1, inv)


def sign_flip_pvalue(d, valid, n_perm: int = 1000, *, signs=None,
                     generator=None):
    """Sign-flip permutation p for |mean(d)| along the last axis.

    signs: (n_perm, *d.shape) of ±1, or None to draw them from `generator`
    (a `torch.Generator` on d's device; required then)."""
    if signs is None:
        if generator is None:
            raise ValueError("sign_flip_pvalue needs signs or a generator")
        signs = torch.randint(0, 2, (n_perm,) + tuple(d.shape),
                              generator=generator, device=d.device)
        signs = (2 * signs - 1).to(d.dtype)
    else:
        signs = torch.as_tensor(signs, device=d.device, dtype=d.dtype)
        n_perm = signs.shape[0]
    nf = torch.clamp(valid.sum(dim=-1), min=1)
    obs = (torch.where(valid, d, 0.0).sum(dim=-1) / nf).abs()
    pm = (torch.where(valid, d * signs, 0.0).sum(dim=-1) / nf).abs()
    exceed = (pm >= obs).sum(dim=0)
    return (exceed + 1.0) / (n_perm + 1.0)


def cohens_d_paired(d, valid):
    """mean(d) / (sample std(d, ddof=1) + 1e-10) along the last axis."""
    nf = valid.sum(dim=-1)
    mu = torch.where(valid, d, 0.0).sum(dim=-1) / torch.clamp(nf, min=1)
    var = torch.where(valid, (d - mu[..., None]) ** 2, 0.0).sum(dim=-1) / \
        torch.clamp(nf - 1, min=1)
    return mu / (torch.sqrt(var) + 1e-10)


def bootstrap_mean_ci(values, n_boot: int = 1000, lo_pct: float = 2.5,
                      hi_pct: float = 97.5, *, idx=None, generator=None):
    """Percentile bootstrap CI of the mean over the last axis.

    idx: (n_boot, n) resampling indices, or None to draw them from
    `generator`.  Returns (boots (..., n_boot), lo, hi), percentiles by
    linear interpolation as numpy's default."""
    n = values.shape[-1]
    if idx is None:
        if generator is None:
            raise ValueError("bootstrap_mean_ci needs idx or a generator")
        idx = torch.randint(0, n, (n_boot, n), generator=generator,
                            device=values.device)
    idx = torch.as_tensor(idx, device=values.device).long()
    boots = values[..., idx].mean(dim=-1)
    q = torch.tensor([lo_pct / 100.0, hi_pct / 100.0], dtype=boots.dtype,
                     device=boots.device)
    lo, hi = torch.quantile(boots, q, dim=-1)
    return boots, lo, hi
