"""Band statistics of the reference, NumPy in float64 over per-subject
differences held in the configuration's float32 (see `_stated`): the two-sided
Wilcoxon signed-rank test (zeros dropped; exact counts for n <= 50 without
ties or zeros, else the normal approximation with the tie correction and no
continuity correction, as scipy.stats.wilcoxon), the sign-flip permutation
p of |mean|, Cohen's d of paired differences, and Benjamini-Hochberg's
adjusted p (statsmodels' fdr_bh).  `comparison` and `control` rebuild the
result dictionaries of tda_eeg_audio_comparison.py:161-221 and
matched_vs_mismatched.py:160-259 from per-recording rows.  Imports nothing
of the program."""

from __future__ import annotations

import functools
import math
from collections import defaultdict

import numpy as np

BAND_NAMES = ("delta", "theta", "alpha", "beta", "gamma")


@functools.lru_cache(maxsize=None)
def _subset_sums(n: int):
    c = [1] + [0] * (n * (n + 1) // 2)
    for i in range(1, n + 1):
        for s in range(len(c) - 1, i - 1, -1):
            c[s] += c[s - i]
    return c


def wilcoxon_p(d) -> float:
    d = np.asarray(d, np.float64)
    had_zeros = bool((d == 0).any())
    d = d[d != 0]
    n = len(d)
    if n < 1:
        return 1.0
    a = np.abs(d)
    order = np.argsort(a, kind="stable")
    ranks = np.empty(n)
    sa = a[order]
    i = 0
    tie_corr = 0.0
    while i < n:
        j = i
        while j + 1 < n and sa[j + 1] == sa[i]:
            j += 1
        ranks[order[i:j + 1]] = (i + j) / 2.0 + 1.0
        t = j - i + 1
        tie_corr += t ** 3 - t
        i = j + 1
    w = min(ranks[d > 0].sum(), ranks[d < 0].sum())
    ties = tie_corr > 0
    if n <= 50 and not ties and not had_zeros:
        c = _subset_sums(n)
        return min(1.0, 2.0 * sum(c[:int(math.floor(w)) + 1]) / 2.0 ** n)
    mn = n * (n + 1) / 4.0
    se = math.sqrt(max(n * (n + 1) * (2 * n + 1) / 24.0 - tie_corr / 48.0, 1e-30))
    z = (w - mn) / se
    return min(1.0, math.erfc(abs(z) / math.sqrt(2.0)))


def cohens_d(d) -> float:
    d = np.asarray(d, np.float64)
    return float(d.mean() / (d.std(ddof=1) + 1e-10))


def sign_flip_p(d, signs) -> float:
    """signs: (n_perm, len(d)) of ±1."""
    d = np.asarray(d, np.float64)
    obs = abs(d.mean())
    return float(((np.abs((signs * d).mean(axis=1)) >= obs).sum() + 1.0)
                 / (signs.shape[0] + 1.0))


def bh_adjust(p):
    p = np.asarray(p, np.float64)
    n = len(p)
    order = np.argsort(p, kind="stable")
    adj = p[order] * n / np.arange(1, n + 1)
    adj = np.minimum.accumulate(adj[::-1])[::-1].clip(0.0, 1.0)
    out = np.empty(n)
    out[order] = adj
    return out


def _stated(deltas):
    """Per-subject differences in the configuration's compute precision,
    float32: the tests' exact-or-normal branch turns on ties among |d|,
    and differences that are equal in exact arithmetic need not be equal
    in float64 after the subject means."""
    return np.asarray(deltas, np.float32).astype(np.float64)


def comparison(rows, signs_by_band):
    """{band: {wass_h0_p, wass_h1_p, corr_p, wass_h1_perm_p,
    wass_h1_cohens_d, wass_h1_slow, wass_h1_fast, wass_h1_p_fdr}} from the
    comparison's detailed rows; signs_by_band[b] is (n_perm, n_max)."""
    per = defaultdict(lambda: defaultdict(list))
    for r in rows:
        per[r["band"]][(r["subject"], r["condition"])].append(r)
    out, p_h1 = {}, []
    for b, band in enumerate(BAND_NAMES):
        means = {key: {k: np.mean([x[f] for x in rs]) for k, f in
                       (("h0", "wasserstein_h0"), ("h1", "wasserstein_h1"),
                        ("corr", "corr_mean_persistence_r"))}
                 for key, rs in per[band].items()}
        subs = sorted({s for (s, c) in means if (s, "slow") in means and (s, "fast") in means})
        res = {}
        if len(subs) >= 5:
            delta = {k: _stated([means[(s, "slow")][k] - means[(s, "fast")][k] for s in subs])
                     for k in ("h0", "h1", "corr")}
            res = dict(wass_h0_p=wilcoxon_p(delta["h0"]), wass_h1_p=wilcoxon_p(delta["h1"]),
                       corr_p=wilcoxon_p(delta["corr"]),
                       wass_h1_perm_p=sign_flip_p(delta["h1"], signs_by_band[b][:, :len(subs)]),
                       wass_h1_cohens_d=cohens_d(delta["h1"]),
                       wass_h1_slow=float(np.mean([means[(s, "slow")]["h1"] for s in subs])),
                       wass_h1_fast=float(np.mean([means[(s, "fast")]["h1"] for s in subs])))
        out[band] = res
        p_h1.append(res.get("wass_h1_p", 1.0))
    for band, p in zip(BAND_NAMES, bh_adjust(p_h1)):
        out[band]["wass_h1_p_fdr"] = float(p)
    return out


def control(rows):
    """{band: {p, cohens_d, w_matched, w_mismatched, p_fdr}} from the
    control's rows (finite pairs, subject means)."""
    per = defaultdict(lambda: defaultdict(list))
    for r in rows:
        if np.isfinite(r["w_matched"]) and np.isfinite(r["w_mismatched"]):
            per[r["band"]][r["subject"]].append(r)
    out, ps = {}, []
    for band in BAND_NAMES:
        sm = {s: (np.mean([x["w_matched"] for x in rs]),
                  np.mean([x["w_mismatched"] for x in rs])) for s, rs in per[band].items()}
        if len(sm) < 5:
            out[band] = {}
            ps.append(1.0)
            continue
        diff = _stated([m - mm for m, mm in sm.values()])
        out[band] = dict(p=wilcoxon_p(diff), cohens_d=cohens_d(diff),
                         w_matched=float(np.mean([m for m, _ in sm.values()])),
                         w_mismatched=float(np.mean([mm for _, mm in sm.values()])))
        ps.append(out[band]["p"])
    for band, p in zip(BAND_NAMES, bh_adjust(ps)):
        if out[band]:
            out[band]["p_fdr"] = float(p)
    return out
