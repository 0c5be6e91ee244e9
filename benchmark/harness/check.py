"""`correct`: the last job of the window held to the reference.

Each number compared is the widest gap between what the program produced
and what `benchmark/reference` works out again from the same inputs, as a
share of the reference's own size (the larger of the entry's magnitude and
the median magnitude of that quantity over the sample, so that a quantity
near 0 does not blow up the share):

* `x_gap`: the 220-feature rows of `features` recordings drawn from the
  seed, each entry against the nearer of two references: every bar with
  death > birth, and the bars of persistence above the float32
  resolution of the distances (`RESOLUTION`).  A bar shorter than that is
  a tie in the configuration's float32 and may show or not: it moves a
  bar count by 1 and the features that average over the bars.  The other
  way round, two edges a float32 step apart in the program's distances
  and in the other order in float64 give the program a bar of 1-3 float32
  steps that no reference has; the limit allows one such bar;
* `w_h0_gap`, `w_h1_gap`, `w_mis_gap`: the comparison's per-band W_H0,
  W_H1 and mismatched W_H1 of the recordings of `comparison_sample`;
* `control_gap`: the control's rows of those recordings and of
  `control_redone` recordings drawn from those whose window counts make the
  control redo them exactly;
* `stats_gap`: the band statistics (Wilcoxon, sign-flip, Cohen's d,
  BH-FDR, means) of the comparison and of the control, worked out again
  from the rows the program computed them from.

`precision` "bfloat16" puts the reference, computed in bfloat16, in the
program's place: the control of the check."""

from __future__ import annotations

import numpy as np
import torch

from ..reference import stats as RS
from ..reference.study import BAND_NAMES, Study


# persistence below which a bar is a tie in float32 distances of O(1)
# (their rounding ~1e-7, amplified ~10x through the correlation)
RESOLUTION = 1e-5


def draw(seed: int, pool, k: int):
    rng = np.random.default_rng(int(seed) % (1 << 63))
    pool = list(pool)
    return [pool[i] for i in sorted(rng.choice(len(pool), size=min(k, len(pool)),
                                                replace=False))]


def comparison_sample(ref: Study, seed: int, n_subjects: int, n_redone: int):
    """(recordings, redone) the comparison's check holds to the reference.

    `redone`: recordings drawn from the control's deviants.  The recordings
    come from `n_subjects` subjects, the first a deviant's where there is
    one, the second from the other half of the subject order's pairs (a
    batch of an even size holds two neighbouring subjects, one in each
    half): of each, its first slow and first fast recording, which are each
    other's mismatch partners, and one more, of the other parity of
    position than the last subject's.  A partner is then, as a rule, also a
    recording of the sample (a deviant's too), and the reference works out
    the audio diagrams of one recording for both.  Deviants are left out of
    the recordings."""
    index = ref.st["index"]
    rng = np.random.default_rng((int(seed) + 1) % (1 << 63))
    deviants = ref.deviants()
    skip = set(deviants)
    redone = draw(seed + 2, deviants, n_redone)
    subjects = list(dict.fromkeys(s for _, s, _ in index))
    chosen = list(dict.fromkeys(index[i][1] for i in redone))[:n_subjects]
    while len(chosen) < min(n_subjects, len(subjects)):
        rest = [s for s in subjects if s not in chosen]
        if len(chosen) == 1:
            half = subjects.index(chosen[0]) % 2
            rest = [s for s in rest if subjects.index(s) % 2 != half] or rest
        chosen.append(rest[int(rng.integers(len(rest)))])
    recs, parity = [], None
    for subj in chosen:
        firsts = [ref._first[(subj, c)] for c in ("slow", "fast") if (subj, c) in ref._first]
        recs += [i for i in firsts if i not in skip]
        rest = [i for i, (_, s, _) in enumerate(index)
                if s == subj and i not in skip and i not in firsts]
        if parity is not None:
            rest = [i for i in rest if i % 2 != parity] or rest
        if rest:
            recs.append(rest[int(rng.integers(len(rest)))])
            parity = recs[-1] % 2
    return sorted(recs), redone


def _gap(prog, ref):
    prog = np.asarray(prog, np.float64)
    ref = np.asarray(ref, np.float64)
    both_nan = np.isnan(prog) & np.isnan(ref)
    mag = np.abs(ref)
    med = float(np.nanmedian(mag)) if np.isfinite(mag).any() else 0.0
    scale = np.maximum(mag, med)
    with np.errstate(divide="ignore", invalid="ignore"):
        g = np.abs(prog - ref) / np.where(scale > 0, scale, 1.0)
    g = np.where(both_nan, 0.0, np.where(np.isnan(g), np.inf, g))
    return float(g.max()) if g.size else 0.0


def _col_gap(prog, refs):
    """Row-by-column gap with one scale a column (its largest magnitude,
    or the median column's, whichever is larger), each entry against the
    nearest of the references."""
    prog = np.asarray(prog, np.float64)
    col = np.abs(np.asarray(refs[0], np.float64)).max(axis=0)
    scale = np.maximum(col, np.median(col))
    g = np.min([np.abs(prog - np.asarray(r, np.float64)) for r in refs], axis=0)
    g = g / np.where(scale > 0, scale, 1.0)
    return float(np.nan_to_num(g, nan=np.inf).max())


def _sign_draws(n_perm: int, n_max: int, device):
    """The configuration's sign flips: random_state 42 on the device the
    statistics run on, drawn as one (n_perm, 5, n_max) block of ±1."""
    gen = torch.Generator(device=device)
    gen.manual_seed(42)
    s = torch.randint(0, 2, (n_perm, len(BAND_NAMES), n_max), generator=gen, device=device)
    return (2 * s - 1).to(torch.float64).cpu().numpy()


def _stats_numbers(prog_out, rows, ref_fn, keys, precision):
    """(got, want, names) of the statistics: the program's (or, for the
    control, the reference's on rows and results rounded to bfloat16)
    against the reference's on the program's rows."""
    ref = ref_fn(rows)
    if precision != "float64":
        def q(v):
            return float(torch.tensor(v, dtype=torch.float64).to(torch.bfloat16))

        low = ref_fn([{k: (q(v) if isinstance(v, float) else v) for k, v in r.items()}
                      for r in rows])
        prog_out = {b: {k: q(v) for k, v in low[b].items()} for b in low}
    got, want, names = [], [], []
    for band in BAND_NAMES:
        for k in keys:
            if k in ref[band] and k in prog_out[band]:
                p = prog_out[band][k]
                got.append(p)
                want.append(ref[band][k])
                names.append(f"{band}.{k}")
    return got, want, names


def check(study: dict, pipeline: dict, compare: dict, outputs: dict, seed: int,
          precision: str = "float64", reference: Study | None = None):
    """{number: value} and the recordings drawn.  `outputs` holds what the
    last job of the window returned: "X" with "X_keys" [(filename,
    condition)], "comparison" (run_comparison's dict), "control"
    (run_control's dict) and "control_rows" (the rows its statistics were
    computed from); a stage the job does not run is absent.  With
    precision "bfloat16" the reference at that precision stands in for the
    program (the control)."""
    ref = reference or Study(study, pipeline)
    low = Study(study, pipeline, precision) if precision != "float64" else None
    index = study["index"]
    numbers, drawn = {}, {}

    if "X" in outputs:
        recs = draw(seed, range(len(index)), compare["features"])
        K = ref.feature_K()
        want = [ref.feature_rows(recs, K, r).cpu().numpy() for r in (0.0, RESOLUTION)]
        if low is None:
            row_of = {k: r for r, k in enumerate(outputs["X_keys"])}
            got = np.stack([outputs["X"][row_of[(index[i][0], index[i][2])]] for i in recs])
        else:
            got = low.feature_rows(recs, K).cpu().numpy()
        numbers["x_gap"] = _col_gap(got, want)
        drawn["features"] = recs

    if "comparison" in outputs:
        recs, dev = comparison_sample(ref, seed, compare["comparison_subjects"],
                                      compare["control_redone"])
        want = ref.comparison_rows(recs, redone=dev)
        if low is None:
            rows = {(r["filename"], r["condition"], r["band"]): r
                    for r in outputs["comparison"]["detailed_rows"]}
            got = {i: np.array([[rows[(index[i][0], index[i][2], b)][k]
                                 for k in ("wasserstein_h0", "wasserstein_h1", "w_mismatched")]
                                for b in BAND_NAMES]) for i in recs}
        else:
            got = low.comparison_rows(recs, redone=dev)
        for c, name in enumerate(("w_h0_gap", "w_h1_gap", "w_mis_gap")):
            numbers[name] = _gap([got[i][:, c] for i in recs], [want[i][:, c] for i in recs])
        drawn["comparison"] = recs

        want_c = {i: want[i][:, 1:] for i in recs}
        want_c.update(ref.control_rows(dev))
        if low is None:
            crow = {(r["filename"], r["condition"], r["band"]): r
                    for r in outputs["control_rows"]}
            got_c = {i: np.array([[crow[(index[i][0], index[i][2], b)][k]
                                   for k in ("w_matched", "w_mismatched")]
                                  for b in BAND_NAMES]) for i in want_c}
        else:
            got_c = {i: got[i][:, 1:] for i in recs}
            got_c.update(low.control_rows(dev))
        numbers["control_gap"] = _gap([got_c[i] for i in want_c], [want_c[i] for i in want_c])
        drawn["control_redone"] = dev

        n_max = max(1, len({r["subject"] for r in outputs["comparison"]["detailed_rows"]}))
        signs = _sign_draws(compare["n_permutations"], n_max,
                           study["eeg"].device).transpose(1, 0, 2)
        g1, w1, n1 = _stats_numbers(
            outputs["comparison"]["band_results"], outputs["comparison"]["detailed_rows"],
            lambda rows: RS.comparison(rows, signs), (
                "wass_h0_p", "wass_h1_p", "corr_p", "wass_h1_perm_p", "wass_h1_cohens_d",
                "wass_h1_slow", "wass_h1_fast", "wass_h1_p_fdr"), precision)
        g2, w2, n2 = _stats_numbers(outputs["control"], outputs["control_rows"], RS.control,
                                ("p", "cohens_d", "w_matched", "w_mismatched", "p_fdr"),
                                precision)
        numbers["stats_gap"] = _gap(g1 + g2, w1 + w2)
        each = [_gap([a], [b]) for a, b in zip(g1 + g2, w1 + w2)]
        k = int(np.argmax(each))
        drawn["stats_worst"] = [(["comparison"] * len(n1) + ["control"] * len(n2))[k],
                                (n1 + n2)[k], (g1 + g2)[k], (w1 + w2)[k]]
    return numbers, drawn
