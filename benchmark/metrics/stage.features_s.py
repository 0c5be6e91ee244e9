"""stage.features_s: the features stage's seconds (host clock between two
synchronisations of the card), the mean over the traced run's plain jobs,
which run neither the profiler nor the spans.  Nothing when the cell's
jobs have no features stage."""

STAGE = "features"


def read(ctx):
    runs = [r[STAGE] for r in ctx["stage_runs"] if STAGE in r]
    return sum(runs) / len(runs) if runs else None
