"""span.band_stats_ms: the milliseconds of the port's `band_stats` span (the
comparison's band statistics) summed over one job run under
`runtime.timed_spans` (each span between two synchronisations of the card),
a job of its own.  Nothing when the job never enters the span."""

SPAN = "band_stats"


def read(ctx):
    return ctx.get("spans_ms", {}).get(SPAN)
