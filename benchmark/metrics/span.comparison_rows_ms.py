"""span.comparison_rows_ms: the milliseconds of the port's `comparison_rows`
span (the fused comparison's one read-back and its rows) summed over one job
run under `runtime.timed_spans` (each span between two synchronisations of
the card), a job of its own.  Nothing when the job never enters the span."""

SPAN = "comparison_rows"


def read(ctx):
    return ctx.get("spans_ms", {}).get(SPAN)
