"""span.mismatch_cache_ms: the milliseconds of the port's `mismatch_cache` span
(the mismatch partners' audio H1 diagrams and their read-back) summed over
one job run under `runtime.timed_spans` (each span between two
synchronisations of the card), a job of its own.  Nothing when the job never
enters the span."""

SPAN = "mismatch_cache"


def read(ctx):
    return ctx.get("spans_ms", {}).get(SPAN)
