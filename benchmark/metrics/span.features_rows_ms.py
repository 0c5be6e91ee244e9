"""span.features_rows_ms: the milliseconds of the port's `features_rows` span
(the features stage's one read-back, its exact redo and its rows) summed
over one job run under `runtime.timed_spans` (each span between two
synchronisations of the card), a job of its own.  Nothing when the job never
enters the span."""

SPAN = "features_rows"


def read(ctx):
    return ctx.get("spans_ms", {}).get(SPAN)
