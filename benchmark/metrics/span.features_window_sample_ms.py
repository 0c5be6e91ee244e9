"""span.features_window_sample_ms: the milliseconds of the port's
`features_window_sample` span (the host's md5 window sample, once a batch)
summed over one job run under `runtime.timed_spans` (each span between two
synchronisations of the card), a job of its own.  Nothing when the job never
enters the span."""

SPAN = "features_window_sample"


def read(ctx):
    return ctx.get("spans_ms", {}).get(SPAN)
