"""span.h1_tiered_sinkhorn_ms: the milliseconds of the port's `h1_tiered_sinkhorn` span summed
over one job run under `runtime.timed_spans` (each span between two
synchronisations of the card), a job of its own.  Nothing when the job
never enters the span."""

SPAN = "h1_tiered_sinkhorn"


def read(ctx):
    return ctx.get("spans_ms", {}).get(SPAN)
