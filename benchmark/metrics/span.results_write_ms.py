"""span.results_write_ms: the milliseconds of the port's `results_write` span
(the comparison's and the control's result files) summed over one job run
under `runtime.timed_spans` (each span between two synchronisations of the
card), a job of its own.  Nothing when the job never enters the span."""

SPAN = "results_write"


def read(ctx):
    return ctx.get("spans_ms", {}).get(SPAN)
