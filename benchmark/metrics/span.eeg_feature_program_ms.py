"""span.eeg_feature_program_ms: the milliseconds of the port's
`eeg_feature_program` span (the features program's calls, once a batch)
summed over one job run under `runtime.timed_spans` (each span between two
synchronisations of the card), a job of its own.  Nothing when the job never
enters the span."""

SPAN = "eeg_feature_program"


def read(ctx):
    return ctx.get("spans_ms", {}).get(SPAN)
