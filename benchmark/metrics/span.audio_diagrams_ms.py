"""span.audio_diagrams_ms: the milliseconds of the port's `audio_diagrams` span summed
over one job run under `runtime.timed_spans` (each span between two
synchronisations of the card), a job of its own.  Nothing when the job
never enters the span."""

SPAN = "audio_diagrams"


def read(ctx):
    return ctx.get("spans_ms", {}).get(SPAN)
