"""span.eeg_window_distances_ms: the milliseconds of the port's
`eeg_window_distances` span (the step from the banded signal to the
selected windows' correlation distances inside the features program, once a
batch, and in the features stage's overflow redo) summed over one job run
under `runtime.timed_spans` (each span between two synchronisations of the
card), a job of its own.  Nothing when the job never enters the span, as
in a port that has no such span."""

SPAN = "eeg_window_distances"


def read(ctx):
    return ctx.get("spans_ms", {}).get(SPAN)
