"""dispatch.host_waits: how many times the comparison's batch loop (the
port's span `comparison_dispatch`) made the host wait for the card in one
job run under `runtime.timed_spans`: the port's counter
`comparison_dispatch.host_waits`, read from `runtime.last_record()`, which
counts the implicit synchronisations `torch.cuda.set_sync_debug_mode`
reports inside the loop (blocking uploads, `.item()`), not the timed spans'
own.  0 when the host enqueues the whole loop ahead of the card.  Nothing
when the port has no such counter."""

COUNTER = "comparison_dispatch.host_waits"


def read(ctx):
    from tda_eeg_audio_tpu_torch import runtime

    last = getattr(runtime, "last_record", None)
    record = last() if last else None
    value = (record or {}).get("counters", {}).get(COUNTER)
    return None if value is None else float(value)
