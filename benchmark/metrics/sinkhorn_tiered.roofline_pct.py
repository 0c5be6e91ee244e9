"""sinkhorn_tiered.roofline_pct: the least time the card could take for the
tiered Sinkhorn's work in one job, over the device time the profiler gives
its kernels (`sinkhorn_class_kernel*`, `bucket_kernel`), in percent.

The work is the port's counter `sinkhorn_tiered.flop`, counted on the card
from the pairs' masks in the job run under `runtime.timed_spans` (read from
`runtime.last_record()`): 4·S²·STEPS·ITERS a pair, S = n1 + n2 the pair's
own bars (an empty side one), not its tier or class width.  The bound is by
FP32 operations at the card's published rate; the bars read and the one
float written a pair are far below it.  The profiled job and the timed job
are whole jobs over the same store, so their work is the same.  Nothing
when the port has no such counter or the job ran no tiered Sinkhorn."""

from benchmark.harness.peaks import H100

KERNELS = ("sinkhorn_class_kernel", "bucket_kernel")
COUNTER = "sinkhorn_tiered.flop"


def read(ctx):
    from tda_eeg_audio_tpu_torch import runtime

    last = getattr(runtime, "last_record", None)
    record = last() if last else None
    flop = (record or {}).get("counters", {}).get(COUNTER)
    tr = ctx.get("trace")
    if not flop or not tr:
        return None
    device_s = sum(s for name, s in tr["device_ops"].items()
                   if any(k in name for k in KERNELS))
    if device_s <= 0:
        return None
    return 100.0 * flop / H100["fp32_flops_per_s"] / device_s
