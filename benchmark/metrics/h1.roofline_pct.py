"""h1.roofline_pct: the least time the card could take for the exact H1
diagrams the job needs, over the device time the profiler gives the
kernels that compute them, in percent.

The work is counted from the job (`harness.work.h1_windows`: the distinct
windows and clouds the job's analysis needs, by the benchmark's own window
sampling).  The bound is by bytes: each n x n float32 distance matrix read
once and each diagram's n - 1 H0 deaths written once, at the card's HBM
rate; the H1 bars, whose number the data decides, are left out of the
bytes, so the bound is a lower one.  No operation count: the reduction's
operations depend on the data and need a counter inside the program."""

from benchmark.harness.peaks import H100

KERNELS = ("h1_phase1_kernel", "h1_reduce_kernel")


def read(ctx):
    tr = ctx.get("trace")
    work = ctx.get("h1_windows")
    if not tr or not work:
        return None
    device_s = sum(s for name, s in tr["device_ops"].items()
                   if any(k in name for k in KERNELS))
    if device_s <= 0:
        return None
    nbytes = sum(count * (n * n + n - 1) * 4 for n, count in work.items())
    return 100.0 * nbytes / H100["hbm_bytes_per_s"] / device_s
