"""device.idle_pct: the share of one job's wall time, under the profiler,
in which no kernel, copy or memset ran on the card (the union of their
intervals, so that overlapping operations count once).  The profiler slows
the host, so the share is read under it."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
