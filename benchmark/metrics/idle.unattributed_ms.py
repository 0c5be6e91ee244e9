"""idle.unattributed_ms: the milliseconds of the traced job's labelled idle
gaps (the card idle, labelled by the innermost host range each began in)
that no part of a stage explains: those labelled by a harness range
(`stage.*`, `benchmark.profiled_job`, none at all: `host`) or by one of the
port's three stage spans (`features`, `comparison`, `control`) outside
every span of their parts.  A guard that new host work comes with a span."""

HARNESS = ("benchmark.profiled_job", "host")
STAGES = ("features", "comparison", "control")


def read(ctx):
    tr = ctx.get("trace")
    if not tr:
        return None
    return 1e3 * sum(s for label, s in tr["idle_gaps"]
                     if label.startswith("stage.") or label in HARNESS + STAGES)
