"""Host time a θ step in the entry points' preparation before their first
launch (checks, stacking, the cache entry, the panels' reshapes, the
bucket's padding): the program's ``factorize.prepare``, ``solve.prepare``
and ``selinv.prepare`` spans (host clock), summed over the window and
divided by its steps.  None where the program has no such span or the
registry dropped spans."""

NAMES = ("factorize.prepare", "solve.prepare", "selinv.prepare")


def read(rec):
    tel = rec.get("telemetry", {})
    steps = rec["outcome"].get("steps")
    dur = [s["dur_us"] for s in tel.get("spans", []) if s["name"] in NAMES]
    if tel.get("spans_dropped", 0) or not steps or not dur:
        return None
    return sum(dur) / steps / 1e3
