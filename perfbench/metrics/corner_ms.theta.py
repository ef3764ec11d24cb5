"""Device time a θ step of the factorization's dense corner (the Schur
sum, the corner's potrf, trsm and products, the status fold): the
program's ``factorize.corner`` device spans (their ``dev_us``), summed
over the window and divided by its steps.  None where the program has no
such span, a span lacks its device time, or the registry dropped spans."""


def read(rec):
    tel = rec.get("telemetry", {})
    steps = rec["outcome"].get("steps")
    dev = [s.get("dev_us") for s in tel.get("spans", []) if s["name"] == "factorize.corner"]
    if tel.get("spans_dropped", 0) or not steps or not dev or None in dev:
        return None
    return sum(dev) / steps / 1e3
