"""Mean host time of ``SelectedInverse.diagonal``, the variances' gather
(its index built on the host and uploaded each call): the program's
``selinv.diagonal`` spans (host clock).  None where the program has no
such span or the registry dropped spans."""


def read(rec):
    tel = rec.get("telemetry", {})
    dur = [s["dur_us"] for s in tel.get("spans", []) if s["name"] == "selinv.diagonal"]
    if tel.get("spans_dropped", 0) or not dur:
        return None
    return sum(dur) / len(dur) / 1e3
