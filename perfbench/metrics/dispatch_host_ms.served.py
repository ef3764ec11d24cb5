"""Mean host time of ``RungExecutor.dispatch`` a batch: the program's
``serving.dispatch`` spans (host clock)."""


def read(rec):
    d = [s["dur_us"] for s in rec.get("telemetry", {}).get("spans", [])
         if s["name"] == "serving.dispatch"]
    return sum(d) / len(d) / 1e3 if d else None
