"""Runtime services of the port: telemetry (``runtime/telemetry.py``) and
fault injection (``runtime/fault_tolerance.py``)."""
