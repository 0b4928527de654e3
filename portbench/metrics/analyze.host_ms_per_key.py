"""A key audit's host time: the wall time of the traced keys'
``analyze`` calls, less the device's busy time in the slice, a key."""


def read(rec: dict):
    s = rec.get("spans", {}).get("analyze")
    trace = rec.get("trace")
    if not s or not s["calls"] or trace is None or trace.busy_s <= 0:
        return None
    return 1e3 * (s["seconds"] - trace.busy_s) / s["calls"]
