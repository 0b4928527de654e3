"""The share of the traced slice of a key audit in which no operation ran
on the card."""


def read(rec: dict):
    trace = rec.get("trace")
    if trace is None or trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
