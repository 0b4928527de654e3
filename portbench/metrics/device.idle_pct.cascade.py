"""The share of the traced slice of a cascade sweep across ranks in which
no operation ran on a card, averaged over the cards."""


def read(rec: dict):
    trace = rec.get("trace")
    if trace is None or trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
