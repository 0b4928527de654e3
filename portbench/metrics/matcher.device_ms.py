"""The matcher's device time a superbatch: the device time of the
operations launched inside ``matcher.TargetPools.lookup`` (packing the
fragments, ``searchsorted``, the clamp, the gather and the compare, both
pools, every slot), from the traced slice."""


def read(rec: dict):
    trace = rec.get("trace")
    s = trace.under.get("matcher", 0.0) if trace is not None else 0.0
    if s <= 0 or not rec.get("superbatches"):
        return None
    return 1e3 * s / rec["superbatches"]
