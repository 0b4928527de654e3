"""The distribution layer's cost a round: rank 0's wall time in
``parallel/multihost.all_hosts_any`` (the all-reduce of the found flags,
with the wait for the slowest rank) over its calls in the traced slice."""


def read(rec: dict):
    s = rec.get("spans", {}).get("all_hosts_any")
    if not s or not s["calls"]:
        return None
    return 1e3 * s["seconds"] / s["calls"]
