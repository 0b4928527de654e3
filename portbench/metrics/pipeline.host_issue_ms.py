"""The scan loop's host time a superbatch: the seconds the host spends in
``pipeline.ScanProgram.run`` (launching a superbatch of every slot) over
its calls in the traced slice, from the harness's span around it."""


def read(rec: dict):
    s = rec.get("spans", {}).get("ScanProgram.run")
    if not s or not s["calls"]:
        return None
    return 1e3 * s["seconds"] / s["calls"]
