"""The reverse sweep's kernel against its bound: the least time the card
needs for the seeds the traced slice's verdicts needed (``portbench/
work.py``'s sweep count for the family and compare, at the published
peak), a card, over the device time of the sweep kernel, a card."""

from portbench import work

KERNELS = ("sweep_prng_kernel",)


def read(rec: dict):
    trace, sw = rec.get("trace"), rec.get("sweep")
    if trace is None or not sw:
        return None
    t = trace.seconds_of(KERNELS)
    if t <= 0:
        return None
    reach = (1.0, 0.0)          # a lane whose first compare passes is one in 2^32 or fewer
    ops = work.sweep_prng(sw["family"], sw["mode"], reach)
    return 100.0 * ops.seconds(sw["seeds_per_chip"]) / t
