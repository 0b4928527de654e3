"""The forward scan's kernels against their bound: the least time the
card needs for the traced slice's keys (``portbench/work.py``: the keygen
over the seeds, then per key the normalize, the scalar multiplication, the
affine conversion and both hash160s, each on its busier pipe at the
published peak) over the device time of the kernels that carry that work,
found by their names."""

KERNELS = ("mt19937_kernel", "keygen_hash_kernel", "normalize_kernel", "smul_kernel",
           "inv_affine_kernel", "hash160_kernel")


def read(rec: dict):
    trace = rec.get("trace")
    if trace is None:
        return None
    t = trace.seconds_of(KERNELS)
    if t <= 0:
        return None
    return 100.0 * rec["derive_bound_s"] / t
