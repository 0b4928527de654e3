"""Forward scans: ``ForwardDriver.run_range`` jobs in a closed loop against
a seeded target list with planted hits.

Traffic keys: ``job_seeds`` (a job's consecutive seeds), ``batch`` (the
superbatch), ``planted`` (targets planted one a job in the first jobs of
the window, at most one a job range of the space, so as many as a window
reaches: their address forms in turn, their slots in turn after every
form), ``warmup_seeds`` (the warm-up runs job 0's first seeds, where job
0's target lies, so that the host confirm of a hit is warm too),
``trace_jobs`` (the jobs the traced slice covers).  Configuration keys: ``transform``,
``slots``, ``seed_space`` [lo, hi), ``targets``, ``p2pkh_share`` and, for
the decimal keygens, ``decimal_digits``; its reference gives ``keys(seed)``.

Jobs start on whole multiples of ``job_seeds`` from ``lo``, the first drawn
from the seed, and wrap inside the space.  The target list holds
``targets`` addresses: the planted ones, whose addresses the reference
derives, and seeded random ones, held as their 8-byte fragments (their
strings are never formed: the host confirm rejects any device candidate
that is not a planted address, as it would a random address's).
"""

from __future__ import annotations

import time

import numpy as np

from ..harness import Outcome, Spans, traced
from ..reference.address import FORMS, addresses
from .. import work


def _fragment(h160: bytes) -> int:
    return int.from_bytes(h160[:8], "big", signed=True)


def plan(cell, seed: int) -> dict:
    """The run's inputs from its seed: the jobs' first seeds, the planted
    targets and the random fragments."""
    cfg, tr = cell.config, cell.traffic
    rng = np.random.default_rng(seed)
    lo, hi = cfg["seed_space"]
    J = tr["job_seeds"]
    n_jobs = (hi - lo) // J
    k0 = int(rng.integers(n_jobs))
    planted = []
    for i in range(min(tr["planted"], n_jobs)):
        span = tr["warmup_seeds"] if i == 0 else J
        s = lo + ((k0 + i) % n_jobs) * J + int(rng.integers(span))
        slot = (i // len(FORMS)) % cfg["slots"]
        form = FORMS[i % len(FORMS)]
        addr, h160 = addresses(cell.reference.keys(s)[slot])[form]
        planted.append({"job": i, "seed": s, "slot": slot, "form": form, "address": addr,
                        "fragment": _fragment(h160)})
    n = cfg["targets"]
    n_p2pkh = int(n * cfg["p2pkh_share"]) - sum(p["form"] != "p2wpkh" for p in planted)
    rand = rng.integers(-(1 << 63), (1 << 63) - 1, size=n - len(planted), dtype=np.int64,
                        endpoint=True)
    pk = np.array([p["fragment"] for p in planted if p["form"] != "p2wpkh"], dtype=np.int64)
    pw = np.array([p["fragment"] for p in planted if p["form"] == "p2wpkh"], dtype=np.int64)
    comp = np.concatenate([rand, pk, pw])
    uncomp = np.concatenate([rand[:n_p2pkh], pk])
    return {"lo": lo, "J": J, "n_jobs": n_jobs, "k0": k0, "planted": planted,
            "comp": comp, "uncomp": uncomp}


def job_start(p: dict, i: int) -> int:
    return p["lo"] + ((p["k0"] + i) % p["n_jobs"]) * p["J"]


def run(cell, args, env) -> Outcome:
    from vuke_tpu_torch import kernels, pipeline
    from vuke_tpu_torch.matcher import TargetPools
    from vuke_tpu_torch.transforms import parse_transform

    cfg, tr = cell.config, cell.traffic
    cell.load_reference()
    dev = env.device
    if dev.type == "cuda":
        kernels.library()
    env.mark("kernel library loaded")
    p = plan(cell, args.seed)
    env.mark("inputs drawn")
    pools = TargetPools(p["comp"], p["uncomp"], frozenset(x["address"] for x in p["planted"]))
    del p["comp"], p["uncomp"]
    driver = pipeline.ForwardDriver([parse_transform(cfg["transform"])], pools,
                                    batch=tr["batch"], device=dev)
    env.mark("target pools built")
    # the warm-up: job 0's first seeds, with its hit
    w0 = job_start(p, 0)
    driver.run_range(w0, w0 + tr["warmup_seeds"] - 1)
    env.sync()
    env.mark("warmed up")

    J, slots = p["J"], cfg["slots"]
    jobs = []
    spans = Spans()
    t_start = time.perf_counter()
    setup_s = t_start - env.t0
    i = 0
    with traced(args.trace, dev) as holder:
        if args.trace:
            spans.wrap(pipeline.ScanProgram, "run", "ScanProgram.run")
            spans.wrap(pipeline._Pending, "tolist", "stats.wait")
            spans.wrap(TargetPools, "lookup", "matcher")
            spans.wrap(pipeline.ForwardDriver, "_confirm", "confirm")
        try:
            while i < (tr["trace_jobs"] if args.trace else 1):
                s = job_start(p, i)
                jobs.append((s, driver.run_range(s, s + J - 1)))
                i += 1
        finally:
            spans.restore()
    traced_seeds = i * J
    t_traced = time.perf_counter()
    while time.perf_counter() - t_start < args.seconds:
        s = job_start(p, i)
        jobs.append((s, driver.run_range(s, s + J - 1)))
        i += 1
    window = time.perf_counter() - t_start
    peak = env.memory_peak()
    del driver, pools
    env.free()

    # the comparison: each job's confirmed hits against the planted
    # targets in its range, and its keys against seeds x slots
    missed = extra = short = failed = 0
    due = 0
    for s, r in jobs:
        want = {(x["seed"], x["form"], x["address"]) for x in p["planted"]
                if s <= x["seed"] < s + J}
        got = {(h.seed, h.address_type, h.address) for h in r.hits}
        due += len(want)
        missed += len(want - got)
        extra += len(got - want) + (len(r.hits) - len(got))
        short += abs(J * slots - r.keys_generated) + abs(J - r.inputs_processed)
        failed += bool(want != got or r.keys_generated != J * slots)
    checks = [("planted_missed", missed, 0, "max"), ("hits_not_planted", extra, 0, "max"),
              ("keys_short", short, 0, "max"), ("planted_due", due, 1, "min")]
    e2e = {"setup_s": setup_s, "scan_keys_per_s": len(jobs) * J * slots / window}
    record = {}
    breakdown = None
    if args.trace:
        trace = holder[0]
        keygen = (work.mt19937() if cfg["transform"] == "milksad"
                  else work.keygen_hash(cfg["transform"], cfg["decimal_digits"]))
        record = {"trace": trace, "spans": spans.summary(), "seeds": traced_seeds,
                  "superbatches": traced_seeds // tr["batch"],
                  "derive_bound_s": work.derive_seconds(keygen, traced_seeds, slots)}
        breakdown = trace.breakdown()
    env.log(f"jobs {len(jobs)} ({traced_seeds} seeds traced in "
            f"{t_traced - t_start:.3f} s), window {window:.3f} s, planted due {due}")
    return Outcome(len(jobs), failed, checks, e2e, record, env.device_info([peak]),
                   breakdown=breakdown)
