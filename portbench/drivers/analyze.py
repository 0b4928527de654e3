"""Key audits: one client in a closed loop, each key through the
configuration's analyzer as ``analyze KEY --analyzer NAME`` runs it.

Traffic keys: ``planted_every`` (every n-th key comes from a seed drawn
from the run's seed; the others are uniform random keys, which no seed
makes, so their sweep covers the whole space), ``planted_strata`` (the
planted seeds go round that many equal strata of the space, in an order
drawn from the run's seed, so that every seed's window holds about the
same sweep lengths), ``batch`` (the sweep's
batch), ``keys`` (how many keys are drawn; the loop goes round them if the
window needs more), ``trace_keys`` (the keys the traced slice covers).
Configuration keys: ``analyzer``, ``analyze_mode`` ("exact"),
``seed_space`` [lo, hi); its reference gives ``audit_key(seed)``.
"""

from __future__ import annotations

import re
import time

import numpy as np

from ..harness import Outcome, Spans, percentile, traced


def plan(cell, seed: int) -> list:
    """[(key, the seed that made it or None)] from the run's seed."""
    cfg, tr = cell.config, cell.traffic
    rng = np.random.default_rng(seed)
    lo, hi = cfg["seed_space"]
    strata = tr["planted_strata"]
    order = rng.permutation(strata)
    out = []
    for i in range(tr["keys"]):
        if i % tr["planted_every"] == 0:
            j = int(order[(i // tr["planted_every"]) % strata])
            a, b = lo + (hi - lo) * j // strata, lo + (hi - lo) * (j + 1) // strata
            s = int(rng.integers(a, b))
            out.append((cell.reference.audit_key(s), s))
        else:
            out.append((rng.bytes(32), None))
    return out


def verdict(result) -> tuple:
    """(found, seed or None, seeds checked or None) of an ``AnalysisResult``."""
    found = result.status.value == "confirmed"
    m = re.search(r"seed = (\d+)", result.details or "") if found else None
    c = re.search(r"checked (\d+) seeds", result.details or "")
    return found, int(m.group(1)) if m else None, int(c.group(1)) if c else None


def run(cell, args, env) -> Outcome:
    from vuke_tpu_torch import kernels
    from vuke_tpu_torch.analyze import analyzer_from_str
    from vuke_tpu_torch.analyze.analyzers import AnalysisConfig

    cfg, tr = cell.config, cell.traffic
    cell.load_reference()
    dev = env.device
    if dev.type == "cuda":
        kernels.library()
    keys = plan(cell, args.seed)
    lo, hi = cfg["seed_space"]
    analyzer = analyzer_from_str(cfg["analyzer"])
    # max_seeds: only the tests bound the space, as --max-seeds does
    config = AnalysisConfig(batch=tr["batch"], device=str(dev), max_seeds=cfg.get("max_seeds"))
    # the warm-up: a key whose seed lies in the first batch
    analyzer.analyze(cell.reference.audit_key(lo + tr["batch"] // 2), config)
    env.sync()

    done = []                                   # (index, result, seconds)
    spans = Spans()
    t_start = time.perf_counter()
    setup_s = t_start - env.t0
    i = 0

    def one():
        nonlocal i
        key, _ = keys[i % len(keys)]
        t0 = time.perf_counter()
        r = analyzer.analyze(key, config)
        done.append((i % len(keys), r, time.perf_counter() - t0))
        i += 1

    with traced(args.trace, dev) as holder:
        if args.trace:
            spans.wrap(type(analyzer), "analyze", "analyze")
        try:
            while i < (tr["trace_keys"] if args.trace else 1):
                one()
        finally:
            spans.restore()
    traced_keys = i
    while time.perf_counter() - t_start < args.seconds:
        one()
    window = time.perf_counter() - t_start
    peak = env.memory_peak()
    env.free()

    # the comparison: each verdict against the seed that made the key, or
    # none; a key no seed made is checked over the whole space
    wrong = 0
    needed = []
    for k, r, _ in done:
        found, seed, checked = verdict(r)
        s = keys[k][1]
        if s is None:
            wrong += found or checked != hi - lo
            needed.append(hi - lo)
        else:
            wrong += not found or seed != s
            needed.append(s - lo + 1)
    lat = [t for _, _, t in done]
    checks = [("verdicts_wrong", wrong, 0, "max"),
              ("planted_due", sum(keys[k][1] is not None for k, _, _ in done), 1, "min")]
    e2e = {"setup_s": setup_s, "analyze_seeds_per_s": sum(needed) / window,
           "analyze_key_p90_s": percentile(lat, 90)}
    record, breakdown = {}, None
    if args.trace:
        trace = holder[0]
        record = {"trace": trace, "spans": spans.summary(), "keys": traced_keys,
                  "sweep": {"family": cfg["analyzer"], "mode": cfg["analyze_mode"],
                            "seeds_per_chip": sum(needed[:traced_keys])}}
        breakdown = trace.breakdown()
    env.log(f"keys {len(done)} ({traced_keys} traced), window {window:.3f} s, "
            f"median {percentile(lat, 50):.4f} s")
    full = [t for k, _, t in done if keys[k][1] is None]
    if full:
        env.log("whole-space keys: " + ", ".join(
            f"p{q} {percentile(full, q):.5f}" for q in (0, 25, 50, 75, 90, 100))
            + f" s of {len(full)}; all keys p90 {percentile(lat, 90):.5f} s")
    return Outcome(len(done), wrong, checks, e2e, record, env.device_info([peak]),
                   samples={"analyze_key_p90_s": len(lat)}, breakdown=breakdown)
