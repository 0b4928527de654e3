"""Reverse sweeps across ranks: ``analyze/sweeps.dispatch_sweep`` under a
world of ``ranks`` processes, one a card, which takes
``parallel/multihost.DistributedSweep``.

The process the benchmark starts is rank 0: it starts ranks 1 .. R-1 as
``python -m portbench.drivers.dsweep`` with the program's ``JAX_*``
variables on a loopback port free at launch, runs its own share, gathers
the others' records and the names of the banned modules each rank's process
holds once the window has closed, prints the result alone, and waits for
every rank to end.  Each rank decides nothing by itself: before each job rank 0
broadcasts whether the window goes on.

Traffic keys: ``ranks``, ``job_seeds`` (a job's seeds, split into the
ranks' shards), ``batch``, ``planted_every`` (every n-th job carries the
cascade of a seed drawn inside it, the others the configuration's),
``planted_strata`` (the planted seeds' offsets in their shard go round
that many equal strata, in an order drawn from the run's seed),
``stop_slack_seeds`` (how far past the planted seed a rank may sweep its
shard before the early stop reaches it), ``jobs`` (how many are drawn),
``warmup_seeds``, ``trace_jobs``.  Configuration keys: ``family``,
``seed_space`` [lo, hi), ``cascade`` ([bits, key] pairs); its reference
gives ``cascade_of``, ``matches`` and ``puzzle_cascade``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np

from ..harness import ROOT, Cell, Outcome, Spans, Trace, banned_modules, load_json, traced


def plan(cell, seed: int) -> list:
    """[(first seed, cascade, the planted seed or None)] from the run's
    seed; the jobs lie whole inside the space."""
    cfg, tr = cell.config, cell.traffic
    rng = np.random.default_rng(seed)
    lo, hi = cfg["seed_space"]
    J = tr["job_seeds"]
    puzzle = cell.reference.puzzle_cascade(cfg)
    widths = [bits for bits, _ in puzzle]
    shard = J // tr["ranks"]
    strata = tr["planted_strata"]
    order = rng.permutation(strata)
    out = []
    for i in range(tr["jobs"]):
        start = lo + int(rng.integers((hi - lo) // J)) * J
        if i % tr["planted_every"] == 0:
            j = int(order[(i // tr["planted_every"]) % strata])
            off = int(rng.integers(shard * j // strata, shard * (j + 1) // strata))
            p = start + int(rng.integers(tr["ranks"])) * shard + off
            out.append((start, cell.reference.cascade_of(p, widths), p))
        else:
            out.append((start, puzzle, None))
    return out


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_env(port: int, ranks: int, rank: int) -> dict:
    env = dict(os.environ)
    env.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", JAX_NUM_PROCESSES=str(ranks),
               JAX_PROCESS_ID=str(rank))
    return env


class _Watch:
    """Ends rank 0 when another rank fails, so that no collective waits for
    it until its timeout."""

    def __init__(self, procs):
        self.procs = procs
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while not self.stop.wait(0.5):
            for p in self.procs:
                if p.poll() not in (None, 0):
                    print(f"portbench: rank process {p.args[-1]} exited with {p.returncode}",
                          file=sys.stderr, flush=True)
                    for q in self.procs:
                        if q.poll() is None:
                            q.kill()
                    os._exit(2)

    def close(self):
        self.stop.set()
        self.thread.join()


def run(cell, args, env) -> Outcome:
    """Rank 0: start the other ranks, run this rank's share, wait for all."""
    R = cell.traffic["ranks"]
    port = _free_port()
    argv = [sys.executable, "-m", "portbench.drivers.dsweep", "--workload", cell.name,
            "--seed", str(args.seed), "--seconds", str(args.seconds),
            "--trace", str(int(args.trace)), "--device", env.device.type,
            "--overrides", json.dumps(env.overrides), "--patch", env.patch or ""]
    procs = [subprocess.Popen(argv + ["--rank", str(r)], cwd=ROOT, env=_rank_env(port, R, r),
                              stdout=sys.stderr, stdin=subprocess.DEVNULL)
             for r in range(1, R)]
    env.mark(f"ranks 1 .. {R - 1} started (their marks count from here)")
    os.environ.update({k: v for k, v in _rank_env(port, R, 0).items()
                       if k.startswith("JAX_")})
    watch = _Watch(procs)
    try:
        out = rank_main(cell, args, env, 0)
    finally:
        watch.close()
        for p in procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        raise RuntimeError(f"rank processes exited with {codes}")
    return out


def rank_main(cell, args, env, rank: int):
    import torch
    import torch.distributed as dist
    from vuke_tpu_torch import kernels
    from vuke_tpu_torch.analyze import sweeps
    from vuke_tpu_torch.parallel import multihost

    cfg, tr = cell.config, cell.traffic
    cell.load_reference()
    multihost.maybe_initialize_distributed()
    env.mark(f"rank {rank} joined")
    R = multihost.process_count()
    dev = env.device if env.device.type == "cpu" else torch.device("cuda", rank)
    if dev.type == "cuda":
        # one build for every rank: rank 0 first, the others load it
        if rank == 0:
            kernels.library()
        dist.barrier()
        kernels.library()
        env.mark(f"rank {rank} kernel library loaded")
    jobs = plan(cell, args.seed)
    J, B = tr["job_seeds"], tr["batch"]

    def sweep(start, n, cascade):
        prog = sweeps.SweepProgram(cfg["family"], "cascade", cascade=cascade, batch=B,
                                   track_first_filter=True, device=str(dev))
        return sweeps.dispatch_sweep(prog, start, start + n - 1)

    def go(flag: bool) -> bool:
        with torch.profiler.record_function("pb:go"):
            t = torch.tensor([int(flag)], dtype=torch.int32)
            dist.broadcast(t, src=0)
            return bool(t.item())

    # the warm-up: a planted job's cascade over its first seeds
    w = next(j for j in jobs if j[2] is not None)
    sweep(w[0], tr["warmup_seeds"], w[1])
    env.sync()
    env.mark(f"rank {rank} warmed up")
    dist.barrier()

    done = []                       # (job index, found, seed, this rank's searched)
    spans = Spans()
    t_start = time.perf_counter()
    setup_s = t_start - env.t0
    i = 0

    def one():
        nonlocal i
        start, cascade, _ = jobs[i % len(jobs)]
        r = sweep(start, J, cascade)
        done.append((i % len(jobs), r.found, r.seed, r.searched))
        i += 1

    # every rank's profiler runs before any rank's window opens
    with traced(args.trace, dev, ready=dist.barrier) as holder:
        if args.trace:
            spans.wrap(multihost, "all_hosts_any", "all_hosts_any")
            spans.wrap(multihost, "gather_results", "gather_results")
            spans.wrap(sweeps, "sweep", "round")
            spans.wrap(sweeps.SweepProgram, "__init__", "SweepProgram")
        try:
            while go(rank == 0 and i < tr["trace_jobs"]) if args.trace else i < 1:
                one()
        finally:
            spans.restore()
    traced_jobs = i
    while go(rank == 0 and time.perf_counter() - t_start < args.seconds):
        one()
    window = time.perf_counter() - t_start
    peak = env.memory_peak()
    env.free()
    # each rank looks at its own process: rank 0 prints no result where
    # any rank has loaded JAX or the JAX package
    mine = {"done": done, "peak": peak, "banned": banned_modules(),
            "trace": holder[0].to_dict() if args.trace else None}
    every = [None] * R
    dist.all_gather_object(every, mine)
    dist.destroy_process_group()
    if rank != 0:
        return None
    found = [f"rank {r}: {', '.join(e['banned'])}" for r, e in enumerate(every) if e["banned"]]
    if found:
        print(f"portbench: loaded in a rank's process: {'; '.join(found)}", file=sys.stderr,
              flush=True)
        raise SystemExit(3)
    return _outcome(cell, args, env, jobs, every, window, setup_s, spans, traced_jobs)


def _outcome(cell, args, env, jobs, every, window, setup_s, spans, traced_jobs) -> Outcome:
    """The comparison, on rank 0: each job's verdict on every rank against
    the planted seed or none, and each rank's searched count against its
    shard: the whole shard without a planted seed; with one, at least up to
    it on its rank and no more than ``stop_slack_seeds`` past its offset on
    any rank (the early stop reached them all)."""
    tr = cell.traffic
    R, J, slack = len(every), tr["job_seeds"], tr["stop_slack_seeds"]
    shard = J // R
    wrong = stop_late = short = failed = 0
    needed = []
    for n, (k, *_rest) in enumerate(every[0]["done"]):
        start, cascade, p = jobs[k]
        rows = [e["done"][n] for e in every]
        before = wrong + short + stop_late
        if p is None:
            wrong += sum(found or seed is not None for _, found, seed, _ in rows)
            short += sum(abs(shard - searched) for *_, searched in rows)
            needed.append(J)
        else:
            h, o = divmod(p - start, shard)
            wrong += sum(not found or seed != p for _, found, seed, _ in rows)
            short += max(0, o + 1 - rows[h][3])
            stop_late += sum(max(0, searched - min(shard, o + slack))
                             for *_, searched in rows)
            needed.append(R * (o + 1))
        failed += wrong + short + stop_late > before
    checks = [("verdicts_wrong", wrong, 0, "max"), ("seeds_short", short, 0, "max"),
              ("seeds_past_stop", stop_late, 0, "max"),
              ("planted_due", sum(jobs[k][2] is not None for k, *_ in every[0]["done"]), 1,
               "min")]
    e2e = {"setup_s": setup_s, "cascade_seeds_per_s": sum(needed) / window}
    record, breakdown = {}, None
    if args.trace:
        trace = Trace.merge([Trace.from_dict(e["trace"]) for e in every])
        record = {"trace": trace, "spans": spans.summary(), "jobs": traced_jobs,
                  "sweep": {"family": cell.config["family"], "mode": "cascade",
                            "seeds_per_chip": sum(needed[:traced_jobs]) / R}}
        breakdown = trace.breakdown()
    env.log(f"jobs {len(needed)} ({traced_jobs} traced) on {R} ranks, window {window:.3f} s")
    return Outcome(len(needed), failed, checks, e2e, record,
                   env.device_info([e["peak"] for e in every], chips=R), breakdown=breakdown)


def _rank_cli():
    from .. import run as runner

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--overrides", default="{}")
    ap.add_argument("--patch", default="")
    ap.add_argument("--rank", type=int, required=True)
    a = ap.parse_args()
    cell = Cell.load(load_json(ROOT / "BENCHMARK.json"), a.workload)
    env = runner.Env(a.device, json.loads(a.overrides), a.patch or None)
    env.apply(cell)
    rank_main(cell, a, env, a.rank)


if __name__ == "__main__":
    _rank_cli()
