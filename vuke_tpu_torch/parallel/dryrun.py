"""A dry run of the port across N processes: one scan step and one
early-stop sweep, each rank on its card (or on the CPU).

    python -m vuke_tpu_torch.parallel.dryrun N [--device cuda|cpu] [--timeout S]

The counterpart of ``__graft_entry__.dryrun_multichip``.  The command
starts N ranks of a gloo world (``parallel/multihost.py``) through the JAX
package's environment names on a free local port; rank r runs on
``cuda:{r % device_count}``, so on one card every rank shares it.  The
ranks run two steps:

1. a scan step: milksad over 32·N seeds from seed 1, each rank its own 32
   (K1 -> K3 -> K4 -> K2 through ``ecc/tiled.derive_hash160s_tiled``),
   matched against the two addresses of the JAX dry run; the hit count is
   summed over the ranks and must be 0;
2. a ``DistributedSweep`` (S1) over 4·32·N seeds at a batch of 32 and
   ``round_batches=2``, with the key of seed ``space // 2 + 3`` as its
   target: every rank must return that seed.

Rank 0 prints a line after each step, flushed, then one JSON line: the
hits, the found seed, each rank's searched count and the kernels' launches
summed over the ranks.  The whole run has a wall-clock limit (``--timeout``,
default 300 s): past it every rank is killed and the command exits 124.
Any rank that fails fails the command.

The JAX dry run's third step, the tiled Pallas pipeline under
``shard_map`` in interpret mode, has no counterpart: each rank runs the
same kernels as one process does.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist

# the JAX dry run's targets (__graft_entry__.py:84-87)
TARGETS = ("1JwSSubhmg6iPtRjtyqhUYYH7bZg3Lfy1T",            # derive.rs golden vector
           "bc1qw508d6qejxtdg4y5r3zarvary0c5xw7kv8f3t4")   # BIP173 test vector
PER_RANK = 32
TIMEOUT_S = 300.0


def _say(msg: str) -> None:
    print(msg, flush=True)


def scan_step(rank: int, dev: torch.device) -> int:
    """Step 1: this rank's 32 seeds derived and matched; the hits of every
    rank, summed."""
    from ..ecc.tiled import derive_hash160s_tiled
    from ..matcher import TargetPools

    first = 1 + rank * PER_RANK
    seeds = torch.arange(first, first + PER_RANK, dtype=torch.int64).to(torch.uint32).to(dev)
    d = derive_hash160s_tiled(seeds)
    hits = torch.tensor([int(TargetPools.from_addresses(TARGETS)
                             .lookup(d["frag_c"], d["frag_u"]).sum())])
    dist.all_reduce(hits)
    return int(hits.item())


def sweep_step(world: int, dev: torch.device):
    """Step 2: (space, planted seed, found seed, this rank's searched)."""
    from ..analyze.sweeps import SweepProgram
    from ..cores.mt19937 import milksad_key_words_plain
    from .multihost import DistributedSweep

    space = 4 * PER_RANK * world
    seed = space // 2 + 3
    words = milksad_key_words_plain(torch.tensor([seed], dtype=torch.uint32))[:, 0].tolist()
    prog = SweepProgram("milksad", "exact", batch=PER_RANK, device=dev)
    found, searched = DistributedSweep(prog, round_batches=2).run(0, space - 1,
                                                                 target_words=words)
    return space, seed, found, searched


def worker(n: int, device: str) -> int:
    """One rank: join the world, run both steps, rank 0 reports."""
    from .._device import run_device
    from ..kernels import Kernel
    from .multihost import gather_results, maybe_initialize_distributed

    t0 = time.perf_counter()
    rank, world = maybe_initialize_distributed()
    if world != n:
        raise RuntimeError(f"dryrun: joined a world of {world}, expected {n}")
    dev = run_device(device)
    hits = scan_step(rank, dev)
    if rank == 0:
        _say(f"[dryrun 1/2] scan step: milksad seeds [1, {PER_RANK * world}] over {world} "
             f"ranks ({PER_RANK} a rank) on {dev}: hits {hits} "
             f"({time.perf_counter() - t0:.2f} s)")
    if hits != 0:
        raise AssertionError(f"unexpected hits in dry run: {hits}")
    space, seed, found, searched = sweep_step(world, dev)
    if found != seed:
        raise AssertionError(f"DistributedSweep missed planted seed {seed}: {found}")
    report = gather_results([{"searched": searched,
                              "launches": {name: k.launches
                                           for name, k in Kernel.registry.items()}}])
    if rank == 0:
        _say(f"[dryrun 2/2] DistributedSweep over [0, {space - 1}] (batch {PER_RANK}, "
             f"round_batches 2): found planted seed {found}, searched "
             f"{[r['searched'] for r in report]} ({time.perf_counter() - t0:.2f} s)")
        launches = {name: sum(r["launches"][name] for r in report)
                    for name in report[0]["launches"]}
        _say(json.dumps({"dryrun": "ok", "ranks": world, "device": dev.type,
                         "batch": PER_RANK * world, "hits": hits, "found": found,
                         "searched": [r["searched"] for r in report],
                         "launches": launches,
                         "seconds": time.perf_counter() - t0}))
    dist.destroy_process_group()
    return 0


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(n: int, device: str, timeout: float = TIMEOUT_S) -> int:
    """Start the ranks and wait for them under the wall-clock limit: 0 when
    every rank passed, 124 past the limit, 1 when a rank failed."""
    port = free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES=str(n), JAX_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "vuke_tpu_torch.parallel.dryrun", str(n),
             "--device", device, "--worker"], env=env))
    deadline = time.monotonic() + timeout
    try:
        rcs = [p.wait(timeout=max(deadline - time.monotonic(), 0.0)) for p in procs]
    except subprocess.TimeoutExpired:
        print(f"dryrun: past the wall-clock limit of {timeout:.0f} s; ranks killed",
              file=sys.stderr, flush=True)
        return 124
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [r for r, rc in enumerate(rcs) if rc != 0]
    if failed:
        print(f"dryrun: ranks {failed} failed (exit codes {[rcs[r] for r in failed]})",
              file=sys.stderr, flush=True)
        return 1
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m vuke_tpu_torch.parallel.dryrun")
    p.add_argument("n", type=int, help="ranks to start")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (each rank on its card, the kernels) or cpu (the plain versions)")
    p.add_argument("--timeout", type=float, default=TIMEOUT_S,
                   help=f"wall-clock limit of the whole run in seconds (default {TIMEOUT_S:.0f})")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.n < 1:
        p.error("N must be at least 1")
    if args.worker:
        return worker(args.n, args.device)
    return run(args.n, args.device, args.timeout)


if __name__ == "__main__":
    sys.exit(main())
