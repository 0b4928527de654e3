"""Runs across processes and cards: static seed-space partitioning and the
early-stop protocol of a brute-force sweep, on ``torch.distributed``.

The port of ``vuke_tpu/parallel/multihost.py``.  Rank h of H owns the
contiguous shard [lo + h*S/H, lo + (h+1)*S/H) of a seed range, the
remainder going to the leading shards, so ownership is a pure function of
(range, H, h): no work is stolen or rebalanced, and a killed job resumes
from its per-rank checkpoint (``parallel/checkpoint.py``).

The collective backend is gloo, on the CPU and on the card alike.  Every
collective here carries host values: one found-flag a round of a sweep and
JSON frames of at most 64 KiB (as ``process_allgather`` moves host numpy
arrays in the JAX package).  NCCL would bring nothing for them and cost a
device tensor and a device synchronisation a collective, and it refuses
two ranks on one card, the only world of several ranks that a one-card
machine can run.

Rank r runs on ``cuda:{r % torch.cuda.device_count()}``
(``_device.rank_device``); ``maybe_initialize_distributed`` makes that card
current.  The processes are found through the JAX package's environment
names, so one launcher serves both packages:

    JAX_COORDINATOR_ADDRESS=127.0.0.1:29400 JAX_NUM_PROCESSES=2 \\
        JAX_PROCESS_ID=0 python -m vuke_tpu_torch analyze KEY ...   # and id 1

``DistributedSweep`` differs from the reference in one place: every rank
runs the same number of rounds.  The reference reduces once a round that
a host runs, so when shards need different numbers of rounds (one seed
more can cost a round; an empty shard runs none) the hosts' collectives
no longer pair up and the run hangs.  Here each rank computes the largest
shard's round count from ``partition_range`` and joins each reduce past
its own shard with False; wherever the reference's rounds pair up, the
results are the reference's.
"""

from __future__ import annotations

import datetime
import json
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

# jax.distributed.initialize's default initialization_timeout
INIT_TIMEOUT_S = 300
FRAME_BYTES = 1 << 16


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def maybe_initialize_distributed() -> Tuple[int, int]:
    """Join the gloo world named by ``JAX_COORDINATOR_ADDRESS``
    (host:port), ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID`` when a
    coordinator is set and no world is joined yet, and make the rank's card
    current where there are cards.  Returns (rank, world size): (0, 1)
    without a coordinator.  A failed join raises."""
    coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coord and not dist.is_initialized():
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coord}",
            world_size=int(os.environ.get("JAX_NUM_PROCESSES", "1")),
            rank=int(os.environ.get("JAX_PROCESS_ID", "0")),
            timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
        if torch.cuda.is_available():
            torch.cuda.set_device(process_index() % torch.cuda.device_count())
    return process_index(), process_count()


@dataclass(frozen=True)
class RangeShard:
    """The contiguous sub-range a host owns."""
    start: int
    end: int  # inclusive

    @property
    def count(self) -> int:
        return self.end - self.start + 1


def partition_range(start: int, end: int, n_hosts: int,
                    host_id: Optional[int] = None) -> List[RangeShard] | RangeShard:
    """Split the inclusive range [start, end] into n_hosts contiguous shards.

    Remainder seeds go to the leading shards, so shard sizes differ by at
    most 1 and ownership is a pure function of (range, n_hosts, host_id).
    """
    total = end - start + 1
    base = total // n_hosts
    rem = total % n_hosts
    shards = []
    pos = start
    for h in range(n_hosts):
        n = base + (1 if h < rem else 0)
        shards.append(RangeShard(pos, pos + n - 1) if n > 0
                      else RangeShard(pos, pos - 1))
        pos += n
    if host_id is not None:
        return shards[host_id]
    return shards


def all_hosts_any(local_flag: bool) -> bool:
    """OR-reduce a host-local boolean across all ranks (an all-reduce MAX
    of a CPU int tensor).  One process: the flag as it is."""
    if process_count() == 1:
        return local_flag
    t = torch.tensor([1 if local_flag else 0], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def gather_results(local_items: list) -> list:
    """Gather per-rank JSON-able items (hit lists) to every rank, in rank
    order.  A rank's JSON payload and its 4-byte length prefix must fit the
    reference's 64 KiB frame.  One process: the list as it is."""
    if process_count() == 1:
        return list(local_items)
    payload = json.dumps(local_items).encode()
    if 4 + len(payload) > FRAME_BYTES:      # the reference's assert, kept under -O
        raise AssertionError("hit payload too large for gather frame")
    frames = [None] * process_count()
    dist.all_gather_object(frames, payload)
    out = []
    for frame in frames:
        out.extend(json.loads(frame.decode()))
    return out


class DistributedSweep:
    """Early-stop brute-force sweep across ranks.

    Every rank sweeps its own shard in rounds of ``round_batches`` batches
    (one ``analyze/sweeps.sweep`` a round); between rounds the found-flags
    are OR-reduced and every rank stops after the first round in which any
    found a seed, the distributed analogue of the reference's AtomicBool
    early exit.  Every rank runs as many rounds as the largest shard needs
    (the module's docstring says why)."""

    def __init__(self, program, round_batches: int = 8):
        self.program = program
        self.round_batches = round_batches

    def run(self, start: int, end: int, target_words=None, progress=None,
            decode=None):
        """(the smallest seed found on any rank or None, this rank's
        searched count)."""
        from ..analyze import sweeps

        host, n_hosts = process_index(), process_count()
        shards = partition_range(start, end, n_hosts)
        batch = self.program.batch
        per_round = batch * self.round_batches
        rounds = max(-(-s.count // per_round) for s in shards)
        shard = shards[host]
        pos = shard.start
        searched = 0
        local = None
        for _ in range(rounds):
            if pos <= shard.end:
                round_end = min(shard.end, pos + per_round - 1)
                r = sweeps.sweep(self.program, pos, round_end, target_words=target_words,
                                 progress=progress, decode=decode)
                searched += r.searched
                if r.found:
                    local = r.seed
                pos = round_end + 1
            if all_hosts_any(local is not None):
                break
        found = gather_results([local] if local is not None else [])
        found = [f for f in found if f is not None]
        return (min(found) if found else None), searched
