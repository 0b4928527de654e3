"""Brute-force sweeps of the reverse analyzers on the card.

The port of ``vuke_tpu/analyze/sweeps.py``: a sweep is one launch a batch
(S1 ``cores/sweep.sweep_prng`` or S2 ``cores/sweep.sweep_chain``: seed
lattice -> keystream -> exact, mask or cascade compare -> the batch's
first hit, and the count of lanes that pass a cascade's first target)
and a host loop that keeps up to three batches in flight and stops at the
first batch with a hit, as the reference's AtomicBool does.  Each batch's
record comes to the host through a pinned row (``pipeline.StatsRing``),
so the loop waits on that batch's copy alone.

The JAX package's ``_xla_fallback_step`` has no counterpart: a kernel that
fails to build or launch raises.  In a world of several processes
``dispatch_sweep`` runs ``parallel/multihost.DistributedSweep``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from .._device import run_device
from ..cores import sweep as S
from ..pipeline import StatsRing

DEFAULT_SWEEP_BATCH = 1 << 20
CARD_SWEEP_BATCH = 1 << 24


@dataclass
class SweepResult:
    found: bool
    seed: Optional[int]
    searched: int
    elapsed: float
    cascade_hits: int = 0


class _Program:
    """A sweep's compare, batch, device record and its ring of pinned rows
    (three batches are in flight: the host loop reads a record before it
    launches three more); ``_fill`` launches a batch."""

    def __init__(self, compare: str, mask, cascade, batch: int, track_first_filter: bool,
                 device):
        self.batch = batch
        self.compare = compare
        self._fixed = None
        if compare == "mask":
            self._fixed = S.Compare("mask", targets=(tuple(mask),))
        elif compare == "cascade":
            self._fixed = S.Compare("cascade", targets=tuple(map(tuple, cascade)),
                                    track=track_first_filter)
        self._exact = {}
        self.device = run_device(device if device is not None else "cuda")
        # one record serves every batch: the stream orders a batch's reset
        # after the previous batch's copy
        self._record = torch.empty(2, dtype=torch.int64, device=self.device)
        self._ring = StatsRing(self.device, 1, depth=3)

    def _compare_for(self, target_words) -> S.Compare:
        if self._fixed is not None:
            return self._fixed
        words = tuple(int(w) for w in (target_words if target_words is not None else [0] * 8))
        if words not in self._exact:
            self._exact[words] = S.Compare("exact", words=words)
        return self._exact[words]

    def run_batch(self, start: int, limit: Optional[int] = None, target_words=None):
        """Launch the batch of seeds ``start + i``, i < ``limit`` (default
        the batch); its record on its way to the host (``tolist()``: [[the
        first hit's index or ``cores/sweep.NONE``, the first-filter
        count]])."""
        if limit is None:
            limit = self.batch
        self._fill(self._record, start, limit, self._compare_for(target_words))
        return self._ring.send(self._record.view(1, 2))


class SweepProgram(_Program):
    """A sweep over one PRNG keystream with one compare.

    family: "milksad", "mt64", "lcg" (``variant`` its index in
      ``cores/lcg.ALL_VARIANTS``, ``big_endian`` its byte order) or
      "xorshift" (``variant`` its index in ``cores/xorshift.VARIANT_NAMES``);
    compare: "exact" (vs the 8-word target argument of ``run_batch``),
             "mask" (single (bits, target)),
             "cascade" (tuple of (bits, target): key j vs target j), which
             with ``track_first_filter`` also counts the seeds that pass
             target 0.
    ``device``: "cuda" (S1; the default) or "cpu" (its plain version).
    """

    def __init__(self, family: str, compare: str,
                 mask: Optional[Tuple[int, int]] = None,
                 cascade: Optional[Sequence[Tuple[int, int]]] = None,
                 batch: int = DEFAULT_SWEEP_BATCH, track_first_filter: bool = False, *,
                 variant: int = 0, big_endian: bool = True, device=None):
        super().__init__(compare, mask, cascade, batch, track_first_filter, device)
        self.family, self.variant, self.big_endian = family, variant, big_endian

    def _fill(self, record, start, limit, cmp):
        S.sweep_prng(record, start, limit, self.family, self.variant, self.big_endian, cmp)


class ChainSweepProgram(_Program):
    """Sweep for SHA256-chain analysis: each u32 seed yields ``depth`` keys
    of ``variant``; exact and mask modes check every chain position, cascade
    mode maps chain position i to cascade target i (the reference's
    analyze/sha256_chain.rs:48-157, 288-360).  A hit's index is lane x
    depth + position (the lane in a cascade).  ``device``: "cuda" (S2; the
    default) or "cpu" (its plain version)."""

    def __init__(self, variant: str, depth: int, compare: str,
                 mask: Optional[Tuple[int, int]] = None,
                 cascade: Optional[Sequence[Tuple[int, int]]] = None,
                 batch: int = DEFAULT_SWEEP_BATCH // 4, *, device=None):
        super().__init__(compare, mask, cascade, batch, False, device)
        self.variant, self.depth = variant, depth

    def _fill(self, record, start, limit, cmp):
        S.sweep_chain(record, start, limit, self.variant, self.depth, cmp)


def dispatch_sweep(program, space_start: int, space_end: int, *,
                   target_words=None, progress=None,
                   max_seeds: Optional[int] = None, decode=None,
                   config=None, job: str = "") -> SweepResult:
    """Sweep with optional durable checkpointing / multi-process distribution.

    - ``config.checkpoint_path`` set -> resume from / record to an atomic
      manifest keyed by ``job`` (parallel/checkpoint.py), so a preempted
      brute-force continues instead of restarting from zero.
    - ``multihost.process_count() > 1`` -> static per-rank shard with the
      early stop across ranks (parallel/multihost.DistributedSweep).
    - otherwise the plain pipelined early-exit sweep.
    """
    if max_seeds is not None:
        space_end = min(space_end, space_start + max_seeds - 1)
    ckpt_path = getattr(config, "checkpoint_path", None) if config is not None else None
    if ckpt_path:
        from ..parallel.checkpoint import SweepCheckpoint, checkpointed_sweep
        ckpt = SweepCheckpoint.load(ckpt_path, job or "sweep")
        return checkpointed_sweep(program, space_start, space_end, ckpt,
                                  target_words=target_words, progress=progress,
                                  decode=decode)
    from ..parallel.multihost import DistributedSweep, process_count
    if process_count() > 1:
        t0 = time.time()
        seed, searched = DistributedSweep(program).run(
            space_start, space_end, target_words=target_words,
            progress=progress, decode=decode)
        return SweepResult(seed is not None, seed, searched, time.time() - t0)
    return sweep(program, space_start, space_end, target_words=target_words,
                 progress=progress, decode=decode)


def sweep(program, space_start: int, space_end: int,
          target_words=None, progress=None,
          max_seeds: Optional[int] = None, decode=None) -> SweepResult:
    """Host loop: pipelined batches with early exit.

    Searches [space_start, space_end] inclusive with up to three batches
    launched; reads the oldest, stops at the first batch with a hit and
    returns its first matching seed (a batch launched after it is never
    read).  ``decode(bstart, idx)`` maps a flat hit index back to a seed
    (default: bstart + idx).
    """
    t0 = time.time()
    searched = 0
    cascade_hits = 0
    pos = space_start
    pending = []  # (batch_start, n, pending record)
    end = space_end
    if max_seeds is not None:
        end = min(end, space_start + max_seeds - 1)
    if decode is None:
        decode = lambda bstart, idx: bstart + idx

    def consume(bstart, n, res):
        nonlocal searched, cascade_hits
        idx, first_filter_hits = res.tolist()[0]
        searched += n
        cascade_hits += first_filter_hits
        if idx != S.NONE:
            return decode(bstart, idx)
        if progress is not None:
            progress.advance(n)
        return None

    while pos <= end or pending:
        if pos <= end:
            n = min(program.batch, end - pos + 1)
            pending.append((pos, n, program.run_batch(pos, n, target_words)))
            pos += program.batch
        while len(pending) > 2 or (pos > end and pending):
            bstart, n, res = pending.pop(0)
            seed = consume(bstart, n, res)
            if seed is not None:
                return SweepResult(True, seed, searched, time.time() - t0,
                                   cascade_hits)
    return SweepResult(False, None, searched, time.time() - t0, cascade_hits)
