"""Faults planted underneath a run, by ``module:function`` (``run.main``'s
``patch``, which the four-rank driver hands to every rank): each breaks
the program's timed path in one way that the comparison with the
reference has to catch.  They are for the tests alone."""

from __future__ import annotations


def no_exchange(cell):
    """The exchange between ranks left out: each rank keeps its own
    found-flag and its own result."""
    from vuke_tpu_torch.parallel import multihost

    multihost.all_hosts_any = lambda flag: flag
    multihost.gather_results = lambda items: list(items)


def sweep_unchanged(cell):
    """A sweep batch that leaves its record as it was: no batch reports a
    hit."""
    from vuke_tpu_torch.cores import sweep

    def fill(record, *a, **k):
        record.fill_(sweep.NONE)
        return record

    sweep.sweep_prng = fill
    sweep.sweep_chain = fill


def sweep_half_batch(cell):
    """Half of each sweep batch left out: only its first half of lanes is
    searched, though the whole batch is counted."""
    from vuke_tpu_torch.analyze import sweeps

    orig = sweeps.SweepProgram._fill

    def fill(self, record, start, limit, cmp):
        return orig(self, record, start, max(1, limit // 2), cmp)

    sweeps.SweepProgram._fill = fill


def sweep_seed_altered(cell):
    """The answer altered where it is produced: a hit's lane read one
    off."""
    from vuke_tpu_torch.analyze import sweeps

    orig = sweeps.SweepProgram._fill

    def fill(self, record, start, limit, cmp):
        orig(self, record, start, limit, cmp)
        record[0] = record[0] + (record[0] >= 0).to(record.dtype)

    sweeps.SweepProgram._fill = fill


def scan_step_unchanged(cell):
    """A superbatch whose match leaves the hit flags as they were: no lane
    is ever flagged."""
    from vuke_tpu_torch import pipeline

    def call(self, d, slot):
        self.hit.fill_(False)
        self.stats[slot, 0] = self.valid.sum()
        self.stats[slot, 1] = 0
        return pipeline.pack_mask(self.hit)

    pipeline.Matcher.__call__ = call


def scan_half_batch(cell):
    """Half of each superbatch left out: its lanes from half the limit on
    masked out."""
    from vuke_tpu_torch import pipeline

    run = pipeline.ScanProgram.run
    pipeline.ScanProgram.run = lambda self, start, limit: run(self, start, max(1, limit // 2))


def scan_lane_altered(cell):
    """The answer altered where it is produced: the hit mask read one lane
    off."""
    import numpy as np
    from vuke_tpu_torch import pipeline

    unpack = pipeline.unpack_mask
    pipeline.unpack_mask = lambda packed, n: np.roll(unpack(packed, n), 1)


def jax_on_rank_1(cell):
    """Not a fault of the program but of what a rank loads: rank 1's
    process holds a module named ``jax``, which the run has to see though
    rank 0's does not."""
    import os
    import sys
    import types

    if os.environ.get("JAX_PROCESS_ID") == "1":
        sys.modules["jax"] = types.ModuleType("jax")
