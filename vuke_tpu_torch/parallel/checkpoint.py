"""Search progress on disk: a JSON manifest of the completed seed ranges.

The port's copy of ``vuke_tpu/parallel/checkpoint.py::SweepCheckpoint``:
the same JSON (``job_id``, ``completed`` as inclusive ``[start, end]``
pairs, ``found_seed``), written atomically (a temporary file, then a
rename), adjacent ranges merged; a manifest of another job is ignored;
and ``checkpointed_sweep``, which runs an ``analyze`` sweep chunk by chunk
against such a manifest.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class SweepCheckpoint:
    path: str
    job_id: str
    completed: List[Tuple[int, int]] = field(default_factory=list)  # inclusive
    found_seed: Optional[int] = None

    @classmethod
    def load(cls, path: str, job_id: str) -> "SweepCheckpoint":
        if os.path.exists(path):
            with open(path) as f:
                data = json.load(f)
            if data.get("job_id") == job_id:
                return cls(path=path, job_id=job_id,
                           completed=[tuple(r) for r in data.get("completed", [])],
                           found_seed=data.get("found_seed"))
        return cls(path=path, job_id=job_id)

    def save(self):
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d or ".", prefix=".ckpt_")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump({"job_id": self.job_id,
                           "completed": self.completed,
                           "found_seed": self.found_seed}, f)
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise

    def mark_completed(self, start: int, end: int):
        """Record [start, end] done, merging adjacent ranges."""
        self.completed.append((start, end))
        self.completed.sort()
        merged: List[Tuple[int, int]] = []
        for s, e in self.completed:
            if merged and s <= merged[-1][1] + 1:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        self.completed = merged

    def pending_ranges(self, start: int, end: int) -> List[Tuple[int, int]]:
        """Sub-ranges of [start, end] not yet completed."""
        out = []
        pos = start
        for s, e in self.completed:
            if e < pos or s > end:
                continue
            if s > pos:
                out.append((pos, min(s - 1, end)))
            pos = max(pos, e + 1)
            if pos > end:
                break
        if pos <= end:
            out.append((pos, end))
        return out


def checkpointed_sweep(program, start: int, end: int, ckpt: SweepCheckpoint,
                       target_words=None, progress=None,
                       checkpoint_every_batches: int = 16, decode=None):
    """Sweep [start, end] with periodic durable progress (the port of
    ``vuke_tpu/parallel/checkpoint.py::checkpointed_sweep``).

    Resumes from the manifest's pending ranges; marks each chunk of
    ``checkpoint_every_batches`` batches completed once it is swept, and
    records a found seed (a sha256_chain hit's ``(seed, index)`` comes
    back from JSON as a list and is returned as a tuple).
    """
    from ..analyze import sweeps
    if ckpt.found_seed is not None:
        seed = ckpt.found_seed
        if isinstance(seed, list):   # JSON round-trip of a (seed, index) pair
            seed = tuple(seed)
        return sweeps.SweepResult(True, seed, 0, 0.0)
    searched = 0
    cascade_hits = 0
    chunk = program.batch * checkpoint_every_batches
    for s, e in ckpt.pending_ranges(start, end):
        pos = s
        while pos <= e:
            ce = min(e, pos + chunk - 1)
            r = sweeps.sweep(program, pos, ce, target_words=target_words,
                             progress=progress, decode=decode)
            searched += r.searched
            cascade_hits += r.cascade_hits
            if r.found:
                ckpt.found_seed = r.seed
                ckpt.save()
                return sweeps.SweepResult(True, r.seed, searched, r.elapsed,
                                          cascade_hits)
            ckpt.mark_completed(pos, ce)
            ckpt.save()
            pos = ce + 1
    return sweeps.SweepResult(False, None, searched, 0.0, cascade_hits)
