"""Input sources: range, timestamps, wordlist, stdin and files.

The port's copy of ``vuke_tpu/sources.py``.  Numeric sources (range,
timestamps) are seed lattices driven by ``pipeline.ForwardDriver``;
string sources stream host batches of ``STRING_BATCH`` through
``pipeline.StringDriver``, which fixes their output order.  A numeric
source also feeds the string-only transforms (electrum, multibit) the
decimal string of each seed, after the numeric transforms' pass, as
``vuke_tpu/sources.py:27-60`` does: the electrum-over-timestamps attack.
``FilesSource`` gives each file's bytes to the transforms that read them
(bitimage).
"""

from __future__ import annotations

import datetime as _dt
import os
import sys
from dataclasses import dataclass
from typing import Iterator, List, Tuple

from .pipeline import ProcessStats

STRING_BATCH = 1000


def _string_only_specs(string_driver) -> list:
    """The transforms only the string path reaches, no blob reader."""
    if string_driver is None:
        return []
    return [s for s in string_driver.specs
            if s.numeric is None and s.string is not None and s.string.blob_fn is None]


def _strings_over_range(string_driver, start: int, end: int, counted: bool) -> ProcessStats:
    """The decimal strings of [start, end] through the string-only
    transforms, ``STRING_BATCH`` at a time; inputs (and progress) count
    only when no numeric transform has counted them (``counted``)."""
    stats = ProcessStats()
    specs = _string_only_specs(string_driver)
    if not specs:
        return stats
    prog = string_driver.progress
    if counted:
        string_driver.progress = None
    try:
        pos = start
        while pos <= end:
            hi = min(pos + STRING_BATCH - 1, end)
            st = string_driver.process_batch([str(v) for v in range(pos, hi + 1)], specs=specs)
            if counted:
                st.inputs_processed = 0
            stats.merge(st)
            pos = hi + 1
    finally:
        string_driver.progress = prog
    return stats


@dataclass
class RangeSource:
    """The inclusive u64 range [start, end]."""
    start: int
    end: int

    def process(self, numeric_driver, string_driver=None) -> ProcessStats:
        stats = numeric_driver.run_range(self.start, self.end)
        stats.merge(_strings_over_range(string_driver, self.start, self.end,
                                        bool(numeric_driver.specs)))
        return stats


@dataclass
class TimestampSource:
    """A date range as unix seconds [start, end]; with ``microseconds``
    also the millisecond lattice [start * 1000, (end + 1) * 1000 - 1]."""
    start: int
    end: int
    microseconds: bool = False

    @classmethod
    def from_dates(cls, start_date: str, end_date: str, microseconds: bool = False):
        """YYYY-MM-DD dates in UTC: the first second of the start day to
        the last second of the end day."""
        start = int(_dt.datetime.strptime(start_date, "%Y-%m-%d")
                    .replace(tzinfo=_dt.timezone.utc).timestamp())
        end_day = _dt.datetime.strptime(end_date, "%Y-%m-%d").replace(
            hour=23, minute=59, second=59, tzinfo=_dt.timezone.utc)
        return cls(start, int(end_day.timestamp()), microseconds)

    def process(self, numeric_driver, string_driver=None) -> ProcessStats:
        counted = bool(numeric_driver.specs)
        stats = numeric_driver.run_range(self.start, self.end)
        stats.merge(_strings_over_range(string_driver, self.start, self.end, counted))
        if self.microseconds:
            lo, hi = self.start * 1000, (self.end + 1) * 1000 - 1
            stats.merge(numeric_driver.run_range(lo, hi))
            stats.merge(_strings_over_range(string_driver, lo, hi, counted))
        return stats


@dataclass
class WordlistSource:
    """The lines of a file, decoded as UTF-8 (bad bytes replaced),
    stripped, empty ones skipped."""
    path: str

    def words(self) -> List[str]:
        with open(self.path, encoding="utf-8", errors="replace") as f:
            return [w for w in (line.strip() for line in f) if w]

    def process(self, numeric_driver, string_driver) -> ProcessStats:
        stats = ProcessStats()
        words = self.words()
        for i in range(0, len(words), STRING_BATCH):
            stats.merge(string_driver.process_batch(words[i:i + STRING_BATCH]))
        return stats


@dataclass
class StdinSource:
    """Standard input's stripped non-empty lines, in batches of
    ``STRING_BATCH`` as they arrive."""

    def process(self, numeric_driver, string_driver) -> ProcessStats:
        stats = ProcessStats()
        batch: List[str] = []
        for line in sys.stdin:
            s = line.strip()
            if not s:
                continue
            batch.append(s)
            if len(batch) >= STRING_BATCH:
                stats.merge(string_driver.process_batch(batch))
                batch = []
        if batch:
            stats.merge(string_driver.process_batch(batch))
        return stats


@dataclass
class FilesSource:
    """A file, or the files of a directory (recursive: its whole tree),
    sorted, symlinks skipped; each is one input, its path the label and
    its bytes the blob (bitimage)."""
    path: str
    recursive: bool = False

    def entries(self) -> List[str]:
        if os.path.isfile(self.path):
            return [self.path]
        out: List[str] = []
        if self.recursive:
            for root, dirs, files in os.walk(self.path, followlinks=False):
                for f in sorted(files):
                    p = os.path.join(root, f)
                    if not os.path.islink(p):
                        out.append(p)
        else:
            for f in sorted(os.listdir(self.path)):
                p = os.path.join(self.path, f)
                if os.path.isfile(p) and not os.path.islink(p):
                    out.append(p)
        return out

    def blobs(self) -> Iterator[Tuple[bytes, str]]:
        for p in self.entries():
            try:
                with open(p, "rb") as f:
                    yield f.read(), p
            except OSError as e:
                print(f"Warning: failed to read {p}: {e}", file=sys.stderr)

    def process(self, numeric_driver, string_driver) -> ProcessStats:
        stats = ProcessStats()
        for data, label in self.blobs():
            stats.inputs_processed += 1
            stats.merge(string_driver.process_blob(data, label))
        return stats
