"""StorageOutput: the output handler over the Parquet backend.

The port's copy of ``vuke_tpu/storage/output.py``: records are buffered
and written through the backend every ``FLUSH_EVERY`` records, in the order
they came, each write split by transform in the order the transforms first
appear (the JAX ``ParquetBackend.write_batch``); ``finish()`` closes the
chunks and returns the paths and the record count.  ``key``, ``key_fast``
and ``hit`` take one record; ``key_columns`` takes a block of generate
records as column buffers (``cores/records.RecordBlock``: E1's rows and the
host's hex columns), with no object a record, and buffers them at the same
granularity, so a run writes the same records into the same chunk files
as the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from .records import ResultRecord, records_to_batch

FLUSH_EVERY = 4096


@dataclass
class StorageSummary:
    paths: List[str]
    records_written: int


class StorageOutput:
    needs_records = True

    def __init__(self, backend):
        self.backend = backend
        self._pieces: list = []          # (transform, record batch), in order
        self._pending = 0
        self._written = 0

    def _push_batch(self, transform: str, batch):
        pos, n = 0, batch.num_rows
        self._written += n
        while pos < n:
            take = min(n - pos, FLUSH_EVERY - self._pending)
            self._pieces.append((transform, batch.slice(pos, take)))
            self._pending += take
            pos += take
            if self._pending >= FLUSH_EVERY:
                self._write_pending()

    def _write_pending(self):
        import pyarrow as pa

        by_transform: dict = {}
        for transform, piece in self._pieces:
            by_transform.setdefault(transform, []).append(piece)
        for transform, pieces in by_transform.items():
            table = pa.Table.from_batches(pieces).combine_chunks()
            self.backend.write_record_batch(transform, table)
        self._pieces, self._pending = [], 0

    def _push(self, record: ResultRecord):
        self._push_batch(record.transform, records_to_batch([record]))

    def key(self, source: str, transform: str, derived):
        self._push(ResultRecord.from_derived(source, transform, derived))

    def key_fast(self, source: str, transform: str, key: bytes,
                 p2pkh_compressed: str, deriver=None):
        assert deriver is not None
        self._push(ResultRecord.from_derived(source, transform, deriver.derive(key)))

    def key_columns(self, block):
        """A block of generate records (``cores/records.RecordBlock``), in
        the order of their lines."""
        if len(block):
            self._push_batch(block.transform, block.record_batch())

    def hit(self, source: str, transform: str, derived, match_info):
        self._push(ResultRecord.from_derived(source, transform, derived,
                                             matched_target=match_info.address))

    def flush(self):
        if self._pieces:
            self._write_pending()
        self.backend.flush()

    def finish(self) -> StorageSummary:
        self.flush()
        paths = self.backend.close()
        return StorageSummary(paths=paths, records_written=self._written)
