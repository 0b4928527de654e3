"""Parquet backend: the Hive-partitioned chunked writer.

The port's copy of ``vuke_tpu/storage/parquet_backend.py``: the layout
``transform=X/date=Y/chunk_NNNN.parquet``, rotation when a chunk reaches
``max_records`` (default 1M) or ``max_bytes`` (default 100 MB), zstd level 3
by default, one writer per transform, ``close()`` returning every completed
chunk.  ``write_record_batch`` writes an Arrow batch or table of one
transform as ``write_batch`` writes records: split at the record limit, one
``write_table`` a piece, the rotation checked after each.
"""

from __future__ import annotations

import datetime as _dt
import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, List

from .records import records_to_batch, result_schema

DEFAULT_CHUNK_RECORDS = 1_000_000
DEFAULT_CHUNK_BYTES = 100 * 1024 * 1024

_COMPRESSION_MAP = {
    "zstd": "ZSTD",
    "snappy": "SNAPPY",
    "gzip": "GZIP",
    "lz4": "LZ4",
    "none": "NONE",
}


@dataclass
class _PartitionWriter:
    path: str
    writer: Any            # pyarrow.parquet.ParquetWriter
    records: int = 0
    index: int = 0


class ParquetBackend:
    def __init__(self, base_dir, max_records_per_chunk: int = DEFAULT_CHUNK_RECORDS,
                 max_bytes_per_chunk: int = DEFAULT_CHUNK_BYTES,
                 compression: str = "zstd", compression_level: int = 3):
        self.base_dir = str(base_dir)
        self.max_records = max_records_per_chunk or None
        self.max_bytes = max_bytes_per_chunk or None
        self.compression = _COMPRESSION_MAP.get(compression, "ZSTD")
        self.compression_level = compression_level if self.compression in ("ZSTD", "GZIP") else None
        self.schema = result_schema()
        self._lock = threading.Lock()
        self._writers: Dict[str, _PartitionWriter] = {}
        self._chunk_indices: Dict[str, int] = {}
        self._completed: List[str] = []
        self._date = _dt.datetime.now(_dt.timezone.utc).strftime("%Y-%m-%d")

    def _chunk_path(self, transform: str) -> str:
        idx = self._chunk_indices.get(transform, 0) + 1
        self._chunk_indices[transform] = idx
        d = os.path.join(self.base_dir, f"transform={transform}", f"date={self._date}")
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, f"chunk_{idx:04d}.parquet")

    def _open_writer(self, transform: str) -> _PartitionWriter:
        import pyarrow.parquet as pq

        path = self._chunk_path(transform)
        writer = pq.ParquetWriter(
            path, self.schema, compression=self.compression,
            compression_level=self.compression_level)
        pw = _PartitionWriter(path=path, writer=writer)
        self._writers[transform] = pw
        return pw

    def _should_rotate(self, pw: _PartitionWriter) -> bool:
        if self.max_records and pw.records >= self.max_records:
            return True
        if self.max_bytes:
            try:
                if os.path.getsize(pw.path) >= self.max_bytes:
                    return True
            except OSError:
                pass
        return False

    def _rotate(self, transform: str):
        pw = self._writers.pop(transform, None)
        if pw is not None:
            pw.writer.close()
            self._completed.append(pw.path)

    def _write(self, transform: str, batch):
        """``batch`` (a record batch or table of ``transform``'s records)
        into its chunks; the caller holds the lock."""
        import pyarrow as pa

        table = batch if isinstance(batch, pa.Table) else pa.Table.from_batches([batch])
        pos, n = 0, table.num_rows
        while pos < n:
            pw = self._writers.get(transform)
            if pw is None:
                pw = self._open_writer(transform)
            take = n - pos
            if self.max_records:
                take = min(take, self.max_records - pw.records)
            pw.writer.write_table(table.slice(pos, take))
            pw.records += take
            pos += take
            if self._should_rotate(pw):
                self._rotate(transform)

    def write_batch(self, records):
        if not records:
            return
        with self._lock:
            by_transform: dict = {}
            for r in records:
                by_transform.setdefault(r.transform, []).append(r)
            for transform, recs in by_transform.items():
                self._write(transform, records_to_batch(recs))

    def write_record_batch(self, transform: str, batch):
        """An Arrow batch or table of ``transform``'s records, in order."""
        if batch.num_rows:
            with self._lock:
                self._write(transform, batch)

    def flush(self):
        pass  # ParquetWriter buffers internally; chunks close on rotate/close

    def close(self) -> List[str]:
        """Close all open chunks; returns every completed chunk path."""
        with self._lock:
            for transform in list(self._writers):
                self._rotate(transform)
            return list(self._completed)

    def chunk_paths(self) -> List[str]:
        with self._lock:
            return list(self._completed)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
