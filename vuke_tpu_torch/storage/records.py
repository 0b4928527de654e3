"""Result records and the flat 19-column Arrow schema.

The port's copy of ``vuke_tpu/storage/records.py``: ``result_schema``
field for field (names, types, nullability), ``ResultRecord`` with its
redacted ``repr`` and ``records_to_batch``.  ``columns_to_batch`` builds the
same batch straight from column buffers (fixed-width uint8 rows, NUL-padded,
as ``cores/records.py`` lays out E1's output and the host's hex columns),
with no object a record.  ``pyarrow`` is imported inside the functions that
use it.
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

# the string columns that columns_to_batch takes as uint8 rows
ROW_COLUMNS = ("private_key_hex", "private_key_decimal", "private_key_binary",
               "pubkey_compressed", "pubkey_uncompressed", "address_p2pkh_compressed",
               "address_p2pkh_uncompressed", "address_p2wpkh", "wif_compressed",
               "wif_uncompressed")


def result_schema():
    import pyarrow as pa

    return pa.schema([
        pa.field("source", pa.string(), nullable=False),
        pa.field("transform", pa.string(), nullable=False),
        pa.field("chain", pa.string(), nullable=False),
        pa.field("timestamp", pa.timestamp("ms", tz="UTC"), nullable=False),
        pa.field("matched_target", pa.string(), nullable=True),
        pa.field("private_key_raw", pa.binary(32), nullable=False),
        pa.field("private_key_hex", pa.string(), nullable=False),
        pa.field("private_key_decimal", pa.string(), nullable=False),
        pa.field("private_key_binary", pa.string(), nullable=False),
        pa.field("private_key_bit_length", pa.uint16(), nullable=False),
        pa.field("private_key_hamming_weight", pa.uint16(), nullable=False),
        pa.field("private_key_leading_zeros", pa.uint8(), nullable=False),
        pa.field("pubkey_compressed", pa.string(), nullable=True),
        pa.field("pubkey_uncompressed", pa.string(), nullable=True),
        pa.field("address_p2pkh_compressed", pa.string(), nullable=True),
        pa.field("address_p2pkh_uncompressed", pa.string(), nullable=True),
        pa.field("address_p2wpkh", pa.string(), nullable=True),
        pa.field("wif_compressed", pa.string(), nullable=True),
        pa.field("wif_uncompressed", pa.string(), nullable=True),
    ])


@dataclass
class ResultRecord:
    source: str
    transform: str
    private_key_raw: bytes
    private_key_hex: str
    private_key_decimal: str
    private_key_binary: str
    private_key_bit_length: int
    private_key_hamming_weight: int
    private_key_leading_zeros: int
    chain: str = "bitcoin"
    timestamp: Optional[_dt.datetime] = None
    matched_target: Optional[str] = None
    pubkey_compressed: Optional[str] = None
    pubkey_uncompressed: Optional[str] = None
    address_p2pkh_compressed: Optional[str] = None
    address_p2pkh_uncompressed: Optional[str] = None
    address_p2wpkh: Optional[str] = None
    wif_compressed: Optional[str] = None
    wif_uncompressed: Optional[str] = None

    def __post_init__(self):
        if self.timestamp is None:
            self.timestamp = _dt.datetime.now(_dt.timezone.utc)

    def __repr__(self):  # private key material redacted
        return (f"ResultRecord(source={self.source!r}, transform={self.transform!r}, "
                f"private_key=<redacted>, matched_target={self.matched_target!r})")

    @classmethod
    def from_derived(cls, source: str, transform: str, derived,
                     matched_target: Optional[str] = None) -> "ResultRecord":
        return cls(
            source=source,
            transform=transform,
            matched_target=matched_target,
            private_key_raw=derived.raw,
            private_key_hex=derived.private_key_hex,
            private_key_decimal=derived.private_key_decimal,
            private_key_binary=derived.private_key_binary,
            private_key_bit_length=derived.bit_length,
            private_key_hamming_weight=derived.hamming_weight,
            private_key_leading_zeros=derived.leading_zeros,
            pubkey_compressed=derived.pubkey_compressed,
            pubkey_uncompressed=derived.pubkey_uncompressed,
            address_p2pkh_compressed=derived.p2pkh_compressed,
            address_p2pkh_uncompressed=derived.p2pkh_uncompressed,
            address_p2wpkh=derived.p2wpkh,
            wif_compressed=derived.wif_compressed,
            wif_uncompressed=derived.wif_uncompressed,
        )


def records_to_batch(records: List[ResultRecord]):
    import pyarrow as pa

    schema = result_schema()
    cols = [pa.array([getattr(r, f.name) for r in records], type=f.type) for f in schema]
    return pa.RecordBatch.from_arrays(cols, schema=schema)


def string_column(rows: np.ndarray):
    """(n, W) uint8 rows, each a string in its non-NUL bytes -> a
    ``pa.StringArray`` (offsets from the lengths' cumsum, data the rows'
    non-NUL bytes in order), with no object a row."""
    import pyarrow as pa

    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    lengths = np.count_nonzero(rows, axis=1)
    offsets = np.zeros(len(rows) + 1, dtype=np.int32)
    np.cumsum(lengths, out=offsets[1:])
    full = len(rows) and lengths.min() == rows.shape[1]       # no NUL: the rows as they are
    data = rows if full else rows[rows != 0]
    return pa.StringArray.from_buffers(len(rows), pa.py_buffer(offsets), pa.py_buffer(data))


def _constant_column(value: str, n: int):
    import pyarrow as pa

    data = value.encode()
    offsets = np.arange(n + 1, dtype=np.int32) * len(data)
    return pa.StringArray.from_buffers(n, pa.py_buffer(offsets), pa.py_buffer(data * n))


def columns_to_batch(*, sources, transform: str, raw: np.ndarray, strings: dict,
                     bit_length: np.ndarray, hamming_weight: np.ndarray,
                     leading_zeros: np.ndarray, timestamp: Optional[_dt.datetime] = None,
                     chain: str = "bitcoin"):
    """A ``result_schema`` batch of n records from column buffers: ``sources``
    a list of n strings or (n, W) uint8 rows; ``raw`` (n, 32) uint8 keys;
    ``strings`` each name of ``ROW_COLUMNS`` -> its (n, W) uint8 rows,
    NUL-padded; the statistics as integer arrays; one ``timestamp`` (now,
    UTC, when None) for every record; ``matched_target`` null."""
    import pyarrow as pa

    n = len(raw)
    if timestamp is None:
        timestamp = _dt.datetime.now(_dt.timezone.utc)
    ms = int(timestamp.timestamp() * 1000)
    cols = {
        "source": (string_column(sources) if isinstance(sources, np.ndarray)
                   else pa.array(list(sources), type=pa.string())),
        "transform": _constant_column(transform, n),
        "chain": _constant_column(chain, n),
        "timestamp": pa.array(np.full(n, ms, dtype=np.int64)).cast(
            pa.timestamp("ms", tz="UTC")),
        "matched_target": pa.nulls(n, pa.string()),
        "private_key_raw": pa.FixedSizeBinaryArray.from_buffers(
            pa.binary(32), n, [None, pa.py_buffer(np.ascontiguousarray(raw, np.uint8))]),
        "private_key_bit_length": pa.array(np.asarray(bit_length, dtype=np.uint16)),
        "private_key_hamming_weight": pa.array(np.asarray(hamming_weight, dtype=np.uint16)),
        "private_key_leading_zeros": pa.array(np.asarray(leading_zeros, dtype=np.uint8)),
    }
    cols.update({name: string_column(strings[name]) for name in ROW_COLUMNS})
    schema = result_schema()
    return pa.RecordBatch.from_arrays([cols[f.name] for f in schema], schema=schema)
