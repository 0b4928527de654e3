"""Iceberg REST catalog registration (Polaris/Nessie-compatible).

The port's copy of ``vuke_tpu/storage/iceberg/__init__.py``: ensure
namespace, create the ``results`` table with the 19-column schema and partition spec
(identity(transform), day(timestamp)), then register Parquet files as an
append snapshot with per-file size/record-count/partition values.

The catalog interactions are plain REST (requests).  The append commit uses
pyiceberg when importable (manifest writing needs Avro); without it the
catalog/table bootstrap still runs and the append reports a clear error.
``requests``, ``pyarrow`` and ``pyiceberg`` are imported by the calls that
use them.
"""

from __future__ import annotations

import datetime as _dt
import json
import os
from dataclasses import dataclass
from typing import List, Optional


@dataclass
class IcebergConfig:
    catalog_url: str
    namespace: str = "vuke"
    table_name: str = "results"


@dataclass
class FileMetadata:
    uri: str
    file_size: int
    record_count: int
    transform: Optional[str] = None
    timestamp_day: Optional[int] = None


@dataclass
class SnapshotInfo:
    snapshot_id: int
    files_registered: int


def iceberg_schema_json() -> dict:
    """The 19-column schema as Iceberg JSON."""
    cols = [
        ("source", "string", True), ("transform", "string", True),
        ("chain", "string", True), ("timestamp", "timestamptz", True),
        ("matched_target", "string", False), ("private_key_raw", "binary", True),
        ("private_key_hex", "string", True), ("private_key_decimal", "string", True),
        ("private_key_binary", "string", True), ("private_key_bit_length", "int", True),
        ("private_key_hamming_weight", "int", True), ("private_key_leading_zeros", "int", True),
        ("pubkey_compressed", "string", False), ("pubkey_uncompressed", "string", False),
        ("address_p2pkh_compressed", "string", False),
        ("address_p2pkh_uncompressed", "string", False),
        ("address_p2wpkh", "string", False),
        ("wif_compressed", "string", False), ("wif_uncompressed", "string", False),
    ]
    fields = [
        {"id": i + 1, "name": name, "required": required, "type": typ}
        for i, (name, typ, required) in enumerate(cols)
    ]
    return {"type": "struct", "schema-id": 0, "fields": fields}


def partition_spec_json() -> dict:
    """identity(transform), day(timestamp)."""
    return {
        "spec-id": 0,
        "fields": [
            {"name": "transform", "transform": "identity", "source-id": 2,
             "field-id": 1000},
            {"name": "timestamp_day", "transform": "day", "source-id": 4,
             "field-id": 1001},
        ],
    }


class RestCatalogClient:
    def __init__(self, config: IcebergConfig, session=None):
        self.config = config
        if session is None:
            import requests
            session = requests.Session()
        self.session = session
        self.base = config.catalog_url.rstrip("/")

    def _url(self, path: str) -> str:
        return f"{self.base}/v1/{path.lstrip('/')}"

    def ensure_namespace(self):
        ns = self.config.namespace
        r = self.session.get(self._url(f"namespaces/{ns}"))
        if r.status_code == 200:
            return
        r = self.session.post(self._url("namespaces"),
                              json={"namespace": [ns], "properties": {}})
        if r.status_code not in (200, 409):
            raise RuntimeError(f"create namespace failed: {r.status_code} {r.text[:200]}")

    def table_exists(self) -> bool:
        ns, t = self.config.namespace, self.config.table_name
        r = self.session.get(self._url(f"namespaces/{ns}/tables/{t}"))
        return r.status_code == 200

    def create_table(self):
        ns, t = self.config.namespace, self.config.table_name
        body = {
            "name": t,
            "schema": iceberg_schema_json(),
            "partition-spec": partition_spec_json(),
            "properties": {"write.format.default": "parquet"},
        }
        r = self.session.post(self._url(f"namespaces/{ns}/tables"), json=body)
        if r.status_code not in (200, 409):
            raise RuntimeError(f"create table failed: {r.status_code} {r.text[:200]}")

    def register_parquet_files(self, files: List[FileMetadata]) -> SnapshotInfo:
        if not files:
            return SnapshotInfo(0, 0)
        self.ensure_namespace()
        if not self.table_exists():
            self.create_table()
        try:
            return self._append_with_pyiceberg(files)
        except ImportError:
            raise RuntimeError(
                "Iceberg snapshot append requires pyiceberg (manifest writing); "
                "catalog namespace/table were created but files were not "
                "registered. Install pyiceberg or register the files with "
                "another engine.")

    def _append_with_pyiceberg(self, files: List[FileMetadata]) -> SnapshotInfo:
        from pyiceberg.catalog.rest import RestCatalog  # noqa: F401 (ImportError gate)
        catalog = RestCatalog(name="vuke", uri=self.base)
        table = catalog.load_table((self.config.namespace, self.config.table_name))
        table.add_files([f.uri for f in files])
        snap = table.current_snapshot()
        return SnapshotInfo(snap.snapshot_id if snap else 0, len(files))


def file_metadata_for(paths, base_dir: str, uris=None) -> List[FileMetadata]:
    """Build FileMetadata with per-file record counts + Hive partition values."""
    import pyarrow.parquet as pq
    out = []
    for i, p in enumerate(paths):
        md = pq.read_metadata(p)
        transform = None
        day = None
        for part in str(p).split(os.sep):
            if part.startswith("transform="):
                transform = part.split("=", 1)[1]
            elif part.startswith("date="):
                d = _dt.date.fromisoformat(part.split("=", 1)[1])
                day = (d - _dt.date(1970, 1, 1)).days
        out.append(FileMetadata(
            uri=uris[i] if uris else str(p),
            file_size=os.path.getsize(p),
            record_count=md.num_rows,
            transform=transform,
            timestamp_day=day,
        ))
    return out


def stat_local_files(paths, base_dir: str) -> dict:
    """Parquet statistics per future remote key, taken while the local
    chunks still exist (before any --cloud-delete-local removal)."""
    from ..cloud import remote_key
    return {remote_key(p, base_dir, None): meta
            for p, meta in zip(paths, file_metadata_for(paths, base_dir))}


def join_uploaded_metadata(by_key: dict, uploaded, endpoint=None):
    """Attach uploaded cloud locations to the pre-upload statistics.

    Returns FileMetadata with real size/record-count/partition values per
    registered file."""
    out = []
    for cp in uploaded:
        meta = by_key.get(cp.key)
        if meta is None:
            meta = FileMetadata(uri="", file_size=0, record_count=0)
        meta.uri = cp.url(endpoint)
        out.append(meta)
    return out


def register_snapshot(catalog_url: str, namespace: str, table: str, files):
    """CLI tail: register uploaded files.

    ``files`` may be FileMetadata (preferred — carries real stats), or
    CloudPath/str fallbacks which register with zero stats."""
    import sys
    cfg = IcebergConfig(catalog_url, namespace, table)
    client = RestCatalogClient(cfg)
    metas = [f if isinstance(f, FileMetadata)
             else FileMetadata(uri=(f.url() if hasattr(f, "url") else str(f)),
                               file_size=0, record_count=0)
             for f in files]
    try:
        info = client.register_parquet_files(metas)
        print(f"Iceberg: registered {info.files_registered} files "
              f"(snapshot {info.snapshot_id})", file=sys.stderr)
    except RuntimeError as e:
        print(f"Iceberg registration: {e}", file=sys.stderr)
