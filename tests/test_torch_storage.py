"""The storage stack of the port (``vuke_tpu_torch/storage/``) against the
JAX package's.

Every case of ``tests/test_storage.py`` and ``tests/test_storage_vectors.py``
runs here against the port's modules (tempdirs, in-memory uploaders and
fake catalog sessions; no network).  Beside them: the schema equal to the
JAX one; the JAX ``ParquetBackend`` and the port's writing the same records
into the same chunks, tables equal without ``timestamp``; the
column-buffer batch (``cores/records.RecordBlock``) equal to the JAX
``records_to_batch``; the query formats byte-equal; the sqlite fallback;
the cloud sync's retries, failures, delete-local and fail-fast; the Iceberg
append without pyiceberg.  Tolerance 0 everywhere.
"""

import datetime as dt
import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import vuke_tpu.derive as jderive
import vuke_tpu.storage as jstorage
from vuke_tpu.storage import query as jquery
from vuke_tpu.storage import records as jrecords
from vuke_tpu_torch.cores import records as rec
from vuke_tpu_torch.derive import KeyDeriver
from vuke_tpu_torch.ecc import ref
from vuke_tpu_torch.storage import ParquetBackend, ResultRecord, StorageOutput, result_schema
from vuke_tpu_torch.storage import query as pquery
from vuke_tpu_torch.storage.cloud import CloudConfig, CloudPath, UploadStats, sync_files
from vuke_tpu_torch.storage.cloud.s3 import InMemoryUploader
from vuke_tpu_torch.storage.query import QueryExecutor, format_results


# --- tests/test_storage.py ------------------------------------------------

@pytest.fixture(scope="module")
def derived():
    return KeyDeriver().derive(b"\x01" * 32)


def _records(derived, n, transform="milksad"):
    return [ResultRecord.from_derived(str(i), transform, derived) for i in range(n)]


def test_schema_has_19_columns():
    assert len(result_schema()) == 19


def test_parquet_write_and_layout(tmp_path, derived):
    backend = ParquetBackend(tmp_path)
    backend.write_batch(_records(derived, 10))
    backend.write_batch(_records(derived, 5, transform="sha256"))
    paths = backend.close()
    assert len(paths) == 2
    for p in paths:
        assert "transform=" in p and "date=" in p and p.endswith(".parquet")
    import pyarrow.parquet as pq
    total = sum(pq.read_metadata(p).num_rows for p in paths)
    assert total == 15


def test_parquet_rotation_by_records(tmp_path, derived):
    backend = ParquetBackend(tmp_path, max_records_per_chunk=4)
    backend.write_batch(_records(derived, 10))
    paths = backend.close()
    # 10 records with rotation at >=4: chunks of [4..] -> at least 2 completed
    assert len(paths) >= 2
    names = sorted(os.path.basename(p) for p in paths)
    assert names[0] == "chunk_0001.parquet"


def test_storage_output_finish(tmp_path, derived):
    from vuke_tpu_torch.matcher import AddressType, MatchInfo
    out = StorageOutput(ParquetBackend(tmp_path))
    out.key("1", "milksad", derived)
    out.hit("2", "milksad", derived,
            MatchInfo(AddressType.P2PKH_COMPRESSED, derived.p2pkh_compressed))
    summary = out.finish()
    assert summary.records_written == 2
    assert len(summary.paths) == 1
    qe = QueryExecutor(str(tmp_path))
    rows, cols = qe.query(
        "SELECT source, matched_target FROM results ORDER BY source")
    assert len(rows) == 2
    assert rows[1][1] == derived.p2pkh_compressed


def test_query_executor_sql(tmp_path, derived):
    out = StorageOutput(ParquetBackend(tmp_path))
    for i in range(7):
        out.key(str(i), "milksad" if i % 2 else "sha256", derived)
    out.finish()
    qe = QueryExecutor(str(tmp_path))
    n = qe.scalar("SELECT COUNT(*) FROM results")
    assert n == 7
    rows, cols = qe.query(
        "SELECT transform, COUNT(*) AS c FROM results GROUP BY transform "
        "ORDER BY transform")
    assert [r[0] for r in rows] == ["milksad", "sha256"]
    assert sum(r[1] for r in rows) == 7


def test_query_empty_dir(tmp_path):
    qe = QueryExecutor(str(tmp_path))
    rows, cols = qe.query("SELECT * FROM results")
    assert rows == []


def test_query_formatting():
    rows = [("a", 1), ("b", 2)]
    cols = ["name", "n"]
    t = format_results(rows, cols, "table")
    assert "name" in t and "2 row(s)" in t
    import json
    j = json.loads(format_results(rows, cols, "json"))
    assert j[0] == {"name": "a", "n": 1}
    c = format_results(rows, cols, "csv")
    assert c.splitlines()[0] == "name,n"


def test_cloud_sync_in_memory(tmp_path):
    files = []
    for i in range(3):
        d = tmp_path / f"transform=milksad/date=2026-01-01"
        d.mkdir(parents=True, exist_ok=True)
        p = d / f"chunk_{i:04d}.parquet"
        p.write_bytes(b"data" * (i + 1))
        files.append(str(p))
    up = InMemoryUploader()
    cfg = CloudConfig(bucket="test-bucket", prefix="results")
    stats = UploadStats()
    uploaded, failed = sync_files(up, files, str(tmp_path), cfg, stats)
    assert len(uploaded) == 3 and not failed
    assert stats.completed == 3
    # remote keys preserve partition components
    assert any(k.startswith("results/transform=milksad/date=2026-01-01/chunk_")
               for k in up.objects)


def test_cloud_sync_retry_and_failure(tmp_path):
    p = tmp_path / "transform=x/date=y"
    p.mkdir(parents=True)
    f1 = p / "a.parquet"
    f1.write_bytes(b"1")
    f2 = p / "b.parquet"
    f2.write_bytes(b"2")
    key_a = "transform=x/date=y/a.parquet"
    # transient failure: fails twice then succeeds
    up = InMemoryUploader(fail_keys=[key_a], fail_times=2)
    cfg = CloudConfig(bucket="b", max_retries=5, base_retry_delay=0.001)
    stats = UploadStats()
    uploaded, failed = sync_files(up, [str(f1), str(f2)], str(tmp_path), cfg, stats)
    assert len(uploaded) == 2 and not failed
    assert stats.retries >= 2

    # permanent failure: continue-and-report (not fail_fast)
    up = InMemoryUploader(fail_keys=[key_a], fail_times=-1)
    stats = UploadStats()
    uploaded, failed = sync_files(up, [str(f1), str(f2)], str(tmp_path),
                                  CloudConfig(bucket="b", max_retries=1,
                                              base_retry_delay=0.001), stats)
    assert len(failed) == 1 and len(uploaded) == 1


def test_cloud_delete_local(tmp_path):
    p = tmp_path / "transform=x/date=y"
    p.mkdir(parents=True)
    f1 = p / "a.parquet"
    f1.write_bytes(b"1")
    up = InMemoryUploader()
    cfg = CloudConfig(bucket="b", delete_local=True)
    sync_files(up, [str(f1)], str(tmp_path), cfg)
    assert not f1.exists()


def test_cloud_path_url():
    cp = CloudPath("bucket", "k/v.parquet")
    assert cp.url(None) == "s3://bucket/k/v.parquet"
    assert cp.url("https://e.example.com/") == "https://e.example.com/bucket/k/v.parquet"


def test_record_repr_redacts_key(derived):
    r = ResultRecord.from_derived("1", "milksad", derived)
    assert "redacted" in repr(r)
    assert derived.private_key_hex not in repr(r)


def test_iceberg_catalog_flow(tmp_path, derived):
    """REST interactions against a recording fake session."""
    from vuke_tpu_torch.storage.iceberg import (FileMetadata, IcebergConfig,
                                          RestCatalogClient, file_metadata_for)

    class FakeResp:
        def __init__(self, status):
            self.status_code = status
            self.text = ""

    class FakeSession:
        def __init__(self):
            self.calls = []

        def get(self, url, **kw):
            self.calls.append(("GET", url))
            return FakeResp(404)

        def post(self, url, json=None, **kw):
            self.calls.append(("POST", url, json))
            return FakeResp(200)

    sess = FakeSession()
    client = RestCatalogClient(IcebergConfig("http://cat.example/api"), session=sess)
    client.ensure_namespace()
    assert not client.table_exists()
    client.create_table()
    posts = [c for c in sess.calls if c[0] == "POST"]
    assert posts[0][1].endswith("/v1/namespaces")
    assert posts[1][1].endswith("/v1/namespaces/vuke/tables")
    body = posts[1][2]
    assert body["name"] == "results"
    assert len(body["schema"]["fields"]) == 19
    assert body["partition-spec"]["fields"][0]["transform"] == "identity"
    assert body["partition-spec"]["fields"][1]["transform"] == "day"

    # file metadata extraction from hive paths
    backend = ParquetBackend(tmp_path)
    backend.write_batch(_records(derived, 3))
    paths = backend.close()
    metas = file_metadata_for(paths, str(tmp_path))
    assert metas[0].record_count == 3
    assert metas[0].transform == "milksad"
    assert metas[0].timestamp_day is not None


def test_multipart_split_streams_parts(tmp_path):
    """Files over the threshold must upload as multiple streamed parts
   ."""
    big = tmp_path / "big.parquet"
    payload = os.urandom(1024) * 10  # 10 KB
    big.write_bytes(payload)
    small = tmp_path / "small.parquet"
    small.write_bytes(b"tiny")

    up = InMemoryUploader(part_size=4096, multipart_threshold=8192)
    cfg = CloudConfig(bucket="b")
    uploaded, failed = sync_files(up, [str(big), str(small)], str(tmp_path), cfg)
    assert not failed
    assert up.multipart_parts["big.parquet"] == 3  # 10240 / 4096 -> 3 parts
    assert "small.parquet" not in up.multipart_parts
    assert up.objects["big.parquet"] == payload
    assert up.objects["small.parquet"] == b"tiny"


def test_iceberg_registration_carries_real_stats(tmp_path, derived):
    """The CLI tail must register non-zero size/record-count per file
   ."""
    from vuke_tpu_torch.storage.iceberg import join_uploaded_metadata, stat_local_files

    backend = ParquetBackend(tmp_path)
    backend.write_batch(_records(derived, 5))
    paths = backend.close()

    by_key = stat_local_files(paths, str(tmp_path))
    up = InMemoryUploader()
    uploaded, failed = sync_files(up, paths, str(tmp_path),
                                  CloudConfig(bucket="b", delete_local=True))
    assert not failed and not os.path.exists(paths[0])

    metas = join_uploaded_metadata(by_key, uploaded, endpoint=None)
    assert len(metas) == len(uploaded)
    assert metas[0].record_count == 5
    assert metas[0].file_size > 0
    assert metas[0].transform == "milksad"
    assert metas[0].uri.startswith("s3://test-bucket/")


# --- tests/test_storage_vectors.py -----------------------------------------

@pytest.fixture(scope="module")
def vderived():
    return KeyDeriver().derive(b"\xab" * 32)


def _vrecords(vderived, n, transform="sha256", matched=0):
    out = []
    for i in range(n):
        out.append(ResultRecord.from_derived(
            f"source_{i}", transform, vderived,
            matched_target="1TargetAddr" if i < matched else None))
    return out


# --- the Parquet backend ------------------------------------------

class TestParquetBackend:
    def test_new_creates_backend(self, tmp_path):
        b = ParquetBackend(tmp_path)
        assert b.max_records == 1_000_000
        assert b.max_bytes == 100 * 1024 * 1024

    def test_schema_returns_result_schema(self, tmp_path):
        assert ParquetBackend(tmp_path).schema == result_schema()

    def test_with_compression_sets_compression(self, tmp_path):
        assert ParquetBackend(tmp_path, compression="snappy").compression == "SNAPPY"

    def test_default_compression_is_zstd(self, tmp_path):
        b = ParquetBackend(tmp_path)
        assert b.compression == "ZSTD" and b.compression_level == 3

    def test_with_chunk_records_sets_threshold(self, tmp_path):
        assert ParquetBackend(tmp_path, max_records_per_chunk=42).max_records == 42

    def test_with_chunk_bytes_sets_threshold(self, tmp_path):
        assert ParquetBackend(tmp_path, max_bytes_per_chunk=1000).max_bytes == 1000

    def test_zero_threshold_disables_chunking(self, tmp_path):
        b = ParquetBackend(tmp_path, max_records_per_chunk=0,
                           max_bytes_per_chunk=0)
        assert b.max_records is None and b.max_bytes is None

    def test_write_empty_batch_succeeds(self, tmp_path):
        b = ParquetBackend(tmp_path)
        b.write_batch([])
        assert b.close() == []

    def test_write_single_record(self, tmp_path, vderived):
        b = ParquetBackend(tmp_path)
        b.write_batch(_vrecords(vderived, 1))
        paths = b.close()
        assert len(paths) == 1
        assert pq.read_metadata(paths[0]).num_rows == 1

    def test_write_multiple_batches(self, tmp_path, vderived):
        b = ParquetBackend(tmp_path)
        for _ in range(3):
            b.write_batch(_vrecords(vderived, 5))
        paths = b.close()
        assert sum(pq.read_metadata(p).num_rows for p in paths) == 15

    def test_flush_returns_paths(self, tmp_path, vderived):
        b = ParquetBackend(tmp_path)
        b.write_batch(_vrecords(vderived, 2))
        paths = b.close()
        assert all(os.path.exists(p) for p in paths)

    def test_flush_without_write_returns_empty(self, tmp_path):
        assert ParquetBackend(tmp_path).close() == []

    def test_chunk_rotation_by_records(self, tmp_path, vderived):
        b = ParquetBackend(tmp_path, max_records_per_chunk=3)
        b.write_batch(_vrecords(vderived, 10))
        paths = b.close()
        assert len(paths) >= 2

    def test_chunk_rotation_by_bytes(self, tmp_path, vderived):
        b = ParquetBackend(tmp_path, max_records_per_chunk=0,
                           max_bytes_per_chunk=1000)
        for i in range(10):
            b.write_batch(_vrecords(vderived, 1))
        paths = b.close()
        assert len(paths) >= 2, paths

    def test_chunk_paths_returns_completed_chunks(self, tmp_path, vderived):
        b = ParquetBackend(tmp_path, max_records_per_chunk=2)
        b.write_batch(_vrecords(vderived, 5))
        completed = b.chunk_paths()
        assert len(completed) >= 2
        assert all(os.path.exists(p) for p in completed)
        b.close()

    def test_write_and_read_parquet_roundtrip(self, tmp_path, vderived):
        b = ParquetBackend(tmp_path)
        b.write_batch(_vrecords(vderived, 3, matched=1))
        paths = b.close()
        t = pq.read_table(paths[0])
        assert t.num_rows == 3
        assert t.column("source").to_pylist() == [f"source_{i}" for i in range(3)]
        assert t.column("matched_target").to_pylist() == ["1TargetAddr", None, None]
        assert t.column("private_key_raw").to_pylist()[0] == b"\xab" * 32

    def test_compression_affects_file_size(self, tmp_path, vderived):
        d1, d2 = tmp_path / "z", tmp_path / "n"
        recs = _vrecords(vderived, 200)
        bz = ParquetBackend(d1, compression="zstd")
        bz.write_batch(recs)
        bn = ParquetBackend(d2, compression="none")
        bn.write_batch(recs)
        sz = sum(os.path.getsize(p) for p in bz.close())
        sn = sum(os.path.getsize(p) for p in bn.close())
        assert sz < sn

    def test_read_all_chunks_integration(self, tmp_path, vderived):
        b = ParquetBackend(tmp_path, max_records_per_chunk=4)
        b.write_batch(_vrecords(vderived, 10))
        paths = b.close()
        total = sum(pq.read_table(p).num_rows for p in paths)
        assert total == 10

    def test_creates_hive_partitioned_structure(self, tmp_path, vderived):
        b = ParquetBackend(tmp_path)
        b.write_batch(_vrecords(vderived, 1, transform="milksad"))
        (path,) = b.close()
        rel = os.path.relpath(path, tmp_path)
        parts = rel.split(os.sep)
        assert parts[0] == "transform=milksad"
        assert parts[1].startswith("date=")
        assert parts[2].startswith("chunk_") and parts[2].endswith(".parquet")


# --- the query executor ---------------------------------------------

def _make_storage(path, vderived, n, matched=0, transform="sha256"):
    b = ParquetBackend(path)
    b.write_batch(_vrecords(vderived, n, transform=transform, matched=matched))
    return b.close()


class TestQueryExecutor:
    def test_new_creates_executor_with_empty_storage(self, tmp_path):
        ex = QueryExecutor(tmp_path)
        assert not ex.has_data()

    def test_new_creates_executor_with_data(self, tmp_path, vderived):
        _make_storage(tmp_path, vderived, 5)
        assert QueryExecutor(tmp_path).has_data()

    def test_query_count_returns_correct_count(self, tmp_path, vderived):
        _make_storage(tmp_path, vderived, 10)
        ex = QueryExecutor(tmp_path)
        assert ex.scalar("SELECT COUNT(*) FROM results") == 10

    def test_query_empty_storage_returns_empty(self, tmp_path):
        rows, _ = QueryExecutor(tmp_path).query("SELECT * FROM results")
        assert rows == []

    def test_query_with_transform_filter(self, tmp_path, vderived):
        _make_storage(tmp_path, vderived, 4, transform="sha256")
        _make_storage(tmp_path, vderived, 3, transform="milksad")
        ex = QueryExecutor(tmp_path)
        assert ex.scalar(
            "SELECT COUNT(*) FROM results WHERE transform = 'milksad'") == 3

    def test_query_group_by_transform(self, tmp_path, vderived):
        _make_storage(tmp_path, vderived, 4, transform="sha256")
        _make_storage(tmp_path, vderived, 3, transform="milksad")
        rows, _ = QueryExecutor(tmp_path).query(
            "SELECT transform, COUNT(*) FROM results GROUP BY transform "
            "ORDER BY transform")
        assert [(r[0], int(r[1])) for r in rows] == [
            ("milksad", 3), ("sha256", 4)]

    def test_query_matched_targets_not_null(self, tmp_path, vderived):
        _make_storage(tmp_path, vderived, 10, matched=3)
        ex = QueryExecutor(tmp_path)
        assert ex.scalar(
            "SELECT COUNT(*) FROM results WHERE matched_target IS NOT NULL") == 3

    def test_query_returns_rows_and_columns(self, tmp_path, vderived):
        # analogue of query_arrow_returns_record_batches
        _make_storage(tmp_path, vderived, 5)
        rows, cols = QueryExecutor(tmp_path).query(
            "SELECT source, transform FROM results")
        assert len(rows) == 5 and cols == ["source", "transform"]

    def test_discovered_files_lists_parquet_files(self, tmp_path, vderived):
        _make_storage(tmp_path, vderived, 5)
        files = QueryExecutor(tmp_path).discovered_files()
        assert files and all(f.endswith(".parquet") for f in files)

    def test_schema_returns_result_schema(self, tmp_path, vderived):
        _make_storage(tmp_path, vderived, 1)
        text = QueryExecutor(tmp_path).schema_text()
        assert "results" in text and "private_key_hex" in text

    def test_schema_empty_storage(self, tmp_path):
        text = QueryExecutor(tmp_path).schema_text()
        assert "results" in text

    def test_refresh_updates_view(self, tmp_path, vderived):
        ex = QueryExecutor(tmp_path)
        assert not ex.has_data()
        _make_storage(tmp_path, vderived, 5)
        ex.refresh()
        assert ex.has_data()
        assert ex.scalar("SELECT COUNT(*) FROM results") == 5

    def test_storage_path_returns_path(self, tmp_path):
        assert QueryExecutor(tmp_path).directory == str(tmp_path)


# --- the records ------------------------------------------------

class TestRecords:
    def test_result_record_creation(self, vderived):
        r = ResultRecord.from_derived("1", "sha256", vderived)
        assert r.source == "1" and r.transform == "sha256"
        assert r.chain == "bitcoin"
        assert len(r.private_key_raw) == 32
        assert r.private_key_hex == vderived.private_key_hex
        assert r.timestamp is not None
        assert r.timestamp.tzinfo is not None

    def test_result_record_matched_target(self, vderived):
        r = ResultRecord.from_derived("1", "sha256", vderived,
                                      matched_target="1Addr")
        assert r.matched_target == "1Addr"

    def test_record_address_fields(self, vderived):
        r = ResultRecord.from_derived("1", "sha256", vderived)
        assert r.address_p2pkh_compressed == vderived.p2pkh_compressed
        assert r.address_p2pkh_uncompressed == vderived.p2pkh_uncompressed
        assert r.address_p2wpkh == vderived.p2wpkh
        assert r.wif_compressed == vderived.wif_compressed
        assert r.wif_uncompressed == vderived.wif_uncompressed

    def test_record_stat_fields(self, vderived):
        r = ResultRecord.from_derived("1", "sha256", vderived)
        assert r.private_key_bit_length == vderived.bit_length
        assert r.private_key_hamming_weight == vderived.hamming_weight
        assert r.private_key_leading_zeros == vderived.leading_zeros

    def test_debug_redacts_sensitive_data(self, vderived):
        r = ResultRecord.from_derived("1", "sha256", vderived)
        s = repr(r)
        assert "<redacted>" in s
        assert vderived.private_key_hex not in s
        assert vderived.wif_compressed not in s
        assert vderived.private_key_decimal not in s


# --- the storage output ----------------------------------------------

class TestStorageOutput:
    def test_write_single_key(self, tmp_path, vderived):
        out = StorageOutput(ParquetBackend(tmp_path))
        out.key("1", "sha256", vderived)
        summary = out.finish()
        assert summary.records_written == 1
        assert len(summary.paths) == 1

    def test_write_multiple_keys(self, tmp_path, vderived):
        out = StorageOutput(ParquetBackend(tmp_path))
        for i in range(7):
            out.key(str(i), "sha256", vderived)
        assert out.finish().records_written == 7

    def test_write_hit_with_matched_target(self, tmp_path, vderived):
        class MI:
            address = "1SomeTarget"
            address_type = "p2pkh_compressed"
        out = StorageOutput(ParquetBackend(tmp_path))
        out.hit("5", "milksad", vderived, MI())
        summary = out.finish()
        t = pq.read_table(summary.paths[0])
        assert t.column("matched_target").to_pylist() == ["1SomeTarget"]

    def test_chunk_rotation(self, tmp_path, vderived):
        out = StorageOutput(ParquetBackend(tmp_path, max_records_per_chunk=2))
        for i in range(5):
            out.key(str(i), "sha256", vderived)
        assert len(out.finish().paths) >= 2

    def test_records_written_counter(self, tmp_path, vderived):
        out = StorageOutput(ParquetBackend(tmp_path))
        for i in range(3):
            out.key(str(i), "sha256", vderived)
        out.flush()
        assert out.finish().records_written == 3

    def test_custom_chain(self, tmp_path, vderived):
        out = StorageOutput(ParquetBackend(tmp_path))
        out.key("1", "sha256", vderived)
        summary = out.finish()
        t = pq.read_table(summary.paths[0])
        assert t.column("chain").to_pylist() == ["bitcoin"]

    def test_shared_backend_shares_state(self, tmp_path, vderived):
        backend = ParquetBackend(tmp_path)
        a, b = StorageOutput(backend), StorageOutput(backend)
        a.key("1", "sha256", vderived)
        b.key("2", "sha256", vderived)
        a.flush(), b.flush()
        paths = backend.close()
        assert sum(pq.read_table(p).num_rows for p in paths) == 2

    def test_with_compression_creates_smaller_files(self, tmp_path, vderived):
        o1 = StorageOutput(ParquetBackend(tmp_path / "z", compression="zstd"))
        o2 = StorageOutput(ParquetBackend(tmp_path / "n", compression="none"))
        for i in range(200):
            o1.key(str(i), "sha256", vderived)
            o2.key(str(i), "sha256", vderived)
        s1, s2 = o1.finish(), o2.finish()
        assert (sum(os.path.getsize(p) for p in s1.paths)
                < sum(os.path.getsize(p) for p in s2.paths))


# --- the Arrow schema ---------------------------

class TestArrowSchema:
    def test_schema_has_19_fields(self):
        assert len(result_schema()) == 19

    def test_schema_field_names(self):
        assert result_schema().names == [
            "source", "transform", "chain", "timestamp", "matched_target",
            "private_key_raw", "private_key_hex", "private_key_decimal",
            "private_key_binary", "private_key_bit_length",
            "private_key_hamming_weight", "private_key_leading_zeros",
            "pubkey_compressed", "pubkey_uncompressed",
            "address_p2pkh_compressed", "address_p2pkh_uncompressed",
            "address_p2wpkh", "wif_compressed", "wif_uncompressed"]

    def test_schema_field_types(self):
        import pyarrow as pa
        s = result_schema()
        for i in (0, 1, 2, 4, 6, 7, 8):
            assert s.field(i).type == pa.string()
        assert s.field(3).type == pa.timestamp("ms", tz="UTC")
        assert s.field(5).type == pa.binary(32)
        assert s.field(9).type == pa.uint16()
        assert s.field(10).type == pa.uint16()
        assert s.field(11).type == pa.uint8()
        for i in range(12, 19):
            assert s.field(i).type == pa.string()

    def test_schema_nullable_flags(self):
        s = result_schema()
        for i in (0, 1, 2, 3, 5, 6, 7, 8, 9, 10, 11):
            assert not s.field(i).nullable, i
        for i in (4, 12, 13, 14, 15, 16, 17, 18):
            assert s.field(i).nullable, i

    def test_records_to_batch_empty(self):
        from vuke_tpu_torch.storage.records import records_to_batch
        assert records_to_batch([]).num_rows == 0

    def test_records_to_batch_single_record(self, vderived):
        from vuke_tpu_torch.storage.records import records_to_batch
        batch = records_to_batch(_vrecords(vderived, 1))
        assert batch.num_rows == 1
        assert batch.column(0).to_pylist() == ["source_0"]

    def test_records_to_batch_matched_target_null_and_set(self, vderived):
        from vuke_tpu_torch.storage.records import records_to_batch
        batch = records_to_batch(_vrecords(vderived, 2, matched=1))
        assert batch.column(4).to_pylist() == ["1TargetAddr", None]

    def test_records_to_batch_empty_slices(self, vderived):
        from vuke_tpu_torch.storage.records import records_to_batch
        r = _vrecords(vderived, 1)[0]
        r.pubkey_compressed = None
        r.address_p2pkh_compressed = None
        r.wif_uncompressed = None
        batch = records_to_batch([r])
        assert batch.column(12).to_pylist() == [None]
        assert batch.column(14).to_pylist() == [None]
        assert batch.column(18).to_pylist() == [None]

    def test_records_to_batch_multiple_records(self, vderived):
        from vuke_tpu_torch.storage.records import records_to_batch
        batch = records_to_batch(_vrecords(vderived, 5))
        assert batch.num_rows == 5
        assert batch.column(5).to_pylist() == [b"\xab" * 32] * 5


# --- the Iceberg schema ---------------------------------------

class TestIcebergSchema:
    def _fields(self):
        from vuke_tpu_torch.storage.iceberg import iceberg_schema_json
        return iceberg_schema_json()["fields"]

    def test_build_schema_succeeds(self):
        fields = self._fields()
        assert len(fields) == 19

    def test_schema_field_names_match_arrow(self):
        assert [f["name"] for f in self._fields()] == result_schema().names

    def test_required_fields_not_nullable(self):
        req = {f["name"] for f in self._fields() if f["required"]}
        arrow_req = {f.name for f in result_schema() if not f.nullable}
        assert req == arrow_req

    def test_private_key_raw_is_binary(self):
        (f,) = [f for f in self._fields() if f["name"] == "private_key_raw"]
        assert f["type"] == "binary" and f["required"]

    def test_timestamp_is_timestamptz(self):
        (f,) = [f for f in self._fields() if f["name"] == "timestamp"]
        assert f["type"] == "timestamptz"

    def test_field_ids_sequential(self):
        assert [f["id"] for f in self._fields()] == list(range(1, 20))

    def test_partition_spec_source_ids(self):
        # identity(transform)=field 2, day(timestamp)=field 4
        from vuke_tpu_torch.storage.iceberg import partition_spec_json
        spec = partition_spec_json()["fields"]
        assert spec[0]["transform"] == "identity" and spec[0]["source-id"] == 2
        assert spec[1]["transform"] == "day" and spec[1]["source-id"] == 4


# --- the cloud config ----------------------

class TestCloudConfig:
    def test_cloud_config_defaults(self):
        from vuke_tpu_torch.storage.cloud import CloudConfig
        c = CloudConfig(bucket="test-bucket")
        assert c.bucket == "test-bucket"
        assert c.endpoint is None and c.prefix is None
        assert not c.delete_local
        assert c.max_retries == 5
        assert not c.fail_fast

    def test_cloud_config_builder(self):
        from vuke_tpu_torch.storage.cloud import CloudConfig
        c = CloudConfig(bucket="my-bucket", endpoint="https://s3.example.com",
                        prefix="vuke/results", delete_local=True,
                        max_retries=3, fail_fast=True)
        assert (c.bucket, c.endpoint, c.prefix) == (
            "my-bucket", "https://s3.example.com", "vuke/results")
        assert c.delete_local and c.fail_fast and c.max_retries == 3

    def test_cloud_path_url_with_endpoint(self):
        from vuke_tpu_torch.storage.cloud import CloudPath
        assert (CloudPath("bucket", "a/b.parquet").url("https://e.com")
                == "https://e.com/bucket/a/b.parquet")

    def test_cloud_path_url_without_endpoint(self):
        from vuke_tpu_torch.storage.cloud import CloudPath
        assert CloudPath("bucket", "k").url() == "s3://bucket/k"

    def test_cloud_path_url_strips_trailing_slash(self):
        from vuke_tpu_torch.storage.cloud import CloudPath
        assert (CloudPath("bucket", "file.parquet").url("https://example.com/")
                == "https://example.com/bucket/file.parquet")


# --- the port against the JAX package ---------------------------------------

STAMP = dt.datetime(2026, 1, 2, 3, 4, 5, 678000, tzinfo=dt.timezone.utc)


@pytest.fixture
def jax_points(monkeypatch):
    """The JAX ``KeyDeriver`` with the port's public point (the JAX package's
    bignum ``ref.point_mul`` is an affine ladder, ~70 ms a key where its
    native one is not built); the encodings stay the JAX package's."""
    monkeypatch.setattr(jderive, "_pubkey_point", lambda k, key: ref.point_mul(k))


def _seeded_keys(n: int, seed: int = 10) -> list:
    rng = np.random.default_rng(seed)
    return [rng.bytes(32) for _ in range(n)]


def _both_records(keys, transforms=("sha256",), matched=()):
    """The same records as the JAX package's ``ResultRecord``s and the
    port's, with one timestamp."""
    jd, pd = jderive.KeyDeriver(), KeyDeriver()
    jax_recs, port_recs = [], []
    for i, key in enumerate(keys):
        t = transforms[i % len(transforms)]
        m = "1Target" if i in matched else None
        jax_recs.append(jrecords.ResultRecord.from_derived(str(i), t, jd.derive(key), m))
        port_recs.append(ResultRecord.from_derived(str(i), t, pd.derive(key), m))
        jax_recs[-1].timestamp = port_recs[-1].timestamp = STAMP
    return jax_recs, port_recs


def _tables(paths, base):
    return [(os.path.relpath(p, base), pq.read_table(p).drop_columns(["timestamp"]))
            for p in paths]


def test_schema_equals_the_jax_schema():
    assert result_schema() == jrecords.result_schema()
    assert [(f.name, f.type, f.nullable) for f in result_schema()] == [
        (f.name, f.type, f.nullable) for f in jrecords.result_schema()]


@pytest.mark.parametrize("limits", [{"max_records_per_chunk": 100},
                                    {"max_records_per_chunk": 0, "max_bytes_per_chunk": 30_000}],
                         ids=["max_records_100", "max_bytes_30000"])
def test_backends_write_the_same_chunks(tmp_path, jax_points, limits):
    """The same records through the JAX ``ParquetBackend`` and the port's,
    in the same batches: the same chunk files, tables equal without
    ``timestamp``; the files' bytes equal too (one timestamp for both)."""
    jax_recs, port_recs = _both_records(_seeded_keys(300), ("sha256", "milksad"), {7})
    jb = jstorage.ParquetBackend(tmp_path / "jax", **limits)
    pb = ParquetBackend(tmp_path / "port", **limits)
    for a in range(0, 300, 70):
        jb.write_batch(jax_recs[a:a + 70])
        pb.write_batch(port_recs[a:a + 70])
    jt, pt = _tables(jb.close(), tmp_path / "jax"), _tables(pb.close(), tmp_path / "port")
    assert len(jt) > 3 and [p for p, _ in jt] == [p for p, _ in pt]
    for (_, a), (_, b) in zip(jt, pt):
        assert a.equals(b)
    assert sum(t.num_rows for _, t in pt) == 300


def _block(keys, network=None):
    """A ``RecordBlock`` of ``keys`` (normalized) through the plain E1."""
    import torch
    from vuke_tpu_torch import encode

    network = network or encode.BITCOIN
    ks = [int.from_bytes(jderive.normalize_key(k), "big") for k in keys]
    pts = [ref.point_mul(k) for k in ks]
    words = lambda v: [(v >> (32 * (7 - j))) & 0xFFFFFFFF for j in range(8)]  # noqa: E731
    norm = np.array([words(k) for k in ks], dtype=np.uint32)
    x = np.array([words(p[0]) for p in pts], dtype=np.uint32)
    y = np.array([words(p[1]) for p in pts], dtype=np.uint32)
    hc, hu = [], []
    for px, py in pts:
        xb = px.to_bytes(32, "big")
        hc.append(np.frombuffer(jderive.encode.hash160(bytes([2 + (py & 1)]) + xb), "<u4"))
        hu.append(np.frombuffer(jderive.encode.hash160(b"\x04" + xb + py.to_bytes(32, "big")),
                                "<u4"))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.uint32).T)  # noqa: E731
                                   .view(np.int32)).view(torch.uint32)
    rows = rec.encode_records(t(norm), t(hc), t(hu), network).numpy()
    return rec.RecordBlock("sha256", [f"s{i}" for i in range(len(keys))], norm, x, y, rows)


def test_column_batch_equals_records_to_batch(jax_points):
    """The column-buffer batch of a block equals the JAX package's
    ``records_to_batch`` of its ``ResultRecord``s, without ``timestamp``;
    its timestamp is the one given, for every record."""
    keys = _seeded_keys(40, 11) + [b"\x00" * 31 + b"\x01", b"\x00" * 32, b"\xff" * 32]
    got = _block(keys).record_batch(STAMP)
    jd = jderive.KeyDeriver()
    want = jrecords.records_to_batch([jrecords.ResultRecord.from_derived(
        f"s{i}", "sha256", jd.derive(k)) for i, k in enumerate(keys)])
    assert got.schema == want.schema
    drop = lambda b: pa.Table.from_batches([b]).drop_columns(["timestamp"])  # noqa: E731
    assert drop(got).equals(drop(want))
    assert set(got.column("timestamp").to_pylist()) == {STAMP}


def test_column_batch_of_source_rows(jax_points):
    """Sources as NUL-padded rows (the generate driver's) give the same
    column as the strings."""
    from vuke_tpu_torch.pipeline import source_rows

    block = _block(_seeded_keys(6, 12))
    strings = [f"{12345678901234 + i // 2}" for i in range(6)]
    rows = source_rows(12345678901234, 3, ["", ""])
    a = rec.RecordBlock("t", strings, block.norm, block.x, block.y, block.rows)
    b = rec.RecordBlock("t", rows, block.norm, block.x, block.y, block.rows)
    assert a.record_batch(STAMP).equals(b.record_batch(STAMP))
    assert b.source_strings() == strings


def test_storage_output_buffers_as_the_jax_one(tmp_path, jax_points):
    """``key_columns`` blocks and single ``key``s interleaved across two
    transforms: the same chunk files as the JAX ``StorageOutput``'s ``key``
    of each record in the same order, the 4096-record flushes included."""
    keys = _seeded_keys(24, 13)
    block = _block(keys)
    jd = jderive.KeyDeriver()
    jax_out = jstorage.StorageOutput(jstorage.ParquetBackend(tmp_path / "jax",
                                                             max_records_per_chunk=5000))
    port_out = StorageOutput(ParquetBackend(tmp_path / "port", max_records_per_chunk=5000))
    derived = [jd.derive(k) for k in keys]
    for rnd in range(360):                   # 360 blocks of 24 records: 8640, two flushes
        t = "sha256" if rnd % 3 else "milksad"
        b = rec.RecordBlock(t, block.sources, block.norm, block.x, block.y, block.rows)
        port_out.key_columns(b)
        for s, d in zip(block.sources, derived):
            jax_out.key(s, t, d)
        if rnd == 100:
            port_out.key("one", "md5", KeyDeriver().derive(keys[0]))
            jax_out.key("one", "md5", derived[0])
    js, ps = jax_out.finish(), port_out.finish()
    assert js.records_written == ps.records_written == 360 * 24 + 1
    jt, pt = _tables(js.paths, tmp_path / "jax"), _tables(ps.paths, tmp_path / "port")
    assert [p for p, _ in jt] == [p for p, _ in pt]
    for (_, a), (_, b) in zip(jt, pt):
        assert a.equals(b)
    # a row group a flush, as the JAX package writes them
    assert ([pq.ParquetFile(p).metadata.num_row_groups for p in js.paths]
            == [pq.ParquetFile(p).metadata.num_row_groups for p in ps.paths])


QUERY_ROWS = [
    ("a", 1, None, b"\x00\xff", 1.5),
    ("x" * 70, -2, "c,d", b"", float("nan")),
    ("é\"q", 3, "", b"\x01", float("inf")),
]
QUERY_COLS = ["name", "n", "opt", "raw", "f"]


@pytest.mark.parametrize("fmt", ["table", "json", "csv", "TABLE", "Json"])
@pytest.mark.parametrize("rows", [QUERY_ROWS, QUERY_ROWS[:1], [],
                                  [(STAMP, dt.datetime(2020, 5, 6, 7, 8, 9))]],
                         ids=["mixed", "one", "empty", "timestamps"])
def test_query_formats_are_the_jax_ones(fmt, rows):
    cols = QUERY_COLS if not rows or len(rows[0]) == 5 else ["t", "naive"]
    assert format_results(rows, cols, fmt) == jquery.format_results(rows, cols, fmt)


def test_query_format_errors_and_schema_are_the_jax_ones():
    with pytest.raises(ValueError) as a:
        pquery.parse_output_format("xml")
    with pytest.raises(ValueError) as b:
        jquery.parse_output_format("xml")
    assert str(a.value) == str(b.value)
    assert format_results([], [], "table") == jquery.format_results([], [], "table")
    assert pquery.format_schema(result_schema()) == jquery.format_schema(jrecords.result_schema())


def test_query_sqlite_fallback(tmp_path, derived):
    """Without duckdb the executor loads every row into sqlite (the Hive
    partitions as columns, timestamps as their ISO text) and answers the
    JAX executor's answers."""
    assert pquery._duckdb() is None
    out = StorageOutput(ParquetBackend(tmp_path))
    for i in range(9):
        out.key(str(i), ("sha256", "milksad", "md5")[i % 3], derived)
    out.finish()
    ex, jx = QueryExecutor(tmp_path), jquery.QueryExecutor(str(tmp_path))
    assert not ex._duck and ex.has_data()
    for sql in ("SELECT transform, COUNT(*) AS c FROM results GROUP BY transform ORDER BY c, "
                "transform", "SELECT source, private_key_raw, date FROM results ORDER BY source",
                "SELECT COUNT(*) FROM results WHERE matched_target IS NULL",
                "SELECT timestamp, MIN(timestamp) OVER () FROM results ORDER BY source"):
        assert ex.query(sql) == jx.query(sql)
    assert ex.schema_text() == jx.schema_text()


def test_cloud_fail_fast_stops_scheduling(tmp_path):
    """fail_fast: after the first failed upload nothing more is scheduled
    (concurrency 1), and ``sync_to_cloud`` exits with the reference's
    message after its summary lines."""
    from vuke_tpu_torch.storage.cloud import sync_to_cloud

    d = tmp_path / "transform=x" / "date=y"
    d.mkdir(parents=True)
    files = []
    for i in range(4):
        f = d / f"chunk_{i:04d}.parquet"
        f.write_bytes(b"z" * (i + 1))
        files.append(str(f))
    up = InMemoryUploader(fail_keys=["transform=x/date=y/chunk_0001.parquet"], fail_times=-1)
    cfg = CloudConfig(bucket="b", max_retries=1, base_retry_delay=0.001, fail_fast=True,
                      concurrency=1)
    stats = UploadStats()
    uploaded, failed = sync_files(up, files, str(tmp_path), cfg, stats)
    assert [c.key for c in uploaded] == ["transform=x/date=y/chunk_0000.parquet"]
    assert failed == files[1:] and stats.failed == 1 and stats.retries == 1
    up2 = InMemoryUploader(fail_keys=["transform=x/date=y/chunk_0000.parquet"], fail_times=-1)
    with pytest.raises(SystemExit, match="cloud upload failed"):
        sync_to_cloud(files, str(tmp_path), cfg, uploader=up2)


def test_sync_to_cloud_reports_as_the_jax_one(tmp_path, capsys):
    """The injected uploader's summary and URLs on stderr, equal to the JAX
    ``sync_to_cloud``'s; a missing bucket stops before any upload."""
    from vuke_tpu.storage.cloud import CloudConfig as JCloudConfig
    from vuke_tpu.storage.cloud import sync_to_cloud as jsync
    from vuke_tpu.storage.cloud.s3 import InMemoryUploader as JInMemory
    from vuke_tpu_torch.storage.cloud import sync_to_cloud

    d = tmp_path / "transform=x" / "date=y"
    d.mkdir(parents=True)
    f = d / "chunk_0001.parquet"
    f.write_bytes(b"abc")
    cfg = dict(bucket="b", prefix="p", endpoint="https://e.example")
    got = sync_to_cloud([str(f)], str(tmp_path), CloudConfig(**cfg), uploader=InMemoryUploader())
    port_err = capsys.readouterr().err
    want = jsync([str(f)], str(tmp_path), JCloudConfig(**cfg), uploader=JInMemory())
    assert port_err == capsys.readouterr().err
    assert [c.url(cfg["endpoint"]) for c in got] == [c.url(cfg["endpoint"]) for c in want]
    assert sync_to_cloud([str(f)], str(tmp_path), CloudConfig()) == []
    assert "no bucket configured" in capsys.readouterr().err


class _FakeResp:
    def __init__(self, status):
        self.status_code = status
        self.text = ""


class _FakeSession:
    def __init__(self):
        self.calls = []

    def get(self, url, **kw):
        self.calls.append(("GET", url))
        return _FakeResp(404)

    def post(self, url, json=None, **kw):
        self.calls.append(("POST", url, json))
        return _FakeResp(200)


def test_iceberg_append_needs_pyiceberg(tmp_path, derived):
    """Without pyiceberg the namespace and table are created and the append
    raises the JAX package's error text; the calls are the JAX client's."""
    from vuke_tpu.storage import iceberg as jice
    from vuke_tpu_torch.storage import iceberg as pice

    backend = ParquetBackend(tmp_path)
    backend.write_batch(_records(derived, 3))
    metas = pice.file_metadata_for(backend.close(), str(tmp_path))
    errors, calls = [], []
    for mod in (pice, jice):
        sess = _FakeSession()
        client = mod.RestCatalogClient(mod.IcebergConfig("http://cat.example/api"),
                                       session=sess)
        with pytest.raises(RuntimeError) as e:
            client.register_parquet_files(metas)
        errors.append(str(e.value))
        calls.append(sess.calls)
    assert errors[0] == errors[1] and "requires pyiceberg" in errors[0]
    assert calls[0] == calls[1]
    assert pice.iceberg_schema_json() == jice.iceberg_schema_json()
    assert pice.partition_spec_json() == jice.partition_spec_json()
    assert pice.RestCatalogClient(pice.IcebergConfig("u"), session=_FakeSession()
                                  ).register_parquet_files([]).files_registered == 0
