"""The storage and query tail of the port's command line against the JAX
package's, on the CPU (the port's plain versions, ``--device cpu``).

- ``generate --storage``: the Parquet files, chunk for chunk, equal
  (without ``timestamp``) to what the JAX package's ``StorageOutput``
  writes for the same records in the JAX order, each built with
  ``ResultRecord.from_derived(KeyDeriver().derive(key))`` from the keys of
  the port's plain keygen (held against the JAX transforms in
  ``tests/test_torch_keygen.py``); no JAX ``generate`` runs here.  Stdout
  is the run's without ``--storage``; stderr ends in the ``Storage:``
  lines.
- ``scan --storage`` with a planted hit, ``--cloud-upload`` through an
  injected in-memory uploader and ``--iceberg-catalog`` through a fake
  session (no network), and ``query``: stdout, stderr and exit codes
  against the JAX click command (``CliRunner``, host-only paths).
- Every storage, cloud and Iceberg option and ``query`` run: none says
  "not ported yet".
"""

import os

import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import requests
from click.testing import CliRunner

import vuke_tpu.derive as jderive
import vuke_tpu.storage as jstorage
import vuke_tpu.storage.cloud.s3 as js3
from vuke_tpu.cli import cli as jcli
from vuke_tpu_torch import cli
from vuke_tpu_torch.derive import KeyDeriver
from vuke_tpu_torch.ecc import ref
from vuke_tpu_torch.storage.cloud import s3 as ps3
from vuke_tpu_torch.transforms import parse_transform

START = 1000


def jax_run(argv):
    res = CliRunner().invoke(jcli, argv)
    assert res.exception is None or isinstance(res.exception, SystemExit), res.exception
    return res.exit_code, res.stdout, res.stderr


def port_run(argv, capsys):
    """(exit code, stdout, stderr) of the port's command line; a usage
    error's ``SystemExit`` gives its code."""
    capsys.readouterr()
    try:
        rc = cli.main(argv)
    except SystemExit as e:
        rc = e.code
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.fixture(autouse=True)
def host_points(monkeypatch):
    """The JAX ``KeyDeriver`` with the port's public point (its own bignum
    ladder is affine, ~70 ms a key where the native one is not built)."""
    monkeypatch.setattr(jderive, "_pubkey_point", lambda k, key: ref.point_mul(k))


def jax_generate_storage(directory, transforms, n, **backend):
    """The JAX package's ``StorageOutput`` fed the records of ``generate``
    over seeds START .. START + n - 1 in the JAX order (one superbatch: per
    transform, per seed, per valid slot); returns its chunk paths."""
    import torch

    out = jstorage.StorageOutput(jstorage.ParquetBackend(directory, **backend))
    deriver = jderive.KeyDeriver()
    seeds = torch.arange(START, START + n, dtype=torch.int64)
    hi, lo = (seeds >> 32).to(torch.uint32), (seeds & 0xFFFFFFFF).to(torch.uint32)
    for name in transforms:
        spec = parse_transform(name)
        keys, valid = spec.numeric.keygen(hi, lo, plain=True)
        keys = keys.to(torch.int64).numpy()
        for i in range(n):
            for s, label in enumerate(spec.numeric.slots):
                if valid[s, i]:
                    key = keys[s, :, i].astype(">u4").tobytes()
                    out.key(f"{START + i}{label}", spec.name, deriver.derive(key))
    return out.finish().paths


def tables(paths, base):
    return [(os.path.relpath(p, base), pq.read_table(p).drop_columns(["timestamp"]))
            for p in paths]


def storage_lines(paths) -> str:
    """The ``Storage:`` lines the JAX command line prints for ``paths``."""
    from vuke_tpu.cli import _format_bytes

    sizes = [os.path.getsize(p) for p in paths]
    return (f"\nStorage: {len(paths)} files written ({_format_bytes(sum(sizes))})\n"
            + "".join(f"  {p} ({_format_bytes(s)})\n" for p, s in zip(paths, sizes)))


@pytest.mark.parametrize("transforms,extra", [
    (["sha256"], ["--chunk-records", "100"]),
    (["sha256", "milksad"], ["--chunk-records", "100"]),
    (["md5", "sha256"], ["--compression", "gzip", "--compression-level", "9"]),
], ids=["sha256-100", "sha256-milksad-100", "md5-sha256-gzip"])
def test_generate_storage_writes_the_jax_records(tmp_path, capsys, transforms, extra):
    d = str(tmp_path / "port")
    base = ["generate", "--device", "cpu", "--batch", "64"]
    for t in transforms:
        base += ["--transform", t]
    src = ["range", "--start", str(START), "--end", str(START + 63)]
    rc, out, err = port_run(base + ["--storage", d] + extra + src, capsys)
    assert rc == 0 and out.count("\n") == 64 * sum(3 if t == "sha256" else 1 for t in transforms)
    assert (rc, out) == port_run(base + src, capsys)[:2]
    paths = sorted(str(p) for p in (tmp_path / "port").rglob("*.parquet"))
    order = [p for p in err.split("\n") if p.startswith("  ")]
    assert err.endswith(storage_lines([o.strip().rsplit(" (", 1)[0] for o in order]))
    assert sorted(o.strip().rsplit(" (", 1)[0] for o in order) == paths
    limits = {"max_records_per_chunk": 100} if "--chunk-records" in extra else {}
    if "gzip" in extra:
        limits.update(compression="gzip", compression_level=9)
    want = jax_generate_storage(tmp_path / "jax", transforms, 64, **limits)
    got = [o.strip().rsplit(" (", 1)[0] for o in order]
    jt, pt = tables(want, tmp_path / "jax"), tables(got, tmp_path / "port")
    assert [p for p, _ in pt] == [p for p, _ in jt]
    for (_, a), (_, b) in zip(pt, jt):
        assert a.equals(b)
    if "gzip" in extra:
        assert pq.ParquetFile(got[0]).metadata.row_group(0).column(0).compression == "GZIP"


def test_generate_verbose_with_storage(tmp_path, capsys):
    """``-v`` blocks and the records from the same E1 rows: the blocks are
    those of the run without ``--storage``."""
    d = str(tmp_path / "st")
    argv = ["generate", "--device", "cpu", "-v", "--transform", "md5", "--batch", "64", "range",
            "--start", "7", "--end", "70"]
    rc, out, err = port_run(argv[:1] + ["--storage", d] + argv[1:], capsys)
    assert (rc, out) == port_run(argv, capsys)[:2]
    (path,) = [str(p) for p in (tmp_path / "st").rglob("*.parquet")]
    t = pq.read_table(path)
    assert t.num_rows == 64 and out.count("---\nsource: ") == 64
    assert f"p2wpkh: {t.column('address_p2wpkh')[5]}\n" in out


def test_wordlist_generate_storage(tmp_path, capsys):
    """String sources through E1: the lines with ``--storage`` are those
    without it, one record a line, in their order."""
    words = tmp_path / "w.txt"
    words.write_text("".join(f"word{i}\n" for i in range(40)))
    base = ["generate", "--device", "cpu", "--transform", "md5", "--transform", "sha256"]
    src = ["wordlist", "--file", str(words)]
    rc, out, err = port_run(base + ["--storage", str(tmp_path / "st")] + src, capsys)
    assert rc == 0 and (rc, out) == port_run(base + src, capsys)[:2]
    lines = out.splitlines()
    t = pa.concat_tables(pq.read_table(p) for p in sorted((tmp_path / "st").rglob("*.parquet")))
    assert t.num_rows == len(lines) == 80
    got = sorted(zip(*(t.column(c).to_pylist() for c in (
        "source", "transform", "private_key_hex", "address_p2pkh_compressed"))))
    assert got == sorted(tuple(line.split(",")) for line in lines)


def scan_targets(tmp_path):
    """A target file with the address of seed START + 17's ``[be]``-slot
    sha256 key (the slot labels are empty for sha256) and two decoys."""
    import hashlib

    key = hashlib.sha256((START + 17).to_bytes(8, "big")).digest()
    addr = KeyDeriver().derive(key).p2pkh_compressed
    path = tmp_path / "t.txt"
    path.write_text(f"1BgGZ9tcN4rm9KBzDn7KprQz87SZ26SAMH\n{addr}\n"
                    "1CUNEBjYrCn2y1SdiUMohaKUi4wpP326Lb\n")
    return str(path), addr


def relative(text: str, base) -> str:
    return text.replace(str(base), "<dir>")


def test_scan_storage_writes_the_hit(tmp_path, capsys):
    """One record, ``matched_target`` set, equal to the JAX command's
    (without ``timestamp``); stdout and stderr equal, the chunk's size
    included (one record, one timestamp each)."""
    targets, addr = scan_targets(tmp_path)
    argv = ["scan", "--transform", "sha256", "--targets", targets, "--batch", "64"]
    src = ["range", "--start", str(START), "--end", str(START + 63)]
    got = port_run(argv[:1] + ["--device", "cpu"] + argv[1:] + ["--storage",
                                                                 str(tmp_path / "p")] + src,
                   capsys)
    want = jax_run(argv + ["--storage", str(tmp_path / "j")] + src)
    assert got[:2] == want[:2] and got[0] == 0
    assert relative(got[2], tmp_path / "p") == relative(want[2], tmp_path / "j")
    assert "Matches: 1\n\nStorage: 1 files written" in got[2]
    (p,) = (tmp_path / "p").rglob("*.parquet")
    (j,) = (tmp_path / "j").rglob("*.parquet")
    a, b = (pq.read_table(x).drop_columns(["timestamp"]) for x in (p, j))
    assert a.equals(b) and a.column("matched_target").to_pylist() == [addr]


class FakeSession:
    def __init__(self):
        self.calls = []

    def get(self, url, **kw):
        self.calls.append(("GET", url))
        return type("R", (), {"status_code": 404, "text": ""})()

    def post(self, url, json=None, **kw):
        self.calls.append(("POST", url))
        return type("R", (), {"status_code": 200, "text": ""})()


def test_cloud_upload_and_iceberg(tmp_path, capsys, monkeypatch):
    """``--cloud-upload`` with ``--cloud-delete-local`` through an injected
    in-memory uploader (the S3 uploader's place) and ``--iceberg-catalog``
    through a fake session: the chunk uploaded under its partition key and
    removed, the Iceberg append refused for want of pyiceberg; stdout and
    stderr equal to the JAX command's; no network."""
    stores = {}

    def uploader(key):
        def make(config):
            stores[key] = (ps3 if key == "port" else js3).InMemoryUploader(config.bucket)
            return stores[key]
        return make

    monkeypatch.setattr(ps3, "S3Uploader", uploader("port"))
    monkeypatch.setattr(js3, "S3Uploader", uploader("jax"))
    monkeypatch.setattr(requests, "Session", FakeSession)
    monkeypatch.setenv("CLOUD_BUCKET", "bkt")
    targets, _ = scan_targets(tmp_path)
    argv = ["scan", "--transform", "sha256", "--targets", targets, "--batch", "64",
            "--cloud-upload", "--cloud-endpoint", "https://s3.example", "--cloud-delete-local",
            "--iceberg-catalog", "http://catalog.example/api"]
    src = ["range", "--start", str(START), "--end", str(START + 63)]
    got = port_run(argv[:1] + ["--device", "cpu"] + argv[1:] + ["--storage",
                                                                 str(tmp_path / "p")] + src,
                   capsys)
    want = jax_run(argv + ["--storage", str(tmp_path / "j")] + src)
    assert got[:2] == want[:2] and got[0] == 0
    assert relative(got[2], tmp_path / "p") == relative(want[2], tmp_path / "j")
    assert "Cloud upload: 1 succeeded, 0 failed" in got[2]
    assert "Iceberg registration: Iceberg snapshot append requires pyiceberg" in got[2]
    assert list(stores["port"].objects) == list(stores["jax"].objects)
    assert not list((tmp_path / "p").rglob("*.parquet"))


@pytest.fixture(scope="module")
def stored(tmp_path_factory):
    """A directory of two transforms' records written by the port."""
    d = tmp_path_factory.mktemp("q")
    rc = cli.main(["generate", "--device", "cpu", "--transform", "md5", "--transform", "sha256",
                   "--batch", "64", "-o", os.devnull, "--storage", str(d), "range", "--start",
                   str(START), "--end", str(START + 63)])
    assert rc == 0
    return str(d)


@pytest.mark.parametrize("args", [
    ["SELECT transform, COUNT(*) AS n FROM results GROUP BY transform ORDER BY transform"],
    ["SELECT source, private_key_decimal, private_key_raw FROM results WHERE "
     "transform = 'md5' ORDER BY source LIMIT 3", "--format", "json"],
    ["SELECT source, address_p2wpkh, matched_target FROM results ORDER BY source, "
     "private_key_hex LIMIT 5", "-f", "csv"],
    ["SELECT * FROM results WHERE source = 'none'", "-f", "csv"],
    ["SELECT pubkey_uncompressed FROM results LIMIT 2"],
    ["--schema"],
    [],
], ids=["count", "json", "csv", "empty-csv", "long-cell", "schema", "no-sql"])
def test_query_is_the_jax_query(stored, capsys, args):
    got = port_run(["query", stored] + args, capsys)
    want = jax_run(["query", stored] + args)
    assert got[:2] == want[:2]
    assert got[2].splitlines()[-1:] == want[2].splitlines()[-1:]
    if not args:
        assert got == (2, "", "Error: SQL query required (or use --schema)\n")


def test_query_of_a_missing_path(tmp_path, capsys):
    missing = str(tmp_path / "none")
    got = port_run(["query", missing, "SELECT 1"], capsys)
    want = jax_run(["query", missing, "SELECT 1"])
    assert got[0] == want[0] == 2
    assert got[2].splitlines()[-1] == want[2].splitlines()[-1]


def test_query_of_an_empty_directory(tmp_path, capsys):
    got = port_run(["query", str(tmp_path), "SELECT * FROM results"], capsys)
    assert got == jax_run(["query", str(tmp_path), "SELECT * FROM results"])


@pytest.mark.parametrize("flag,value,storage", [
    ("--chunk-bytes", "1Q", True), ("--compression-level", "23", True),
    ("--compression", "brotli", True), ("--chunk-bytes", "5XM", False),
    ("--compression-level", "0", False)])
def test_storage_option_errors(tmp_path, capsys, flag, value, storage):
    """Bad storage option values stop with a usage error (exit 2) before
    anything runs, with or without ``--storage``, as the JAX command's do."""
    argv = (["generate"] + (["--storage", str(tmp_path)] if storage else []) + [flag, value]
            + ["range", "--start", "1", "--end", "2"])
    with pytest.raises(SystemExit) as e:
        cli.main(argv[:1] + ["--device", "cpu"] + argv[1:])
    assert e.value.code == 2
    port_err = capsys.readouterr()
    assert port_err.out == ""
    rc, out, err = jax_run(argv)
    assert rc == 2 and out == ""
    if flag != "--compression":          # argparse's and click's wording of a choice differ
        assert port_err.err.splitlines()[-1] == err.splitlines()[-1]
    assert not list(tmp_path.rglob("*.parquet"))
