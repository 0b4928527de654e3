"""vuke_tpu_torch's ``generate`` and the order of a multi-transform run
against the JAX package's command line on the CPU (the port's plain
versions, the JAX package's native host path): stdout and stderr byte for
byte (``click.testing.CliRunner`` in the same process), for range sources,
``-o FILE``, ``-v``, ``--network``, a checkpointed rerun, and the C6 order
(hits and lines in the JAX package's superbatch order, not the port's),
with and without ``--batch``."""

import json

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import vuke_tpu.pipeline as jpipeline
from vuke_tpu.cli import cli as jcli
from vuke_tpu.derive import KeyDeriver as JKeyDeriver
from vuke_tpu_torch import cli, pipeline
from vuke_tpu_torch.cores import p2pkh


def jax_run(argv, stdin=None):
    res = CliRunner().invoke(jcli, argv, input=stdin)
    assert res.exception is None or isinstance(res.exception, SystemExit), res.exception
    return res.exit_code, res.stdout, res.stderr


def port_run(argv, capsys):
    """``argv`` with ``--device cpu`` after the command."""
    capsys.readouterr()
    rc = cli.main(argv[:1] + ["--device", "cpu"] + argv[1:])
    out, err = capsys.readouterr()
    return rc, out, err


def same_as_jax(argv, capsys):
    got = port_run(argv, capsys)
    assert got == jax_run(argv)
    return got


@pytest.fixture(autouse=True)
def small_pad(monkeypatch):
    monkeypatch.setenv("VUKE_STRING_PAD", "64")


@pytest.mark.parametrize("argv", [
    ["generate", "--transform", "sha256", "--transform", "md5", "--batch", "64", "range",
     "--start", "0", "--end", "63"],
    ["generate", "--transform", "milksad", "--batch", "64", "range", "--start",
     str((1 << 32) - 40), "--end", str((1 << 32) + 9)],
    ["generate", "--transform", "lcg:minstd", "--network", "testnet", "--batch", "64", "range",
     "--start", str((1 << 31) - 20), "--end", str((1 << 31) + 3)],
    ["generate", "--transform", "direct", "--network", "regtest", "--batch", "64", "range",
     "--start", "0", "--end", "20"],
])
def test_generate_range_matches_jax(argv, capsys):
    """Every line, in order, and ``Generating keys...``/``Done.`` on stderr:
    keys normalized (0 -> 1), milksad above 2^32 and minstd past its cap
    yield no line, the test networks' version byte."""
    rc, out, err = same_as_jax(argv, capsys)
    assert rc == 0 and err.startswith("Generating keys...\n") and out


def test_generate_verbose_and_to_a_file(tmp_path, capsys):
    """``-v`` blocks (a host derive a key) and ``-o FILE``."""
    argv = ["generate", "--transform", "md5", "-v", "--batch", "64", "range", "--start", "7",
            "--end", "10"]
    rc, out, err = same_as_jax(argv, capsys)
    assert out.count("---\nsource: ") == 4
    port, ref = tmp_path / "port.txt", tmp_path / "jax.txt"
    base = ["generate", "--transform", "sha256", "--batch", "64"]
    src = ["range", "--start", "5", "--end", "20"]
    got = port_run(base + ["-o", str(port)] + src, capsys)
    assert got == jax_run(base + ["-o", str(ref)] + src) and got[1] == ""
    assert port.read_text() == ref.read_text() and port.read_text().count("\n") == 48


def test_format_lines_equals_key_fast(capsys):
    """The generate driver's block formatter writes what ``key_fast`` writes
    line by line, invalid keys left out."""
    rng = np.random.default_rng(3)
    S, n, first = 3, 50, (1 << 64) - 50
    norm = rng.integers(0, 1 << 32, (S, n, 8), dtype=np.uint32)
    h = torch.from_numpy(rng.integers(0, 1 << 32, (5, S * n), dtype=np.uint32))
    rows = p2pkh.batch_p2pkh(h, 0).numpy().reshape(S, n, 35)
    valid = rng.random((S, n)) < 0.8
    labels = ("", ":msvc", "[indexed:le:9]")
    got = pipeline.format_lines(first, labels, "lcg", norm, rows, valid)
    want = "".join(
        f"{first + i}{labels[s]},lcg,{norm[s, i].astype('>u4').tobytes().hex()},"
        f"{p2pkh.addresses(rows[s, i:i + 1])[0]}\n"
        for i in range(n) for s in range(S) if valid[s, i])
    assert got == want


def _targets(tmp_path, *keys, kind="p2pkh_compressed"):
    path = tmp_path / "targets.txt"
    path.write_text("".join(getattr(JKeyDeriver().derive(k), kind) + "\n" for k in keys)
                    + "not-an-address\n# comment\n\n")
    return str(path)


def _md5_key(seed):
    import hashlib
    d = hashlib.md5(str(seed).encode()).digest()
    return d + d


def _milksad_key(seed):
    return np.random.RandomState(seed).bytes(32)


@pytest.mark.parametrize("batch", [None, "64"])
def test_c6_hits_print_in_the_jax_order(tmp_path, capsys, monkeypatch, batch):
    """C6: milksad's hit at seed 70 and md5's at seed 10, two transforms.
    The JAX package at a superbatch of 64 prints md5's hit (chunk 0) before
    milksad's (chunk 1); the port's device superbatch of 256 holds both,
    and its output follows the 64-seed chunks all the same.  Without
    ``--batch`` the defaults are patched small on both sides (the JAX
    package's 65536 and the port's ``ORDER_BATCH``, 64; the port's device
    superbatch, 256)."""
    monkeypatch.setattr(jpipeline, "DEFAULT_BATCH", 64)
    monkeypatch.setattr(cli, "ORDER_BATCH", 64)
    monkeypatch.setattr(cli, "DEFAULT_BATCH", 256)
    targets = _targets(tmp_path, _milksad_key(70), _md5_key(10))
    argv = ["scan", "--transform", "milksad", "--transform", "md5", "--targets", targets]
    argv += (["--batch", batch] if batch else []) + ["range", "--start", "0", "--end", "300"]
    rc, out, err = same_as_jax(argv, capsys)
    sources = [line for line in out.splitlines() if line.startswith("Source: ")]
    assert sources == ["Source: 10", "Source: 70"]
    assert err.startswith("Loaded 3 target addresses\nScanning...\n")


def test_c6_generate_lines_in_the_jax_order(capsys, monkeypatch):
    """C6 for generate: per 64-seed chunk, per transform, per seed, every
    slot, while the port's device superbatch is 256."""
    monkeypatch.setattr(jpipeline, "DEFAULT_BATCH", 64)
    monkeypatch.setattr(cli, "ORDER_BATCH", 64)
    monkeypatch.setattr(cli, "DEFAULT_BATCH", 256)
    argv = ["generate", "--transform", "md5", "--transform", "milksad", "range", "--start",
            "0", "--end", "300"]
    rc, out, err = same_as_jax(argv, capsys)
    names = [line.split(",")[1] for line in out.splitlines()]
    assert names[:64] == ["md5"] * 64 and names[64:128] == ["milksad"] * 64


def test_checkpoint_resumes_and_a_rerun_does_nothing(tmp_path, capsys):
    """``--checkpoint``: from a manifest that holds [1000, 1500] of [1000,
    1600], only [1501, 1600] runs (chunks of 16 x the batch) and the
    manifest ends as the JAX package's; a rerun processes nothing."""
    targets = _targets(tmp_path, _md5_key(1530), _md5_key(1030))
    argv = ["scan", "--transform", "md5", "--targets", targets, "--batch", "32",
            "--checkpoint", "CKPT", "range", "--start", "1000", "--end", "1600"]
    port, ref = tmp_path / "port.json", tmp_path / "jax.json"
    for path in (port, ref):
        path.write_text(json.dumps({"job_id": "scan:md5:1000-1600",
                                    "completed": [[1000, 1500]], "found_seed": None}))

    def with_path(path):
        return [str(path) if a == "CKPT" else a for a in argv]

    got = port_run(with_path(port), capsys)
    assert got == jax_run(with_path(ref))
    assert "Source: 1530\n" in got[1] and "Source: 1030\n" not in got[1]
    assert got[2].endswith("Done. Inputs: 100, Keys: 100, Matches: 1\n")
    assert json.loads(port.read_text()) == json.loads(ref.read_text()) == {
        "job_id": "scan:md5:1000-1600", "completed": [[1000, 1600]], "found_seed": None}
    again = port_run(with_path(port), capsys)
    assert again == jax_run(with_path(ref))
    assert again == (0, "", "Loaded 3 target addresses\nScanning...\n"
                            "Done. Inputs: 0, Keys: 0, Matches: 0\n")


@pytest.mark.parametrize("argv", [
    ["generate", "--storage", "OUT", "--batch", "64", "range", "--start", "1", "--end", "64"],
    ["generate", "--cloud-upload", "--batch", "64", "range", "--start", "1", "--end", "64"],
    ["generate", "--iceberg-catalog", "c", "--batch", "64", "range", "--start", "1", "--end",
     "64"],
    ["generate", "--transform", "armory", "--chunk-bytes", "1M", "--batch", "64", "range",
     "--start", "1", "--end", "64"],
    ["query"],
])
def test_what_is_not_ported_stops(argv, tmp_path, capsys):
    """The storage, cloud and Iceberg options and ``query``, which the port
    once stopped as not ported, run: ``--storage`` writes one record a
    line, ``--cloud-upload`` and ``--iceberg-catalog`` without ``--storage``
    do nothing (as in the JAX package), and ``query`` without a path is a
    usage error (exit 2)."""
    argv = [str(tmp_path / "out") if a == "OUT" else a for a in argv]
    if argv == ["query"]:
        with pytest.raises(SystemExit) as e:
            cli.main(argv)
        assert e.value.code == 2
        assert "not ported" not in "".join(capsys.readouterr())
        return
    rc, out, err = port_run(argv, capsys)
    assert rc == 0 and "not ported" not in out + err
    lines = out.count("\n")
    assert lines and "Done. Inputs: " in err
    if "--storage" in argv:
        import pyarrow.parquet as pq
        (path,) = (tmp_path / "out").rglob("*.parquet")
        assert pq.read_metadata(path).num_rows == lines
        assert err.endswith(f" ({cli._format_bytes(path.stat().st_size)})\n")


def test_warmup_runs_each_transform_once(capsys):
    """``warmup``: one stderr line a transform with the kernels it
    launched (none through the plain versions) and the seconds; a
    sequential slot's table is built on the second superbatch."""
    from vuke_tpu_torch.ecc import incremental

    incremental._cached_table.cache_clear()
    assert cli.main(["warmup", "--transform", "milksad", "--transform", "direct:be", "--batch",
                     "64", "--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    lines = err.splitlines()
    assert out == "" and len(lines) == 2
    for line, name in zip(lines, ("milksad", "direct:be")):
        assert line.startswith(f"warmed {name} at batch 64: no kernels (plain versions) in ")
        assert line.endswith("s")
    assert incremental._cached_table.cache_info().currsize == 1
