"""vuke_tpu_torch's puzzle provider against the JAX package's: the dataset
copy byte for byte, every ``resolve`` selector, ``build_cascade``,
``parse_cascade_ref`` and ``verify_key`` field for field, the
``VUKE_TPU_PUZZLE_DATA`` override, and ``scan --targets boha:...`` on the
CPU (the port's plain versions, the JAX package's native host path):
stdout and stderr byte for byte, the zero-address error and the offline
warning included."""

import dataclasses
import json
import pathlib

import pytest
from click.testing import CliRunner

import vuke_tpu.provider as jprov
from vuke_tpu.cli import cli as jcli
from vuke_tpu_torch import cli
from vuke_tpu_torch import provider as prov

REPO = pathlib.Path(__file__).resolve().parent.parent


def as_dict(x):
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


def outcome(fn, *args):
    """A call's result as plain data, or its error's type name and text."""
    try:
        return "ok", as_dict(fn(*args))
    except ValueError as e:
        return "error", str(e)


def test_dataset_copy_is_byte_identical():
    assert ((REPO / "vuke_tpu_torch" / "data" / "puzzles.json").read_bytes()
            == (REPO / "vuke_tpu" / "data" / "puzzles.json").read_bytes())
    assert prov._DATA_PATH != jprov._DATA_PATH


@pytest.mark.parametrize("ref", [
    "boha:b1000", "boha:b1000:all", "boha:b1000:unsolved", "boha:b1000:solved",
    "boha:b1000:with-pubkey", "boha:all:all", "boha:all:unsolved", "boha:all:solved",
    "boha:all:with-pubkey", "boha:gsmg", "boha:zden:all", "boha:hash_collision:solved",
    "boha:b1000:40", "boha:b1000:40:3", "boha:b1000:67", "boha:b1000:66:8", "boha:b1000:1",
    "boha:b1000:2:1", "boha:zden:2",
    # not a provider reference: a path
    "targets.txt", "c:\\targets.txt", "b:x", "bohab:x",
    # errors
    "boha:nope", "boha:b1000:bogus", "boha:b1000:999", "boha:b1000:1:2:3", "boha:all:x",
    "boha:b1000:3:0", "boha:",
])
def test_resolve_matches_jax(ref):
    assert outcome(prov.resolve, ref) == outcome(jprov.resolve, ref)
    assert prov.is_provider(ref) == jprov.is_provider(ref)


@pytest.mark.parametrize("coll, pid, n", [
    ("b1000", 66, 5), ("b1000", 67, 5), ("b1000", 40, 3), ("b1000", 70, 12), ("b1000", 2, 1),
    ("b1000", 1, 5), ("b1000", 160, 10), ("gsmg", 1, 5),
])
def test_build_cascade_matches_jax(coll, pid, n):
    assert outcome(prov.build_cascade, coll, pid, n) == outcome(jprov.build_cascade, coll, pid, n)


@pytest.mark.parametrize("ref", ["boha:b1000:67", "boha:b1000:66:3", "boha:b1000:40:3",
                                 "5:0x15,10:0x202", "boha:b1000", "boha:b1000:1:2:3"])
def test_parse_cascade_ref_matches_jax(ref):
    assert outcome(prov.parse_cascade_ref, ref) == outcome(jprov.parse_cascade_ref, ref)


@pytest.mark.parametrize("key_hex, coll", [
    ("1", "b1000"), ("d2c55", "b1000"), ("1", "all"), ("2", "b1000"),
    ("c0de" * 16, "all"), ("3", "nope"),
])
def test_verify_key_matches_jax(key_hex, coll):
    key = bytes.fromhex(key_hex.rjust(64, "0"))
    assert outcome(prov.verify_key, key, coll) == outcome(jprov.verify_key, key, coll)


def test_puzzle_data_override(tmp_path, monkeypatch):
    """``VUKE_TPU_PUZZLE_DATA`` names another dataset for both; a missing
    file is an empty one."""
    data = {"mine": [{"id": 1, "bits": 3, "address": "1BgGZ9tcN4rm9KBzDn7KprQz87SZ26SAMH",
                      "solved": True, "key_hex": "5"},
                     {"id": 2, "bits": 4, "address": None, "solved": False}]}
    path = tmp_path / "p.json"
    path.write_text(json.dumps(data))
    monkeypatch.setenv("VUKE_TPU_PUZZLE_DATA", str(path))
    for ref in ("boha:mine:all", "boha:mine", "boha:mine:2", "boha:b1000"):
        assert outcome(prov.resolve, ref) == outcome(jprov.resolve, ref)
    monkeypatch.setenv("VUKE_TPU_PUZZLE_DATA", str(tmp_path / "missing.json"))
    assert outcome(prov.resolve, "boha:b1000") == outcome(jprov.resolve, "boha:b1000")
    assert prov.resolve("boha:all:all").addresses == []


def jax_run(argv):
    res = CliRunner().invoke(jcli, argv)
    assert res.exception is None or isinstance(res.exception, SystemExit), res.exception
    return res.exit_code, res.stdout, res.stderr


def port_run(argv, capsys):
    capsys.readouterr()
    try:
        rc = cli.main(argv[:1] + ["--device", "cpu"] + argv[1:])
    except SystemExit as e:
        rc = e.code
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.mark.parametrize("targets, start, end", [
    # puzzles 1..10 lie in [1, 600]: ten hit blocks
    ("boha:b1000:solved", 1, 600),
    # unsolved: the offline warning, then 24 addresses and no hit
    ("boha:b1000:unsolved", 1, 100),
    ("boha:all:solved", 1000, 1200),
    # zero usable addresses: click's error, with and without skipped entries
    ("boha:zden", 1, 10),
    ("boha:gsmg:solved", 1, 10),
])
def test_scan_provider_targets_match_jax(targets, start, end, capsys):
    argv = ["scan", "--transform", "direct:be", "--targets", targets, "--batch", "1024",
            "range", "--start", str(start), "--end", str(end)]
    got = port_run(argv, capsys)
    assert got == jax_run(argv)
    rc, out, err = got
    if targets == "boha:b1000:solved":
        assert rc == 0 and out.count("========== HIT") == 10
        assert err.startswith("Loaded 79 target addresses from provider boha:b1000:solved\n")
    if targets == "boha:b1000:unsolved":
        assert err.startswith("warning: 153 matching puzzles have no offline address and are "
                              "NOT scanned for\nLoaded 24 target addresses")
    if targets in ("boha:zden", "boha:gsmg:solved"):
        assert rc == 1 and err.startswith("Error: ") and "resolved to 0 usable addresses" in err
