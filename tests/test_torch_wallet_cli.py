"""The wallet transforms and the multibit-hd analyzer through vuke_tpu_torch's
command line against the JAX package's click command on the CPU, stdout and
stderr byte for byte (``click.testing.CliRunner`` in the same process):
electrum over 40 timestamps (the JAX device stretch runs for 32 seeds or
more), electrum:change, a multibit and armory wordlist scan, armory over a
range (its host-only numeric path), bitimage over the files of a directory
with ``--bitimage-derive-count`` and a passphrase wordlist, ``generate
--transform electrum``, ``single`` with the wallet transforms, ``warmup``'s
skipping lines, and ``analyze --analyzer multibit-hd`` with ``--mnemonic``
and ``--mnemonic-file``.  Every run holds a planted key.

Three things on the JAX side are swapped for their host equivalents so
that these runs take seconds, not minutes; each computes the same values:
- ``vuke_tpu.ecc.ref.point_mul`` (an affine double-and-add, ~70 ms a key)
  by the port's Jacobian one, which ``tests/test_torch_host.py`` holds
  against it;
- ``vuke_tpu.wallets.electrum.master_pubkeys_device`` (an XLA:CPU compile
  of the whole derive, ~95 s) by ``ref.point_mul`` per stretched key, what
  ``ElectrumDeriver`` computes for a single seed;
- ``vuke_tpu.wallets.electrum.stretch_keys_device`` (its XLA:CPU loop takes
  ~1 s a seed) by ``stretch_key`` per seed; ``tests/test_torch_pbkdf2.py``
  holds the port's stretch against the JAX device one.
The JAX package's grouping of 32 seeds or more of one length still runs.
"""

import hashlib

import pytest
from click.testing import CliRunner

import vuke_tpu.ecc.ref as jref
import vuke_tpu.sources as jsources
import vuke_tpu.transforms.registry as jregistry
import vuke_tpu.wallets.electrum as jelectrum
from vuke_tpu.cli import cli as jcli
from vuke_tpu.derive import KeyDeriver as JKeyDeriver
from vuke_tpu_torch import cli, sources
from vuke_tpu_torch.ecc import ref
from vuke_tpu_torch.wallets import armory, bitimage, electrum, multibit

MNEMONIC_445 = ("skin join dog sponsor camera puppy ritual diagram arrow poverty boy "
                "elbow")
ABANDON = " ".join(["abandon"] * 11 + ["about"])


def _jax_mpk(stretched):
    out = []
    for s in stretched:
        k = int.from_bytes(s, "big")
        if not 0 < k < ref.N:
            out.append(None)
            continue
        x, y = ref.point_mul(k)
        out.append(x.to_bytes(32, "big") + y.to_bytes(32, "big"))
    return out


@pytest.fixture(autouse=True)
def fast_jax_host(monkeypatch):
    monkeypatch.setenv("VUKE_STRING_PAD", "64")
    monkeypatch.setattr(jref, "point_mul", ref.point_mul)
    monkeypatch.setattr(jelectrum, "master_pubkeys_device", _jax_mpk)
    monkeypatch.setattr(jelectrum, "stretch_keys_device",
                        lambda seeds: [jelectrum.stretch_key(s) for s in seeds])
    jregistry.parse_transform.cache_clear()
    yield
    jregistry.parse_transform.cache_clear()


def jax_run(argv):
    res = CliRunner().invoke(jcli, argv)
    assert res.exception is None or isinstance(res.exception, SystemExit), res.exception
    return res.exit_code, res.stdout, res.stderr


def port_run(argv, capsys, device=True):
    capsys.readouterr()
    rc = cli.main(argv[:1] + (["--device", "cpu"] if device else []) + argv[1:])
    out, err = capsys.readouterr()
    return rc, out, err


def _addr(key: bytes, kind: str = "p2pkh_compressed") -> str:
    return getattr(JKeyDeriver().derive(key), kind)


def _targets(tmp_path, *addresses):
    path = tmp_path / "targets.txt"
    path.write_text("\n".join(addresses) + "\n")
    return str(path)


def _sources(got) -> list:
    return [line for line in got[1].splitlines() if line.startswith("Source: ")]


def test_electrum_over_timestamps_matches_jax(tmp_path, capsys, monkeypatch):
    """34 timestamps (one batch of decimal strings of one length, 32 or
    more, so the JAX package groups them for its device stretch), a key
    planted at derivation index 3 of the 18th; the date range is patched
    on both sides."""
    for mod in (sources, jsources):
        monkeypatch.setattr(mod.TimestampSource, "from_dates",
                            classmethod(lambda cls, a, b, m: cls(1400000000, 1400000033, m)))
    key = electrum.ElectrumDeriver.from_hex_seed("1400000017").derive_key(3)
    argv = ["scan", "--transform", "electrum", "--targets", _targets(tmp_path, _addr(key)),
            "timestamps", "--start", "2014-05-13", "--end", "2014-05-13"]
    got = port_run(argv, capsys)
    assert got == jax_run(argv)
    assert _sources(got) == ["Source: 1400000017[0/3]"]
    assert got[2].endswith("Done. Inputs: 34, Keys: 680, Matches: 1\n")


def test_electrum_change_and_generate_match_jax(tmp_path, capsys):
    """electrum:change over a range, a change key planted; then ``generate
    --transform electrum`` over 4 seeds (80 lines)."""
    key = electrum.ElectrumDeriver.from_hex_seed("8", for_change=True).derive_key(5)
    argv = ["scan", "--transform", "electrum:change", "--targets",
            _targets(tmp_path, _addr(key, "p2pkh_uncompressed")), "range", "--start", "7",
            "--end", "9"]
    got = port_run(argv, capsys)
    assert got == jax_run(argv) and _sources(got) == ["Source: 8[1/5]"]
    argv = ["generate", "--transform", "electrum", "range", "--start", "1", "--end", "4"]
    got = port_run(argv, capsys)
    assert got == jax_run(argv) and got[1].count("\n") == 80


def test_multibit_and_armory_wordlist_scan_matches_jax(tmp_path, capsys):
    """A wordlist of mnemonics (valid, an unknown word, a wrong count) and
    plain strings through multibit and armory: the MultiBit bug vector's
    key at m/0'/0/2 and an armory string key planted; multibit's labels
    are truncated mnemonics."""
    mb = multibit.multibit_hd_keys(MNEMONIC_445, "", 3)[2]
    ar = armory.armory_key(hashlib.sha256(b"hunter2").digest())
    words = [ABANDON, "hunter2", MNEMONIC_445, " ".join(["abandon"] * 11 + ["notaword"]),
             "abandon abandon abandon"]
    path = tmp_path / "words.txt"
    path.write_text("\n".join(words) + "\n")
    argv = ["scan", "--transform", "multibit", "--transform", "armory", "--targets",
            _targets(tmp_path, _addr(mb), _addr(ar, "p2wpkh")), "wordlist", "--file", str(path)]
    got = port_run(argv, capsys)
    assert got == jax_run(argv)
    assert _sources(got) == ["Source: skin join...boy elbow[m/0'/0/2]", "Source: hunter2"]


def test_armory_range_matches_jax(tmp_path, capsys):
    """armory's host-only numeric path over [1, 32] at batch 32 (two slots:
    SHA256 of the decimal string, and the seed as 32 bytes), a key planted
    in each; the JAX package computes a whole superbatch on the host, so
    ``--batch 32`` keeps it to the range."""
    k1 = armory.armory_key(hashlib.sha256(b"20").digest())
    k2 = armory.armory_key((27).to_bytes(32, "big"))
    argv = ["scan", "--transform", "armory", "--batch", "32", "--targets",
            _targets(tmp_path, _addr(k1), _addr(k2, "p2pkh_uncompressed")), "range",
            "--start", "1", "--end", "32"]
    got = port_run(argv, capsys)
    assert got == jax_run(argv)
    assert _sources(got) == ["Source: 20", "Source: 27"]
    assert got[2].endswith("Done. Inputs: 32, Keys: 64, Matches: 2\n")


def test_bitimage_files_match_jax(tmp_path, capsys):
    """bitimage over a directory of 3 files with ``--bitimage-derive-count
    2`` and a passphrase wordlist of two (4 slots a file): a key planted at
    the second passphrase's second address; then generate over the same
    files, a key line a slot, and a file scan with sha256 beside bitimage
    (its path as the string)."""
    d = tmp_path / "imgs"
    d.mkdir()
    for i in range(3):
        (d / f"img{i}.bin").write_bytes(bytes(range(i, 200 + i)))
    pp = tmp_path / "pp.txt"
    pp.write_text("alpha\nbeta\n")
    key = bitimage.BitimageDeriver(bytes(range(1, 201)), "beta").derive_path("m/84'/0'/0'/0/1")
    path_key = hashlib.sha256(str(d / "img2.bin").encode()).digest()
    opts = ["--bitimage-derive-count", "2", "--bitimage-passphrase-wordlist", str(pp)]
    argv = (["scan", "--transform", "bitimage", "--transform", "sha256", "--targets",
             _targets(tmp_path, _addr(key, "p2wpkh"), _addr(path_key))] + opts
            + ["files", "--dir", str(d)])
    got = port_run(argv, capsys)
    assert got == jax_run(argv)
    assert _sources(got) == [f"Source: {d / 'img1.bin'}:beta[m/84'/0'/0'/0/1]",
                             f"Source: {d / 'img2.bin'}"]
    argv = ["generate", "--transform", "bitimage", "--bitimage-path", "m/44'/0'/0'/0/3",
            "--bitimage-passphrase", "pw", "files", "--dir", str(d)]
    got = port_run(argv, capsys)
    assert got == jax_run(argv) and got[1].count("\n") == 3


@pytest.mark.parametrize("transform, phrase", [
    ("armory", "correct horse battery staple"),
    ("electrum:change", "acb740e454c3134901d7c8f16497cc1c"),
    ("multibit", MNEMONIC_445),
    ("multibit", "not a mnemonic"),
    ("bitimage", "some file bytes"),
])
def test_single_with_wallet_transforms_matches_jax(transform, phrase, capsys):
    argv = ["single", phrase, "--transform", transform]
    got = port_run(argv, capsys, device=False)
    assert got == jax_run(argv)


def test_warmup_skips_wallet_transforms(capsys):
    """warmup's lines for a string-only and a host-only transform, as the
    JAX command prints them (its warmup then compiles the derive; the port
    has nothing to build for these)."""
    assert cli.main(["warmup", "--transform", "electrum", "--transform", "armory",
                     "--device", "cpu"]) == 0
    assert capsys.readouterr().err == ("skipping electrum: string transform (host path)\n"
                                       "skipping armory: host-only transform\n")


def test_analyze_multibit_matches_jax(tmp_path, capsys):
    """``--mnemonic``: CONFIRMED at m/0'/0/4 and NOT_FOUND; ``--mnemonic-file``
    of 40 lines (comments, blanks, invalid lines) with the planted mnemonic
    on line 33; no mnemonic: UNKNOWN; a missing file."""
    key = multibit.multibit_hd_keys(MNEMONIC_445, "", 5)[4].hex()
    lines = []
    for i in range(40):
        if i == 32:
            lines.append(MNEMONIC_445)
        elif i % 9 == 4:
            lines.append("# a comment" if i % 2 else "")
        elif i % 7 == 3:
            lines.append("abandon abandon abandon")
        else:
            lines.append(" ".join(bitimage.bip39.wordlist()[(37 * i + j) % 2048]
                                  for j in range(12)))
    f = tmp_path / "mnemonics.txt"
    f.write_text("\n".join(lines) + "\n")
    for argv in (["analyze", key, "--analyzer", "multibit-hd", "--mnemonic", MNEMONIC_445],
                 ["analyze", key, "--analyzer", "multibit", "--mnemonic", ABANDON, "--json"],
                 ["analyze", key, "--analyzer", "multibit-hd", "--mnemonic-file", str(f)],
                 ["analyze", key, "--analyzer", "multibit-hd"],
                 ["analyze", key, "--analyzer", "multibit-hd", "--mnemonic-file",
                  str(tmp_path / "missing.txt")]):
        got = port_run(argv, capsys)
        assert got == jax_run(argv), argv
    assert "path=m/0'/0/4, line=33" in port_run(argv[:4] + ["--mnemonic-file", str(f)],
                                                capsys)[1]
