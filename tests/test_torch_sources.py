"""vuke_tpu_torch's sources, outputs, progress and checkpoints against the
JAX package's on the CPU: the host parts side by side (``ConsoleOutput``,
``MultiOutput``, ``Progress`` on a fake clock and a TTY stream,
``SweepCheckpoint``, ``TimestampSource.from_dates``,
``WordlistSource.words``, ``FilesSource.entries``), then planted-key
``scan`` and ``generate`` runs over wordlist, stdin, files and timestamps
(``--microseconds``) through both command lines, stdout and stderr byte
for byte (``click.testing.CliRunner`` in the same process)."""

import hashlib
import io
import json
import os

import pytest
from click.testing import CliRunner

import vuke_tpu.progress as jprogress
import vuke_tpu.sources as jsources
from vuke_tpu.cli import cli as jcli
from vuke_tpu.derive import KeyDeriver as JKeyDeriver
from vuke_tpu.matcher import AddressType as JAddressType, MatchInfo as JMatchInfo
from vuke_tpu.output import ConsoleOutput as JConsole, MultiOutput as JMulti
from vuke_tpu.parallel.checkpoint import SweepCheckpoint as JCheckpoint
from vuke_tpu_torch import cli, progress, sources
from vuke_tpu_torch.derive import KeyDeriver
from vuke_tpu_torch.matcher import AddressType, MatchInfo
from vuke_tpu_torch.output import ConsoleOutput, MultiOutput
from vuke_tpu_torch.parallel.checkpoint import SweepCheckpoint


@pytest.fixture(autouse=True)
def small_pad(monkeypatch):
    monkeypatch.setenv("VUKE_STRING_PAD", "64")


def _drive_output(console, multi, deriver, match):
    """The same calls on a console (compact, then verbose) and a fan-out."""
    bufs = [io.StringIO() for _ in range(4)]
    key = hashlib.sha256(b"k").digest()
    d = deriver.derive(key)
    outs = [console(bufs[0]), console(bufs[1], verbose=True),
            multi([console(bufs[2]), console(bufs[3], verbose=True)])]
    for out in outs:
        out.key("src", "sha256", d)
        out.key_fast("src:2", "md5", key, d.p2pkh_compressed, deriver=deriver)
        out.hit("src[iterated:3]", "sha256_chain", d, match)
        out.flush()
        out.close()
    return [b.getvalue() for b in bufs]


def test_outputs_match_jax():
    port = _drive_output(ConsoleOutput, MultiOutput, KeyDeriver(),
                         MatchInfo(AddressType.P2WPKH, "bc1qexample"))
    ref = _drive_output(JConsole, JMulti, JKeyDeriver(),
                        JMatchInfo(JAddressType.P2WPKH, "bc1qexample"))
    assert port == ref and "(p2wpkh)" in port[0]
    assert [t.value for t in AddressType] == [t.value for t in JAddressType]


def test_console_to_file(tmp_path):
    out = ConsoleOutput.to_file(tmp_path / "o.txt")
    out.lines("a,b,c,d\n")
    out.flush()
    out.close()
    out.flush()
    assert (tmp_path / "o.txt").read_text() == "a,b,c,d\n"


class _Tty(io.StringIO):
    def isatty(self):
        return True


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def time(self):
        self.t += 0.3
        return self.t


@pytest.mark.parametrize("tty", [True, False])
@pytest.mark.parametrize("total", [None, 5000])
def test_progress_matches_jax(monkeypatch, tty, total):
    """Throttled to one render a 0.5 s, silent off a TTY."""
    texts = []
    for mod in (progress, jprogress):
        monkeypatch.setattr(mod.time, "time", _Clock().time)
        stream = _Tty() if tty else io.StringIO()
        p = mod.Progress(total=total, label="scan", stream=stream)
        for n in (100, 250, 1000, 7, 2000):
            p.advance(n)
        p.set_message("note")
        p.advance(1)
        p.finish()
        texts.append(stream.getvalue())
    assert texts[0] == texts[1]
    assert bool(texts[0]) == tty


def test_checkpoint_matches_jax(tmp_path):
    """The same marks on both: the same JSON, the same pending ranges; a
    manifest of another job is ignored."""
    states = []
    for cls, name in ((SweepCheckpoint, "port"), (JCheckpoint, "jax")):
        path = str(tmp_path / name / "ckpt.json")
        c = cls.load(path, "scan:md5:0-999")
        for s, e in ((100, 199), (0, 49), (50, 99), (500, 599), (300, 310)):
            c.mark_completed(s, e)
        c.save()
        again = cls.load(path, "scan:md5:0-999")
        other = cls.load(path, "scan:sha256:0-999")
        states.append((json.load(open(path)), again.pending_ranges(0, 999),
                       again.pending_ranges(150, 320), other.completed))
        assert not [f for f in os.listdir(tmp_path / name) if f.startswith(".ckpt_")]
    assert states[0] == states[1]
    assert states[0][1] == [(200, 299), (311, 499), (600, 999)]


@pytest.mark.parametrize("start,end,micro", [("2015-06-01", "2015-06-01", False),
                                             ("2009-01-03", "2009-01-09", True),
                                             ("2024-02-28", "2024-03-01", False)])
def test_timestamps_from_dates_match_jax(start, end, micro):
    got = sources.TimestampSource.from_dates(start, end, micro)
    want = jsources.TimestampSource.from_dates(start, end, micro)
    assert (got.start, got.end, got.microseconds) == (want.start, want.end, want.microseconds)
    assert got.end - got.start + 1 == 86400 * (got.end - got.start + 1) // 86400


def test_words_and_entries_match_jax(tmp_path):
    wl = tmp_path / "words.txt"
    wl.write_bytes(b"alpha\r\n\n  beta  \n\xff\xfebad\n\t\nsecond line here\nlast")
    assert sources.WordlistSource(str(wl)).words() == jsources.WordlistSource(str(wl)).words()
    d = tmp_path / "tree"
    (d / "sub" / "deeper").mkdir(parents=True)
    for p in ("b.txt", "a.txt", "sub/z", "sub/deeper/y"):
        (d / p).write_text(p)
    os.symlink(d / "a.txt", d / "link.txt")
    os.symlink(d / "sub" / "z", d / "sub" / "zlink")
    for recursive in (False, True):
        got = sources.FilesSource(str(d), recursive).entries()
        assert got == jsources.FilesSource(str(d), recursive).entries()
        assert not any(p.endswith("link.txt") or p.endswith("zlink") for p in got)
    assert sources.FilesSource(str(d / "a.txt")).entries() == [str(d / "a.txt")]


def jax_run(argv, stdin=None):
    res = CliRunner().invoke(jcli, argv, input=stdin)
    assert res.exception is None or isinstance(res.exception, SystemExit), res.exception
    return res.exit_code, res.stdout, res.stderr


def port_run(argv, capsys, monkeypatch=None, stdin=None):
    if stdin is not None:
        monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
    capsys.readouterr()
    rc = cli.main(argv[:1] + ["--device", "cpu"] + argv[1:])
    out, err = capsys.readouterr()
    return rc, out, err


def _addr(key: bytes, kind: str = "p2pkh_compressed") -> str:
    return getattr(JKeyDeriver().derive(key), kind)


WORDS = [f"word{i:03d}" for i in range(150)] + ["correct horse battery staple",
                                                "ünïcödé pässwörd", "x" * 40]


def _wordlist(tmp_path, words=WORDS):
    path = tmp_path / "words.txt"
    path.write_text("\n".join(words) + "\n\n")
    return str(path)


def _targets(tmp_path, *addresses):
    path = tmp_path / "targets.txt"
    path.write_text("\n".join(addresses) + "\nnot-an-address\n")
    return str(path)


def test_wordlist_scan_matches_jax(tmp_path, capsys):
    """sha256, double_sha256, md5 and direct over a wordlist: exactly the
    planted hits, per batch, per transform, per word."""
    md5 = hashlib.md5("ünïcödé pässwörd".encode()).digest()
    targets = _targets(
        tmp_path, _addr(hashlib.sha256(b"correct horse battery staple").digest()),
        _addr(hashlib.sha256(hashlib.sha256(b"word007").digest()).digest(), "p2wpkh"),
        _addr(md5 + md5, "p2pkh_uncompressed"), _addr(b"word120".ljust(32, b"\0")))
    argv = ["scan", "--transform", "sha256", "--transform", "double_sha256", "--transform",
            "md5", "--transform", "direct", "--targets", targets, "wordlist", "--file",
            _wordlist(tmp_path)]
    got = port_run(argv, capsys)
    assert got == jax_run(argv)
    assert [line for line in got[1].splitlines() if line.startswith("Source")] == [
        "Source: correct horse battery staple", "Source: word007", "Source: ünïcödé pässwörd",
        "Source: word120"]
    assert got[2] == ("Loaded 5 target addresses\nScanning...\n"
                      "Done. Inputs: 153, Keys: 611, Matches: 4\n")


def test_wordlist_chain_scan_through_d1_matches_jax(tmp_path, capsys, monkeypatch):
    """sha256_chain:iterated over a wordlist with ``VUKE_HOST_DIGEST_MAX=0``
    on the port's side: the digests and the chain through D1's plain
    version; a key at depth 6."""
    key = b"word042"
    for _ in range(7):
        key = hashlib.sha256(key).digest()
    targets = _targets(tmp_path, _addr(key))
    argv = ["scan", "--transform", "sha256_chain:iterated", "--targets", targets, "wordlist",
            "--file", _wordlist(tmp_path, WORDS[:60])]
    ref = jax_run(argv)
    monkeypatch.setenv("VUKE_HOST_DIGEST_MAX", "0")
    got = port_run(argv, capsys)
    assert got == ref and "Source: word042[iterated:6]\n" in got[1]


def test_stdin_and_files_scans_match_jax(tmp_path, capsys, monkeypatch):
    """stdin (stripped lines, blanks skipped) and files (each file's path
    is the string; one input a file) through both command lines."""
    text = "\n".join(["  alpha  ", "", "beta", "gamma"] * 3) + "\n"
    targets = _targets(tmp_path, _addr(hashlib.sha256(b"beta").digest()))
    argv = ["scan", "--targets", targets, "stdin"]
    got = port_run(argv, capsys, monkeypatch, stdin=text)
    assert got == jax_run(argv, stdin=text)
    assert got[1].count("Source: beta\n") == 3 and "Inputs: 9," in got[2]

    d = tmp_path / "files"
    (d / "sub").mkdir(parents=True)
    for name in ("one", "two", "sub/three"):
        (d / name).write_text(name)
    planted = str(d / "sub" / "three")
    targets = _targets(tmp_path, _addr(hashlib.md5(planted.encode()).digest() * 2))
    for src in (["files", "--dir", str(d)], ["files", "--file", planted]):
        argv = ["scan", "--transform", "md5", "--transform", "sha256", "--targets", targets]
        got = port_run(argv + src, capsys)
        assert got == jax_run(argv + src) and f"Source: {planted}\n" in got[1]
    for src in (["files"], ["files", "--file", planted, "--dir", str(d)]):
        with pytest.raises(SystemExit):
            port_run(["scan", "--targets", targets] + src, capsys)
        assert capsys.readouterr().err == "Error: exactly one of --file / --dir required\n"


def test_timestamps_microseconds_scan_matches_jax(tmp_path, capsys, monkeypatch):
    """``timestamps --microseconds``: the seconds, then the millisecond
    lattice [start * 1000, (end + 1) * 1000 - 1], with a hit planted in the
    second; the date range is patched to seconds 5..6 on both sides (a day
    is 86.4 M seeds)."""
    for mod in (sources, jsources):
        monkeypatch.setattr(mod.TimestampSource, "from_dates",
                            classmethod(lambda cls, a, b, m: cls(5, 6, m)))
    md5 = hashlib.md5(b"6123").digest()
    targets = _targets(tmp_path, _addr(md5 + md5))
    argv = ["scan", "--transform", "md5", "--targets", targets, "timestamps", "--start",
            "2015-06-01", "--end", "2015-06-01", "--microseconds"]
    got = port_run(argv, capsys)
    assert got == jax_run(argv)
    assert "Source: 6123\n" in got[1]
    assert got[2].endswith("Done. Inputs: 2002, Keys: 2002, Matches: 1\n")


def test_generate_over_strings_matches_jax(tmp_path, capsys, monkeypatch):
    """generate over a wordlist and stdin: per batch, per transform, per
    word, per slot; direct's long strings yield no line."""
    argv = ["generate", "--transform", "direct", "--transform", "md5", "wordlist", "--file",
            _wordlist(tmp_path, WORDS[:20] + WORDS[-3:])]
    got = port_run(argv, capsys)
    assert got == jax_run(argv) and got[1].count("\n") == 45
    argv = ["generate", "--transform", "sha256_chain:counter", "--network", "testnet", "stdin"]
    got = port_run(argv, capsys, monkeypatch, stdin="a\nb\n")
    assert got == jax_run(argv, stdin="a\nb\n") and got[1].count("\n") == 20
