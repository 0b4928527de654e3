"""vuke_tpu_torch's scan driver and command line against the reference's
behaviour: one superbatch in flight (launch k + 1 before reading k), the
``VUKE_TPU_SEQUENTIAL`` switch, stdout and stderr as ``vuke_tpu/cli.py``
writes them, the batch clamped to a short range, multi-slot hits with the
reference's ``Source:`` labels, and planted-seed scans of the keygen
kernels' transforms on the CPU (their plain versions)."""

import hashlib
import os

import pytest

import chip_smoke
import oracles
from vuke_tpu_torch import cli
from vuke_tpu_torch.cores import keygen, lcg
from vuke_tpu_torch.derive import KeyDeriver
from vuke_tpu_torch.ecc import incremental
from vuke_tpu_torch.matcher import TargetPools
from vuke_tpu_torch.pipeline import ForwardDriver, scan_range
from vuke_tpu_torch.transforms import parse_transform

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIT_OPEN = "\n========== HIT ==========\n"
HIT_CLOSE = "=========================\n"


def _addr(key: bytes, kind: str = "p2pkh_compressed") -> str:
    return getattr(KeyDeriver().derive(key), kind)


class _Stats:
    def __init__(self, log, tag, n, slots):
        self.log, self.tag, self.n, self.slots = log, tag, n, slots

    def tolist(self):
        self.log.append(("read",) + self.tag)
        return [[self.n, 0]] * self.slots


class _StubProgram:
    """Logs each launch and each read of a superbatch's stats."""

    def __init__(self, log, name, slots=1):
        self.log, self.name, self.slots = log, name, slots
        self.spec = parse_transform("milksad")

    def run(self, start, limit):
        self.log.append(("launch", self.name, start))
        return _Stats(self.log, (self.name, start), limit, self.slots), [None] * self.slots


def test_superbatch_k_plus_1_is_launched_before_k_is_read():
    """C1: two programs over four superbatches of 32 (the last short)."""
    log = []
    driver = ForwardDriver([parse_transform("milksad")], TargetPools.from_addresses([]),
                           batch=32, device="cpu")
    driver.programs = [_StubProgram(log, "a", 2), _StubProgram(log, "b")]
    res = driver.run_range(0, 3 * 32 + 9)
    want = []
    for k in range(4):
        want += [("launch", "a", 32 * k), ("launch", "b", 32 * k)]
        if k:
            want += [("read", "a", 32 * (k - 1)), ("read", "b", 32 * (k - 1))]
    want += [("read", "a", 96), ("read", "b", 96)]
    assert log == want
    assert res.inputs_processed == 2 * 106 and res.keys_generated == 3 * 106


def test_a_superbatch_reads_one_small_tensor():
    """A superbatch's counts are one (S, 2) tensor, [n_valid, count] a
    slot, read in one copy; each slot keeps its mask."""
    d = KeyDeriver().derive((5).to_bytes(32, "big"))
    driver = ForwardDriver([parse_transform("direct")], TargetPools.from_addresses(
        [d.p2pkh_compressed]), batch=32, device="cpu")
    stats, masks = driver.programs[0].run(1, 32)
    assert stats.shape == (3, 2) and len(masks) == 3
    assert stats.tolist() == [[32, 1], [32, 0], [32, 0]]


@pytest.fixture
def counted_paths(monkeypatch):
    """Counts the calls of K5's and keygen_hash's plain versions."""
    calls = {"seq_madd": 0, "keygen_hash": 0}
    seq, kg = incremental.seq_madd_plain, keygen.keygen_hash_plain

    def seq_counted(*a, **k):
        calls["seq_madd"] += 1
        return seq(*a, **k)

    def kg_counted(*a, **k):
        calls["keygen_hash"] += 1
        return kg(*a, **k)

    monkeypatch.setattr(incremental, "seq_madd_plain", seq_counted)
    monkeypatch.setattr(keygen, "keygen_hash_plain", kg_counted)
    return calls


@pytest.mark.parametrize("switch,seq,keygen_calls", [(None, 2, 0), ("0", 0, 2), ("no", 0, 2),
                                                     ("1", 2, 0)])
def test_sequential_switch(monkeypatch, counted_paths, switch, seq, keygen_calls):
    """C2: ``VUKE_TPU_SEQUENTIAL`` in 0, false or no sends every superbatch
    of direct:be through the keygen; otherwise safe ones take K5.  The
    hit's host confirm runs the keygen's plain version once more."""
    if switch is None:
        monkeypatch.delenv("VUKE_TPU_SEQUENTIAL", raising=False)
    else:
        monkeypatch.setenv("VUKE_TPU_SEQUENTIAL", switch)
    start = 1 << 40
    addr = _addr((start + 70).to_bytes(32, "big"))
    res = scan_range(start, start + 127, TargetPools.from_addresses([addr]),
                     transform="direct:be", batch=64, device="cpu")
    assert [h.source for h in res.hits] == [str(start + 70)]
    assert counted_paths == {"seq_madd": seq, "keygen_hash": keygen_calls + 1}


def _targets(tmp_path, *addresses):
    path = tmp_path / "targets.txt"
    path.write_text("\n".join(addresses) + "\n")
    return str(path)


def test_scan_stdout_is_hit_blocks_and_stderr_the_reference_lines(tmp_path, capsys):
    """C3 and C5: stdout holds only the hit block; stderr the three lines
    of ``vuke_tpu/cli.py:383,268,338-339``, byte for byte: the count of
    distinct target lines, ``Scanning...`` and ``Done. ...``."""
    seed = 1000 + 21
    key = hashlib.sha256(str(seed).encode()).digest()
    d = KeyDeriver().derive(key)
    rc = cli.main(["scan", "--targets", _targets(tmp_path, d.p2pkh_uncompressed),
                   "--batch", "64", "--device", "cpu", "range", "--start", "1000",
                   "--end", "1063"])
    out, err = capsys.readouterr()
    assert rc == 0
    assert out == (f"{HIT_OPEN}Source: {seed}\nTransform: sha256\n"
                   f"Matched: {d.p2pkh_uncompressed} (p2pkh_uncompressed)\n---\n"
                   f"Private Key: {d.private_key_hex}\nWIF (compressed): {d.wif_compressed}\n"
                   f"WIF (uncompressed): {d.wif_uncompressed}\n---\n"
                   f"P2PKH (compressed): {d.p2pkh_compressed}\n"
                   f"P2PKH (uncompressed): {d.p2pkh_uncompressed}\nP2WPKH: {d.p2wpkh}\n"
                   f"{HIT_CLOSE}")
    assert err == ("Loaded 1 target addresses\nScanning...\n"
                   "Done. Inputs: 64, Keys: 192, Matches: 1\n")
    reference = open(os.path.join(REPO, "vuke_tpu", "cli.py")).read()
    assert 'click.echo(f"Loaded {matcher.count()} target addresses", err=True)' in reference
    assert '"Scanning..." if matcher is not None' in reference
    assert ('f"Done. Inputs: {stats.inputs_processed}, Keys: {stats.keys_generated}, "\n'
            '               f"Matches: {stats.matches_found}", err=True') in reference


@pytest.mark.parametrize("total,batch,want", [(100, None, 1024), (100, 4096, 1024),
                                              (1025, 4096, 2048), (5000, 4096, 4096),
                                              (3000, None, 3072), (1 << 20, None, 1 << 19)])
def test_batch_clamp(capsys, total, batch, want):
    """C4: a range shorter than the batch clamps it to max(1024, the range
    rounded up to 1024), with the reference's note where --batch was given."""
    assert cli._clamp_batch(batch, total) == want
    err = capsys.readouterr().err
    if batch is not None and total < batch:
        assert err == (f"note: --batch {batch} exceeds the {total}-seed range; clamping to "
                       f"{want}\n")
    else:
        assert err == ""


def test_cli_clamps_a_short_range(tmp_path, capsys, monkeypatch):
    """The clamp on the command line: 40 milksad seeds at --batch 4096 run
    as one superbatch of 1024."""
    batches = []
    init = ForwardDriver.__init__

    def spy(self, specs, pools, **kw):
        batches.append(kw["batch"])
        init(self, specs, pools, **kw)

    monkeypatch.setattr(ForwardDriver, "__init__", spy)
    d = KeyDeriver().derive(chip_smoke.host_milksad_key(1010))
    rc = cli.main(["scan", "--transform", "milksad", "--targets",
                   _targets(tmp_path, d.p2pkh_compressed), "--batch", "4096", "--device",
                   "cpu", "range", "--start", "1000", "--end", "1039"])
    out, err = capsys.readouterr()
    assert rc == 0 and batches == [1024]
    assert "Source: 1010\nTransform: milksad\n" in out
    assert err == ("Loaded 1 target addresses\nScanning...\nnote: --batch 4096 exceeds the "
                   "40-seed range; clamping to 1024\nDone. Inputs: 40, Keys: 40, Matches: 1\n")


def test_hits_in_program_then_slot_then_lane_order(tmp_path, capsys):
    """Two transforms (--transform twice): sha256 hits in its LE slot (lane
    5) and its string slot (lane 20) print the string slot's first; then
    md5's hit; Inputs count each transform's seeds."""
    base = 2000
    le = hashlib.sha256((base + 5).to_bytes(8, "little")).digest()
    text = hashlib.sha256(str(base + 20).encode()).digest()
    m = hashlib.md5(str(base + 9).encode()).digest()
    rc = cli.main(["scan", "--transform", "sha256", "--transform", "md5", "--targets",
                   _targets(tmp_path, _addr(le), _addr(text), _addr(m + m, "p2wpkh")),
                   "--batch", "32", "--device", "cpu", "range", "--start", str(base),
                   "--end", str(base + 31)])
    out, err = capsys.readouterr()
    assert rc == 0
    sources = [line for line in out.splitlines() if line.startswith(("Source", "Transform"))]
    assert sources == [f"Source: {base + 20}", "Transform: sha256", f"Source: {base + 5}",
                       "Transform: sha256", f"Source: {base + 9}", "Transform: md5"]
    assert err == "Loaded 3 target addresses\nScanning...\nDone. Inputs: 64, Keys: 128, Matches: 3\n"


def test_planted_sha256_string_slot():
    seed = (1 << 33) + 45
    addr = _addr(hashlib.sha256(str(seed).encode()).digest())
    res = scan_range(1 << 33, (1 << 33) + 127, TargetPools.from_addresses([addr]),
                     transform="sha256", batch=128, device="cpu")
    assert [(h.source, h.transform, h.address) for h in res.hits] == [
        (str(seed), "sha256", addr)]
    assert res.keys_generated == 3 * 128


def test_planted_lcg_msvc():
    """lcg's four variants: the hit in the msvc slot prints ':msvc'; seeds
    past glibc's and minstd's caps yield no key there."""
    start = (1 << 31) - 64
    seed = start + 100
    v = lcg.VARIANTS_BY_NAME["msvc"]
    addr = _addr(oracles.lcg_key(seed, v.a, v.c, v.m, True))
    res = scan_range(start, start + 127, TargetPools.from_addresses([addr]), transform="lcg",
                     batch=128, device="cpu")
    assert [(h.source, h.transform) for h in res.hits] == [(f"{seed}:msvc", "lcg")]
    # glibc: seeds <= 2^31 - 1 (64 of them), minstd <= 2^31 - 2 (63), msvc, borland all
    assert res.keys_generated == 64 + 63 + 128 + 128


def test_planted_sha256_chain_iterated():
    """sha256_chain:iterated: a key at depth 4 of the 4-byte half prints
    '[iterated:4]'; the binary half is valid below 2^32 only."""
    start = (1 << 32) - 48
    seed = start + 7
    key = chip_smoke.host_chain_key(seed.to_bytes(4, "big"), "iterated", 4)
    res = scan_range(start, start + 63, TargetPools.from_addresses([_addr(key)]),
                     transform="sha256_chain:iterated", batch=64, device="cpu")
    assert [(h.source, h.transform) for h in res.hits] == [
        (f"{seed}[iterated:4]", "sha256_chain:iterated")]
    assert res.hits[0].derived.private_key_hex == KeyDeriver().derive(key).private_key_hex
    assert res.keys_generated == 10 * 64 + 10 * 48
