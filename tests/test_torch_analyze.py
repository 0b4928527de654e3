"""vuke_tpu_torch's ``analyze`` against the JAX package's on the CPU: S1's
and S2's plain versions against the JAX keystreams and ``_mask_compare``
(every family, variant and mode, across the 64-bit carry, the u32 wrap and
the zero seed, ``bits = 64``), each analyzer's ``AnalysisResult`` for
planted seeds, ``run_analyze`` and the ``analyze`` command line byte for
byte (the mt64 text's elapsed seconds masked), ``key_parser`` and
``output``, the host loop's batches, a checkpoint resume, and a kernel
failure that raises.

The JAX sweeps run eagerly: their module's ``jax.jit`` is the identity and
the keystreams run under ``vuke_tpu._lazy.numpy_backend`` (a jitted sweep
takes minutes of XLA:CPU compile here).  Every comparison is exact."""

import io
import json
import re
import types

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import chip_smoke
import vuke_tpu.analyze as janalyze
import vuke_tpu.analyze.sweeps as jsweeps
from vuke_tpu._lazy import numpy_backend
from vuke_tpu.analyze import analyzers as ja
from vuke_tpu.analyze import key_parser as jkp
from vuke_tpu.analyze import output as jout
from vuke_tpu.cli import cli as jcli
from vuke_tpu.cores import lcg as jlcg
from vuke_tpu.cores import xorshift as jxs
from vuke_tpu_torch import cli
from vuke_tpu_torch import analyze as panalyze
from vuke_tpu_torch.analyze import analyzers as pa
from vuke_tpu_torch.analyze import key_parser as pkp
from vuke_tpu_torch.analyze import output as pout
from vuke_tpu_torch.analyze import sweeps as psweeps
from vuke_tpu_torch.cores import lcg, sweep

LANES = 256
SPACE = 1 << 32
ELAPSED = re.compile(r" in \d+\.\d\ds")


@pytest.fixture
def eager(monkeypatch):
    """The JAX sweeps unjitted, their keystreams in eager numpy."""
    monkeypatch.setattr(jsweeps, "jax", types.SimpleNamespace(jit=lambda f: f))
    with numpy_backend():
        yield


def milksad_key(seed: int) -> bytes:
    return chip_smoke.host_milksad_key(seed)


# --- S1 and S2's plain versions against the JAX steps ---

def jax_keystream(family: str, v: int, be: bool):
    if family == "milksad":
        return ja.MilksadAnalyzer._keystream
    if family == "mt64":
        return ja.Mt64Analyzer._keystream
    if family == "lcg":
        return lambda hi, lo, n: jlcg.lcg_key_words(lo, jlcg.ALL_VARIANTS[v], be)[:, None, :]
    return jxs.KEYSTREAM_FNS[jxs.VARIANT_NAMES[v]]


def jax_record(prog, start: int, cmp: sweep.Compare) -> list:
    words = np.array(cmp.words, dtype=np.uint32) if cmp.mode == "exact" else None
    res = prog.run_batch(start, prog.batch, words)
    return [int(res["idx"]) if bool(res["found"]) else sweep.NONE,
            int(res.get("first_filter_hits", 0))]


def jax_args(cmp: sweep.Compare) -> dict:
    if cmp.mode == "mask":
        return {"mask": cmp.targets[0]}
    if cmp.mode == "cascade":
        return {"cascade": cmp.targets}
    return {}


PRNG_STREAMS = ([("milksad", 0, True, SPACE - LANES), ("mt64", 0, True, (5 << 32) + SPACE - 128)]
                + [("lcg", v, be, SPACE - LANES) for v in range(4) for be in (True, False)]
                + [("xorshift", v, True, (5 << 32) + SPACE - 128) for v in range(4)]
                # the u64 wrap: seed 0 becomes 1
                + [("xorshift", v, True, (1 << 64) - 128) for v in range(4)])


@pytest.mark.parametrize("family, v, be, start", PRNG_STREAMS)
def test_sweep_prng_plain_matches_jax_step(family, v, be, start, eager):
    """Exact and 64-bit mask on the middle lane, exact and a 12-bit mask on
    the last, cascades of 5 and 2 targets with the first filter: the
    record (first hit, first-filter count) equals the JAX step's."""
    nk = 1 if family == "lcg" else 5
    mid = LANES // 2 + 3
    keys_mid = chip_smoke.plain_keys(family, v, be, (start + mid) % (1 << 64), nk)
    keys_last = chip_smoke.plain_keys(family, v, be, (start + LANES - 1) % (1 << 64), nk)
    cmps = chip_smoke.sweep_compares(keys_mid, keys_last, family != "lcg")
    rec = torch.empty(2, dtype=torch.int64)
    for cmp in cmps:
        got = sweep.sweep_prng(rec, start, LANES, family, v, be, cmp).tolist()
        prog = jsweeps.SweepProgram(jax_keystream(family, v, be), cmp.mode, batch=LANES,
                                    track_first_filter=cmp.track, **jax_args(cmp))
        assert got == jax_record(prog, start, cmp), (cmp.mode, cmp.targets)
        assert got[0] != sweep.NONE


@pytest.mark.parametrize("variant", sweep.CHAIN_VARIANTS)
def test_sweep_chain_plain_matches_jax_step(variant, eager):
    """Every mode of one chain variant at depth 10 across the u32 wrap."""
    lanes = LANES // 2
    start, mid = SPACE - lanes // 2, lanes // 2 + 5
    km = chip_smoke.plain_chain(variant, start + mid, 10)
    kl = chip_smoke.plain_chain(variant, start + lanes - 1, 10)
    cmps = (chip_smoke.sweep_compares([km[7]], [kl[9]], False)
            + chip_smoke.sweep_compares(km[:5], kl[:2], True, track=False)[4:])
    rec = torch.empty(2, dtype=torch.int64)
    for cmp in cmps:
        depth = cmp.n_targets if cmp.mode == "cascade" else 10
        got = sweep.sweep_chain(rec, start, lanes, variant, depth, cmp).tolist()
        prog = jsweeps.ChainSweepProgram(variant, depth, cmp.mode, batch=lanes, **jax_args(cmp))
        assert got == jax_record(prog, start, cmp), (cmp.mode, cmp.targets)
        assert got[0] != sweep.NONE


CASCADE_FAMILIES = [("milksad", 0), ("mt64", 0)] + [("xorshift", v) for v in range(4)]


@pytest.mark.parametrize("k", [29, 40, 100])
@pytest.mark.parametrize("family, v", CASCADE_FAMILIES + [(c, None) for c in sweep.CHAIN_VARIANTS])
def test_long_cascades_match_jax_step(family, v, k, eager):
    """Cascades of 29, 40 and 100 targets (milksad's keys past output 224,
    mt64's past 156, where the init block ends) from a planted seed's own
    keys, target 0 of 4 bits so that an eighth of the lanes pass it: the
    record (first hit, first-filter count) equals the JAX step's."""
    lanes = 128
    chain = v is None
    start = (SPACE - lanes // 2 if chain else
             (5 << 32) + SPACE - lanes // 2 if family != "milksad" else SPACE - lanes)
    planted = start + lanes // 2 + 7
    keys = ([chip_smoke.host_chain_key((planted % SPACE).to_bytes(4, "big"), family, d)
             for d in range(k)]
            if chain else chip_smoke.plain_keys(family, v, True, planted, k))
    bits = [4] + [8 + j % 17 for j in range(1, k)]
    cmp = sweep.Compare("cascade", track=not chain,
                        targets=tuple((b, pkp.apply_mask(key, b)) for b, key in zip(bits, keys)))
    rec = torch.empty(2, dtype=torch.int64)
    if chain:
        got = sweep.sweep_chain(rec, start, lanes, family, k, cmp).tolist()
        prog = jsweeps.ChainSweepProgram(family, k, "cascade", batch=lanes, cascade=cmp.targets)
    else:
        got = sweep.sweep_prng(rec, start, lanes, family, v, True, cmp).tolist()
        prog = jsweeps.SweepProgram(jax_keystream(family, v, True), "cascade", batch=lanes,
                                    track_first_filter=True, cascade=cmp.targets)
    assert got == jax_record(prog, start, cmp)
    assert got[0] == planted - start and (chain or got[1] > 1)


def test_compare_and_kernel_arguments_are_checked():
    """What S1 and S2 refuse before any launch, on either device."""
    rec = torch.empty(2, dtype=torch.int64)
    exact = sweep.Compare("exact", words=(1,) * 8)
    casc = sweep.Compare("cascade", targets=((5, 0x15), (10, 0x202)))
    for bad in (lambda: sweep.Compare("exact", words=(1,) * 7),
                lambda: sweep.Compare("mask", targets=((5, 0x15), (6, 0x21))),
                lambda: sweep.Compare("cascade", targets=()),
                lambda: sweep.Compare("nope"),
                lambda: sweep.sweep_prng(rec, 0, 16, "lcg", 0, True, casc),
                lambda: sweep.sweep_prng(rec, 0, 16, "xorshift", 4, True, exact),
                lambda: sweep.sweep_prng(rec, 0, 16, "nope", 0, True, exact),
                lambda: sweep.sweep_prng(rec, 1 << 64, 16, "mt64", 0, True, exact),
                lambda: sweep.sweep_prng(torch.empty(3, dtype=torch.int64), 0, 16, "mt64", 0,
                                         True, exact),
                lambda: sweep.sweep_chain(rec, 0, 16, "nope", 10, exact),
                lambda: sweep.sweep_chain(rec, 0, 16, "iterated", 0, exact)):
        with pytest.raises(ValueError):
            bad()
    assert sweep.mask_words(64, (1 << 64) - 1) == (2 ** 32 - 1,) * 2 + (2 ** 31, 0) + (
        2 ** 32 - 1,) * 2
    assert casc.packed[:12].tolist() == list(sweep.mask_words(5, 0x15) + sweep.mask_words(
        10, 0x202))


# --- the analyzers ---

def chain_key(seed: int, variant: str, d: int) -> bytes:
    return chip_smoke.plain_chain(variant, seed, d + 1)[d]


def mt64_cascade() -> list:
    return [(5, 0x15), (10, 0x202)]


ANALYZERS = {
    # name: (make(module, variant table), key, config)
    "milksad exact": (lambda m, t: m.MilksadAnalyzer(), milksad_key(5000), {}),
    "milksad exact, not found": (lambda m, t: m.MilksadAnalyzer(), bytes(31) + b"\x07", {}),
    "milksad mask 30": (lambda m, t: m.MilksadAnalyzer(), bytes(28) + milksad_key(6000)[28:],
                        {"mask_bits": 30}),
    "milksad mask 64": (lambda m, t: m.MilksadAnalyzer(), milksad_key(7000), {"mask_bits": 64}),
    "milksad cascade": (lambda m, t: m.MilksadAnalyzer(), bytes(32),
                        {"cascade_targets": [(8, 0x80 | milksad_key(3000)[31] & 0x7F),
                                             (12, 0x800 | int.from_bytes(
                                                 chip_smoke.plain_keys("milksad", 0, True, 3000,
                                                                       2)[1][30:], "big")
                                              & 0x7FF)]}),
    "mt64 cascade, a false positive at 4074": (lambda m, t: m.Mt64Analyzer(), bytes(32),
                                               {"cascade_targets": mt64_cascade()}),
    "mt64 without a cascade": (lambda m, t: m.Mt64Analyzer(), bytes(32), {}),
    "mt64 cascade, not found": (lambda m, t: m.Mt64Analyzer(), bytes(32),
                                {"cascade_targets": [(20, 0x80001), (40, 1 << 39)]}),
    "lcg exact in minstd": (lambda m, t: m.LcgAnalyzer(), chip_smoke.host_lcg_key(
        1234, lcg.MINSTD), {}),
    "lcg:le mask 24 in msvc": (lambda m, t: m.LcgAnalyzer(None, False), chip_smoke.host_lcg_key(
        777, lcg.MSVC, False), {"mask_bits": 24}),
    "lcg:glibc, not found": (lambda m, t: m.LcgAnalyzer(t["glibc"]), bytes(32), {}),
    "xorshift cascade in xorshift128": (lambda m, t: m.XorshiftAnalyzer(), bytes(32), {
        "cascade_targets": [(b, pkp.apply_mask(k, b)) for b, k in zip(
            (8, 16), chip_smoke.plain_keys("xorshift", 1, True, 700, 2))]}),
    "xorshift without a cascade": (lambda m, t: m.XorshiftAnalyzer("xorshift64"), bytes(32), {}),
    "sha256_chain exact, iterated": (lambda m, t: m.Sha256ChainAnalyzer("iterated", 10),
                                     chain_key(1000, "iterated", 3), {}),
    "sha256_chain mask 20, counter": (lambda m, t: m.Sha256ChainAnalyzer("counter", 12),
                                      chain_key(900, "counter", 11), {"mask_bits": 20}),
    "sha256_chain cascade, indexed:le": (lambda m, t: m.Sha256ChainAnalyzer("indexed:le"),
                                         bytes(32), {"cascade_targets": [
                                             (b, pkp.apply_mask(chain_key(600, "indexed:le", d),
                                                                b)) for d, b in enumerate(
                                                 (6, 12, 18))]}),
    "sha256_chain, every variant, not found": (lambda m, t: m.Sha256ChainAnalyzer(),
                                               bytes(32), {}),
    "direct": (lambda m, t: m.DirectAnalyzer(), b"hello world".ljust(32, b"\0"), {}),
    "direct, masked": (lambda m, t: m.DirectAnalyzer(), bytes(32), {"mask_bits": 8}),
    "heuristic": (lambda m, t: m.HeuristicAnalyzer(), bytes.fromhex("ab" * 16 + "cd" * 16), {}),
    "heuristic, random": (lambda m, t: m.HeuristicAnalyzer(), milksad_key(1), {}),
}


def result(r) -> tuple:
    return r.analyzer, r.status.value, ELAPSED.sub(" in Xs", r.details or "")


@pytest.mark.parametrize("name", list(ANALYZERS))
def test_analyzer_matches_jax(name, eager):
    """The same ``AnalysisResult`` for the same key and config, batch 4096
    (chain batches of 1024) over at most 2^13 seeds a space."""
    make, key, cfg = ANALYZERS[name]
    base = {"batch": 4096, "max_seeds": 8192 if "chain" not in name else 1024}
    got = make(pa, lcg.VARIANTS_BY_NAME).analyze(
        key, pa.AnalysisConfig(**base, **cfg, device="cpu"))
    want = make(ja, jlcg.VARIANTS_BY_NAME).analyze(key, ja.AnalysisConfig(**base, **cfg))
    assert result(got) == result(want)
    if name == "mt64 cascade, a false positive at 4074":
        assert got.details == "seed = 4074, cascade=[P5:0x15,P10:0x202]"


# --- the host loop ---

def counting(monkeypatch, cls, counts, key):
    run = cls.run_batch

    def counted(self, *a, **k):
        counts[key] = counts.get(key, 0) + 1
        return run(self, *a, **k)

    monkeypatch.setattr(cls, "run_batch", counted)


@pytest.mark.parametrize("seed, end", [(5000, 16383), (700, 10 * 512 - 1), (None, 10 * 512 - 1)])
def test_sweep_loop_matches_jax(seed, end, eager, monkeypatch):
    """Batches launched and read as the JAX loop does: up to three in
    flight, stop at the first batch with a hit (later launches unread), the
    same seed and ``searched``; a miss sweeps all ten batches."""
    counts = {}
    counting(monkeypatch, jsweeps.SweepProgram, counts, "jax")
    counting(monkeypatch, psweeps.SweepProgram, counts, "port")
    key = milksad_key(seed) if seed is not None else bytes(32)
    words = pa.key_bytes_to_words(key)
    got = psweeps.sweep(psweeps.SweepProgram("milksad", "exact", batch=512, device="cpu"),
                        0, end, target_words=words)
    want = jsweeps.sweep(jsweeps.SweepProgram(ja.MilksadAnalyzer._keystream, "exact",
                                              batch=512), 0, end,
                         target_words=np.array(words, dtype=np.uint32))
    assert (got.found, got.seed, got.searched, got.cascade_hits) == (
        want.found, want.seed, want.searched, want.cascade_hits)
    batches = (end + 1) // 512
    assert counts["port"] == counts["jax"] == (
        batches if seed is None else min(seed // 512 + 3, batches))


def test_checkpoint_resume_matches_jax(tmp_path, eager):
    """A milksad sweep checkpointed over its first half, then resumed to
    the seed; then a chain hit, whose (seed, index) comes back from the
    JSON manifest as a pair: the same results and manifests."""
    key = milksad_key(1500)
    for mod, name in ((pa, "port"), (ja, "jax")):
        path = tmp_path / f"{name}.json"
        cfg = dict(batch=256, checkpoint_path=str(path))
        if mod is pa:
            cfg["device"] = "cpu"
        first = mod.MilksadAnalyzer().analyze(key, mod.AnalysisConfig(max_seeds=1024, **cfg))
        manifest = json.loads(path.read_text())
        second = mod.MilksadAnalyzer().analyze(key, mod.AnalysisConfig(max_seeds=2048, **cfg))
        chain = chain_key(700, "iterated", 4)
        cpath = tmp_path / f"{name}_chain.json"
        cfg.update(checkpoint_path=str(cpath), batch=1024)
        runs = [mod.Sha256ChainAnalyzer("iterated").analyze(
            chain, mod.AnalysisConfig(max_seeds=1024, **cfg)) for _ in range(2)]
        out = (result(first), manifest, result(second), json.loads(path.read_text()),
               [result(r) for r in runs], json.loads(cpath.read_text()))
        if mod is pa:
            got = out
    assert got == out
    assert got[1]["completed"] == [[0, 1023]] and got[3]["found_seed"] == 1500
    assert got[5]["found_seed"] == [700, 4] and got[4][0] == got[4][1]


def test_kernel_failure_raises_without_fallback(monkeypatch):
    """A failed S1 launch raises out of the analyzer, and nothing runs the
    plain version instead; without a card, the card's path raises."""
    def failed(*a, **k):
        raise RuntimeError("sweep_prng: kernel launch failed: invalid argument (1)")

    def plain(*a, **k):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(sweep, "sweep_prng", failed)
    monkeypatch.setattr(sweep, "sweep_prng_plain", plain)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        pa.MilksadAnalyzer().analyze(bytes(32), pa.AnalysisConfig(batch=1024, max_seeds=1024,
                                                                   device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        panalyze.run_analyze("0x1", analyzers=["milksad"], out=io.StringIO())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["analyze", "0x1", "--fast"])


# --- run_analyze and the command line ---

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


def masked(run):
    rc, out, err = run
    return rc, ELAPSED.sub(" in Xs", out), err


SMALL = ["--batch", "2048", "--max-seeds", "2048"]
P40 = "0x" + "e9ae4933d6"
P21 = "0x1ba534"
# 29 targets: one key past the 28 that MT19937's init block gives milksad
CASCADE_29 = ",".join(f"{b}:0x{1 << (b - 1):x}" for b in range(4, 33))


@pytest.mark.parametrize("argv", [
    # every analyzer, text; then JSON with a literal cascade (mt64 finds 4074)
    ["analyze", "0x" + milksad_key(100).hex()] + SMALL,
    ["analyze", "1234", "--cascade", "5:0x15,10:0x202", "--json"] + SMALL,
    ["analyze", P40, "--puzzle", "boha:b1000:40:3", "--analyzer", "milksad"] + SMALL,
    ["analyze", P40, "--puzzle", "boha:b1000:67", "--analyzer", "lcg:glibc"] + SMALL,
    ["analyze", P40, "--cascade", "boha:b1000:67", "--analyzer", "mt64",
     "--analyzer", "xorshift:128plus"] + SMALL,
    ["analyze", P21, "--verify", "boha:b1000", "--fast"],
    ["analyze", "0x1", "--verify", "all", "--fast", "--json"],
    ["analyze", "0xdeadbeef", "--verify", "b1000", "--fast"],
    ["analyze", "0x" + chip_smoke.host_lcg_key(99, lcg.BORLAND, False).hex(), "--mask", "24",
     "--analyzer", "lcg:le", "--analyzer", "SHA256_chain:indexed:le", "--chain-depth", "3"]
    + SMALL,
    ["analyze", "5HueCGU8rMjxEXxiPuD5BDku4MkFqeZyd4dZ1jvhTVqvbTLvyTJ", "--fast"],
    ["analyze", P21, "--cascade", CASCADE_29, "--fast"],
])
def test_analyze_command_matches_jax(argv, capsys, eager):
    """stdout and stderr byte for byte (``Running X (brute-force)...``,
    the ``--puzzle`` lines, the ``--verify`` lines), exit code 0."""
    got = masked(port_run(argv, capsys))
    assert got == masked(jax_run(argv))
    assert got[0] == 0


@pytest.mark.parametrize("argv", [
    ["analyze", "0x1", "--mask", "65"],
    ["analyze", "0x1", "--analyzer", "multibit-hd"],
    ["analyze", "0x1", "--analyzer", "multibit-hd", "--mnemonic", "abandon"],
    ["analyze", "0x1", "--cascade", CASCADE_29, "--analyzer", "mt64"] + SMALL,
    ["analyze", "0x1", "--cascade", CASCADE_29] + SMALL,
])
def test_analyze_refusals(argv, capsys, eager):
    """--mask out of 1..64: click's error line and exit code 2, before any
    sweep.  The wallet analyzer without a mnemonic or with a bad one, and
    a cascade of more targets than the sweeps once held (28), which the
    port refused: now the JAX command line's stdout and stderr, exit 0."""
    rc, out, err = port_run(argv, capsys)
    jrc, jout_, jerr = jax_run(argv)
    if "--mask" in argv:
        assert (rc, out, err.splitlines()[-1]) == (jrc, jout_, jerr.splitlines()[-1]) and rc == 2
        assert "Running" not in err
    else:
        assert masked((rc, out, err)) == masked((jrc, jout_, jerr)) and rc == 0


def test_run_analyze_json_matches_jax(capsys, eager):
    """``run_analyze`` itself, ``out`` a buffer: every analyzer as JSON."""
    key = "0x" + chip_smoke.host_lcg_key(5, lcg.GLIBC).hex()
    got, want = io.StringIO(), io.StringIO()
    panalyze.run_analyze(key, as_json=True, batch=2048, max_seeds=1024, out=got, device="cpu")
    port_err = capsys.readouterr().err
    janalyze.run_analyze(key, as_json=True, batch=2048, max_seeds=1024, out=want)
    assert got.getvalue() == want.getvalue() and port_err == capsys.readouterr().err
    assert json.loads(got.getvalue())["results"][2]["details"] == "variant=glibc, seed=5, endian=be"


# --- key_parser and output ---

@pytest.mark.parametrize("s", [
    "0x1", "1", "ff" * 32, "0x" + "ff" * 33, "", "zz", "12345678901234567890",
    str(2 ** 256), "115792089237316195423570985008687907852837564279074904382605163141518161494337",
    "5HueCGU8rMjxEXxiPuD5BDku4MkFqeZyd4dZ1jvhTVqvbTLvyTJ",
    "KwdMAjGmerYanjeui5SHS7JkmpZvVipYvB2LJGU1ZxJwYvP98617", "5HueCGU8rMjxEXxiPuD5BDku4MkFqeZyd4dZ1jvhTVqvbTLvyTX",
    " 0xabc ", "cafe",
])
def test_parse_private_key_matches_jax(s):
    def parse(mod):
        try:
            return mod.parse_private_key(s)
        except ValueError as e:
            return type(e).__name__, str(e)
    assert parse(pkp) == parse(jkp)


@pytest.mark.parametrize("s", [
    "5:0x15,10:0x202", "10:0x202,5:0x15,20:0xd2c55", "5:21,6:33", "", "5:0x15", "5:0x15,5:0x15",
    "5:0x15,65:1", "5:0x5,6:0x21", "5:0x40,6:0x21", "a:1,2:3", "5:0x15,6:zz", "5:0x15:1,6:0x21",
    "64:0xffffffffffffffff,63:0x4000000000000000", " 5:0x15 , 6:0x21 ,",
])
def test_parse_cascade_and_mask_match_jax(s):
    def parse(mod):
        try:
            return mod.parse_cascade(s)
        except ValueError as e:
            return type(e).__name__, str(e)
    assert parse(pkp) == parse(jkp)
    key = milksad_key(len(s))
    for bits in (1, 5, 31, 32, 33, 63, 64):
        assert pkp.apply_mask(key, bits) == jkp.apply_mask(key, bits)


def test_output_matches_jax():
    """Text and JSON, with escapes and a result without details."""
    key = milksad_key(3)
    details = ['tab\there "quote" back\\slash\nline\rcr \x01', None, "seed = 5", ""]
    statuses = ["CONFIRMED", "POSSIBLE", "NOT_FOUND", "UNKNOWN"]

    def render(mod, out):
        rs = [mod.AnalysisResult(f"a{i}", mod.AnalysisStatus[s], d)
              for i, (s, d) in enumerate(zip(statuses, details))]
        meta = mod.KeyMetadata.from_key(key)
        return out.format_results(meta, rs), out.format_results_json(meta, rs), meta

    got, want = render(pa, pout), render(ja, jout)
    assert got[:2] == want[:2] and vars(got[2]) == vars(want[2])
    assert [s.symbol() for s in pa.AnalysisStatus] == [s.symbol() for s in ja.AnalysisStatus]


# --- the sweeps' operation counts (kernels/work.py) ---

@pytest.mark.parametrize("family, v", [("milksad", 0), ("mt64", 0)]
                         + [("xorshift", v) for v in range(4)])
def test_work_lanes_stream_the_keys(family, v):
    """Run on known words, the counted lanes of n keys compute the plain
    keystreams' keys (so the counts follow the functions); the bound of a
    cascade grows with the share of lanes its further keys reach."""
    from vuke_tpu_torch.kernels import work

    seed = (3 << 32) | 12345
    t = work.Trace()
    if family == "milksad":
        words = work.mt19937_lane(t, seed & 0xFFFFFFFF, 3)
    elif family == "mt64":
        words = work.mt64_lane(t, seed >> 32, seed & 0xFFFFFFFF, 3)
    else:
        words = work.xorshift_lane(t, sweep.xorshift.VARIANT_NAMES[v], seed >> 32,
                                   seed & 0xFFFFFFFF, 3)
    assert b"".join(w.to_bytes(4, "big") for w in words) == b"".join(
        chip_smoke.plain_keys(family, v, True, seed, 3))
    assert t.ops == work.Ops()
    one = work.sweep_prng(family, "cascade", v)
    more = work.sweep_prng(family, "cascade", v, reach=(1.0, 0.5, 0.25))
    assert more.cycles() > one.cycles() > 0
    # exact: with every lane past word 0, the whole key and 8 compares
    assert work.sweep_prng(family, "exact", v, reach=(1.0, 1.0)).alu == one.alu + 4
    assert work.sweep_prng(family, "exact", v).cycles() <= one.cycles()


def test_work_chain_counts_a_compression_a_position():
    from vuke_tpu_torch.kernels import work

    t = work.Trace()
    work.sha256_block(t, work.SHA_IV, [None] + [0] * 15)
    for v in sweep.CHAIN_VARIANTS:
        ten = work.sweep_chain(v, "exact", [1.0] * 10)
        assert ten.alu > 10 * t.ops.alu * 0.9 and ten.cycles() > 0
        assert work.sweep_chain(v, "mask", [1.0, 0.5]).cycles() < ten.cycles()
