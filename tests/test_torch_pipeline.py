"""vuke_tpu_torch scan plumbing: mask packing, the u64 seed carry, a planted
milksad scan on the CPU (also with ``VUKE_TPU_SMUL13=0``, through K6's plain
version), the command line, and the jax-free import rule."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vuke_tpu import pipeline as jpipe
from vuke_tpu.derive import KeyDeriver
from vuke_tpu_torch import cli
from vuke_tpu_torch.matcher import TargetPools
from vuke_tpu_torch.pipeline import pack_mask, scan_range, seed_lattice, unpack_mask

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SITE_DIRS = [p for p in sys.path if p.endswith("site-packages")]


def test_pack_mask_matches_jax_and_unpacks():
    m = np.random.default_rng(0).random(1024) < 0.1
    m[0] = m[31] = m[1023] = True
    got = pack_mask(torch.from_numpy(m)).to(torch.int64).numpy()
    assert np.array_equal(got, np.asarray(jpipe._pack_mask(jnp.asarray(m))))
    assert np.array_equal(unpack_mask(got, 1024), m)
    assert np.array_equal(jpipe._unpack_mask(got, 1024), m)


@pytest.mark.parametrize("start", [0, 0xFFFFFF00, (7 << 32) | 0xFFFFFFF0])
def test_seed_lattice_carries_like_jax(start):
    offs = np.arange(512, dtype=np.uint32)
    hi, lo = seed_lattice(start, torch.from_numpy(offs).to(torch.int64))
    jhi, jlo = jpipe._seed_lattice(np.uint32(start >> 32), np.uint32(start & 0xFFFFFFFF),
                                   jnp.asarray(offs))
    assert np.array_equal(hi.to(torch.int64).numpy(), np.asarray(jhi))
    assert np.array_equal(lo.to(torch.int64).numpy(), np.asarray(jlo))


def _planted(seed):
    from vuke_tpu_torch.cores import mt19937
    kw = mt19937.milksad_key_words(torch.tensor([seed], dtype=torch.int64).to(torch.uint32))
    key = b"".join(int(v).to_bytes(4, "big") for v in kw[:, 0].to(torch.int64))
    return KeyDeriver().derive(key)


def test_scan_range_finds_planted_seeds():
    a, b = _planted(1000), _planted(1070)
    pools = TargetPools.from_addresses(
        [a.p2pkh_uncompressed, b.p2wpkh, "1BoatSLRHtKNngkdXEeobR76b53LETtpyT"])
    res = scan_range(990, 1077, pools, batch=64, device="cpu")
    assert res.inputs_processed == res.keys_generated == 88
    assert [(h.seed, h.address_type) for h in res.hits] == [
        (1000, "p2pkh_uncompressed"), (1070, "p2wpkh")]


def test_scan_range_skips_seeds_past_u32():
    pools = TargetPools.from_addresses([_planted(5).p2pkh_compressed])
    res = scan_range((1 << 32) - 32, (1 << 32) + 31, pools, batch=32, device="cpu")
    assert res.inputs_processed == 64 and res.keys_generated == 32
    assert res.hits == []


@pytest.fixture
def k6_only(monkeypatch):
    """``VUKE_TPU_SMUL13=0``; counts the calls of K6's plain version, and
    K3's plain version fails if it is reached."""
    from vuke_tpu_torch.ecc import incremental, smul, smul_w8

    calls = []
    k6_plain = smul_w8.scalar_mul_plain

    def counted(words, table):
        calls.append(words.shape[1])
        return k6_plain(words, table)

    def refused(words, table):
        raise AssertionError("K3 ran with VUKE_TPU_SMUL13=0")

    monkeypatch.setenv("VUKE_TPU_SMUL13", "0")
    monkeypatch.setattr(smul_w8, "scalar_mul_plain", counted)
    monkeypatch.setattr(smul, "scalar_mul_plain", refused)
    incremental._cached_table.cache_clear()
    yield calls
    incremental._cached_table.cache_clear()


def test_scan_with_smul13_off_finds_planted_milksad_seed(k6_only):
    d = _planted(1000)
    pools = TargetPools.from_addresses([d.p2pkh_compressed])
    res = scan_range(990, 1053, pools, batch=32, device="cpu")
    assert [(h.seed, h.address_type) for h in res.hits] == [(1000, "p2pkh_compressed")]
    assert k6_only == [32, 32]


def test_direct_be_with_smul13_off_takes_k6_on_unsafe_superbatches(k6_only):
    """[1, 1024] at batch 256: the superbatches from 1 and 257 start below
    batch + 2 and take K6; the table of the sequential ones (from 513 and
    769, where key 700 lies) is built with K6 too."""
    from vuke_tpu_torch.derive import KeyDeriver

    addr = KeyDeriver().derive((700).to_bytes(32, "big")).p2pkh_compressed
    res = scan_range(1, 1024, TargetPools.from_addresses([addr]), transform="direct:be",
                     batch=256, device="cpu")
    assert [(h.seed, h.address) for h in res.hits] == [(700, addr)]
    assert k6_only == [256, 256, 256]


def test_cli_scan_prints_the_hit(tmp_path, capsys):
    d = _planted(42)
    path = tmp_path / "targets.txt"
    path.write_text(f"# planted\n{d.p2pkh_compressed}\n\n")
    rc = cli.main(["scan", "--transform", "milksad", "--targets", str(path),
                   "--batch", "32", "--device", "cpu", "range", "--start", "40",
                   "--end", "71"])
    out, err = capsys.readouterr()
    assert rc == 0
    assert "Source: 42\n" in out
    assert f"Matched: {d.p2pkh_compressed} (p2pkh_compressed)" in out
    assert f"Private Key: {d.private_key_hex}" in out
    assert err.strip().splitlines()[-1] == "Done. Inputs: 32, Keys: 32, Matches: 1"


@pytest.mark.parametrize("argv", [
    ["scan", "--transform", "electrum", "--targets", "T", "--cloud-bucket", "b", "range",
     "--start", "1", "--end", "2"],
    ["scan", "--transform", "milksad", "--targets", "T", "--storage", "D", "wordlist",
     "--file", "W"],
    ["generate", "--bitimage-path", "m/0", "--compression", "zstd", "--batch", "64", "range",
     "--start", "1", "--end", "64"],
])
def test_cli_refuses_what_is_not_ported(argv, tmp_path, capsys):
    """The storage and cloud options, which the port once refused as not
    ported, now run (``--cloud-bucket`` alone uploads nothing; a scan
    without hits writes no chunk) and end in the ``Done.`` line."""
    (tmp_path / "T").write_text("1BgGZ9tcN4rm9KBzDn7KprQz87SZ26SAMH\n")
    (tmp_path / "W").write_text("alpha\nbeta\n")
    argv = [str(tmp_path / a) if a in ("T", "D", "W") else a for a in argv]
    assert cli.main(argv[:1] + ["--device", "cpu"] + argv[1:]) == 0
    out, err = capsys.readouterr()
    assert "not ported" not in out + err
    assert err.splitlines()[-1].startswith("Done. Inputs: ")
    assert not list(tmp_path.rglob("*.parquet"))


def test_port_imports_without_jax():
    """Every module of the port, and ``chip_smoke``, import neither jax nor
    anything of the JAX package (``python -S``, a minimal path, as
    tests/test_host_fast.py does)."""
    code = """
import importlib, pkgutil, sys
import vuke_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vuke_tpu_torch.__path__, 'vuke_tpu_torch.')
         if m.name != 'vuke_tpu_torch.__main__']   # runs the command line
assert len(names) >= 40, names
assert {'vuke_tpu_torch.ecc.smul_w8', 'vuke_tpu_torch.ecc.pubkey'} <= set(names), names
assert {'vuke_tpu_torch.cores.' + m for m in ('common', 'decimal', 'sha256', 'md5', 'lcg',
        'xorshift', 'sha256_chain', 'keygen')} <= set(names), names
assert {'vuke_tpu_torch.transforms.numeric', 'vuke_tpu_torch.transforms.registry'} <= set(names)
assert {'vuke_tpu_torch.' + m for m in ('transforms.strings', 'cores.digest', 'cores.p2pkh',
        'output', 'output.console', 'output.multi', 'progress', 'parallel',
        'parallel.checkpoint', 'parallel.multihost', 'parallel.mesh', 'parallel.dryrun',
        'sources')} <= set(names), names
assert {'vuke_tpu_torch.' + m for m in ('provider', 'analyze', 'analyze.analyzers',
        'analyze.key_parser', 'analyze.output', 'analyze.sweeps', 'cores.sweep')} <= set(names)
assert {'vuke_tpu_torch.' + m for m in ('storage', 'storage.records', 'storage.parquet_backend',
        'storage.output', 'storage.query', 'storage.cloud', 'storage.cloud.s3',
        'storage.iceberg', 'cores.records')} <= set(names), names
for name in names + ['chip_smoke']:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == 'jax' or m.startswith('jax.') or m == 'vuke_tpu' or m.startswith('vuke_tpu.'))
assert not bad, bad
lazy = sorted(m for m in sys.modules
              if m.split('.')[0] in ('pyarrow', 'requests', 'duckdb', 'pyiceberg'))
assert not lazy, lazy
print('OK', len(names))
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO] + SITE_DIRS)
    r = subprocess.run([sys.executable, "-S", "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "OK" in r.stdout
