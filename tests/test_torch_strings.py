"""vuke_tpu_torch's string transforms, D1's and D2's plain versions and
``single`` against the JAX package, on the CPU.

- Every string transform's key words and validity against
  ``vuke_tpu.transforms`` on the same seeded strings (0 to 300 bytes,
  non-ASCII, the 55/56 and 119/120-byte padding edges, the empty string),
  lane for lane (tolerance 0: integers); the JAX side takes its hashlib
  path (at most 4096 strings, no jit), the port's also its D1 path
  (``VUKE_HOST_DIGEST_MAX`` below the batch: D1's plain version).
- D1's plain version against the JAX ``sha256_blocks`` and ``md5_blocks``
  run eagerly in numpy (``vuke_tpu._lazy.numpy_backend``) and hashlib.
- D2's plain version against ``vuke_tpu.encode.p2pkh_address`` for the
  four networks.
- ``single`` through the port's command line against the JAX click
  command (``CliRunner``), stdout and stderr byte for byte, without
  initializing CUDA or building a kernel.
"""

import hashlib

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from vuke_tpu import encode as jencode
from vuke_tpu._lazy import numpy_backend
from vuke_tpu.cli import cli as jcli
from vuke_tpu.cores import md5 as jmd5, sha256 as jsha
from vuke_tpu.transforms import parse_transform as jparse
from vuke_tpu_torch import cli, encode, kernels
from vuke_tpu_torch.cores import digest, md5, p2pkh, sha256
from vuke_tpu_torch.transforms import parse_transform

STRING_TRANSFORMS = ["direct", "direct:str", "sha256", "double_sha256", "md5", "sha256_chain",
                     "sha256_chain:iterated", "sha256_chain:indexed", "sha256_chain:indexed:le",
                     "sha256_chain:counter"]
NO_STRING = ["direct:be", "direct:le", "milksad", "mt64", "lcg", "xorshift"]


def seeded_strings(n: int = 96, seed: int = 7) -> list:
    """Strings whose UTF-8 is 0 to 300 bytes: the empty one, the padding
    edges (55, 56, 63, 64, 119, 120 bytes, ASCII and with 2- and 3-byte
    characters), 32 and 33 bytes (direct's limit), then random ones."""
    rng = np.random.default_rng(seed)
    out = ["", "a", "correct horse battery staple", "é" * 16, "x" * 32 + "é", "€" * 11]
    for k in (32, 33, 55, 56, 63, 64, 119, 120):
        out += ["a" * k, "é" + "b" * (k - 2), "€" + "c" * (k - 3)]
    alphabet = list("abcdefghijklmnopqrstuvwxyz0123456789 ") + ["é", "€", "ß", "語"]
    while len(out) < n:
        k = int(rng.integers(1, 120))
        out.append("".join(alphabet[i] for i in rng.integers(0, len(alphabet), k)))
    return out


STRINGS = seeded_strings()


def test_the_strings_cover_the_edges():
    lens = {len(s.encode()) for s in STRINGS}
    assert {0, 32, 33, 55, 56, 63, 64, 119, 120} <= lens and max(lens) <= 300
    assert any(len(s.encode()) != len(s) for s in STRINGS)


@pytest.mark.parametrize("name,host_max", [(t, None) for t in STRING_TRANSFORMS]
                         + [(t, "8") for t in STRING_TRANSFORMS if t != "sha256_chain"])
def test_string_transform_matches_jax(name, host_max, monkeypatch):
    """Keys and validity equal the JAX package's, the port's hashlib path
    and its D1 path (plain version on the CPU) alike."""
    j = jparse(name).string
    want = np.asarray(j.fn(STRINGS))
    want_valid = j.valid_fn(STRINGS) if j.valid_fn is not None else None
    if host_max is not None:
        monkeypatch.setenv("VUKE_HOST_DIGEST_MAX", host_max)
    p = parse_transform(name).string
    got = p.fn(STRINGS, torch.device("cpu"))
    assert got.dtype == np.uint32 and got.shape == want.shape
    assert np.array_equal(got, want)
    assert tuple(p.slots) == tuple(j.slots) and p.name == j.name
    if want_valid is None:
        assert p.valid_fn is None
    else:
        assert np.array_equal(p.valid_fn(STRINGS), want_valid)


@pytest.mark.parametrize("name", NO_STRING)
def test_numeric_only_transforms_have_no_string_half(name):
    assert parse_transform(name).string is None and jparse(name).string is None


@pytest.mark.parametrize("mode", digest.MODES)
def test_plain_d1_matches_jax_blocks_and_hashlib(mode):
    """D1's plain version on the edge strings, against the JAX cores'
    blocks (run in numpy) and hashlib."""
    datas = [s.encode() for s in STRINGS[:30]]
    got = digest.digest(*digest.pack(datas), mode).to(torch.int64).numpy()
    core = jmd5 if mode == "md5" else jsha
    for i, d in enumerate(datas):
        with numpy_backend():
            blk = core.pad_message(d)[None]
            want = np.asarray(jmd5.md5_blocks(blk) if mode == "md5" else jsha.sha256_blocks(blk))
        if mode == "double_sha256":
            want = np.frombuffer(hashlib.sha256(want[0].astype(">u4").tobytes()).digest(),
                                 dtype=">u4")[None]
        assert np.array_equal(got[i], want[0]), (mode, len(d))
        host = {"md5": hashlib.md5(d).digest(), "sha256": hashlib.sha256(d).digest(),
                "double_sha256": hashlib.sha256(hashlib.sha256(d).digest()).digest()}[mode]
        assert got[i].astype("<u4" if mode == "md5" else ">u4").tobytes() == host


def test_plain_pad_message_and_blocks_match_jax():
    for s in STRINGS[:24]:
        d = s.encode()
        assert np.array_equal(sha256.pad_message(d), jsha.pad_message(d))
        assert np.array_equal(md5.pad_message(d), jmd5.pad_message(d))


def test_plain_d1_chain_and_layout():
    """The chain mode: row 0 the keys, row d SHA-256 of row d - 1; ``pack``
    round-trips and leaves 8 spare bytes."""
    datas = [s.encode() for s in STRINGS]
    words, offsets = digest.pack(datas)
    assert digest.unpack(words, offsets) == datas
    assert words.numel() * 4 >= offsets[-1].item() + 8
    keys = digest.digest(words, offsets, "sha256")
    chain = digest.digest_chain(keys, 4).to(torch.int64).numpy()
    for i, d in enumerate(datas):
        cur = hashlib.sha256(d).digest()
        for k in range(4):
            assert chain[k, i].astype(">u4").tobytes() == cur
            cur = hashlib.sha256(cur).digest()
    with pytest.raises(ValueError):
        digest.digest(words, offsets, "sha512")
    with pytest.raises(ValueError):
        digest.digest_chain(keys, 0)


@pytest.mark.parametrize("network", ["bitcoin", "testnet", "signet", "regtest"])
def test_plain_d2_matches_jax_p2pkh(network):
    """D2's plain rows against the JAX encoder on random and edge hash160s
    (all zeros: leading '1's; all 0xff)."""
    net = jencode.NETWORKS[network]
    rng = np.random.default_rng(5)
    h = rng.integers(0, 1 << 32, (5, 64), dtype=np.uint32)
    h[:, 0] = 0
    h[:, 1] = 0xFFFFFFFF
    h[:2, 2] = 0
    rows = p2pkh.batch_p2pkh(torch.from_numpy(h), net.p2pkh_version).numpy()
    assert rows.shape == (64, 35) and rows.dtype == np.uint8 and not rows[:, -1].any()
    for i, addr in enumerate(p2pkh.addresses(rows)):
        assert addr == jencode.p2pkh_address(h[:, i].astype("<u4").tobytes(), net)
        assert 26 <= len(addr) <= 34
    assert p2pkh.addresses(rows)[0].startswith("1111111111" if network == "bitcoin" else "m")


def _fields(net):
    return (net.name, net.p2pkh_version, net.wif_version, net.hrp)


@pytest.mark.parametrize("name", ["bitcoin", "testnet", "SIGNET", "regtest", "nope"])
def test_networks_match_jax(name, capsys):
    """``parse_network``: the same parameters, and for an unknown name the
    same warning and mainnet."""
    port = _fields(encode.parse_network(name))
    port_err = capsys.readouterr().err
    assert port == _fields(jencode.parse_network(name))
    assert port_err == capsys.readouterr().err
    assert {k: _fields(v) for k, v in encode.NETWORKS.items()} == {
        k: _fields(v) for k, v in jencode.NETWORKS.items()}


SINGLE = [
    ("correct horse battery staple", "sha256", None),
    ("correct horse battery staple", "double_sha256", None),
    ("hello wörld", "md5", None),
    ("short", "direct", None),
    ("x" * 33, "direct", None),
    ("seed phrase", "sha256_chain:iterated", None),
    ("seed phrase", "sha256_chain:indexed", None),
    ("seed phrase", "sha256_chain:indexed:le", None),
    ("seed phrase", "sha256_chain:counter", None),
    ("12345", "milksad", None),
    ("pass", "nope", None),
    ("correct horse battery staple", "sha256", "testnet"),
    ("correct horse battery staple", "sha256", "signet"),
    ("correct horse battery staple", "md5", "regtest"),
    ("abc", "sha256", "nonet"),
]


@pytest.mark.parametrize("passphrase,transform,network", SINGLE)
def test_single_matches_the_jax_command(passphrase, transform, network, capsys):
    """stdout and stderr of ``single`` equal the JAX command's (for a usage
    error: its last line and exit code); CUDA is never initialized and no
    kernel is built."""
    argv = ["single", passphrase, "--transform", transform]
    if network is not None:
        argv += ["--network", network]
    res = CliRunner().invoke(jcli, argv)
    kernels.library.cache_clear()
    code = 0
    try:
        code = cli.main(argv)
    except SystemExit as e:
        code = e.code
    out, err = capsys.readouterr()
    assert code == res.exit_code
    assert out == res.stdout
    if transform == "nope":
        assert err.splitlines()[-1] == res.stderr.splitlines()[-1]
        assert err.splitlines()[-1].startswith("Error: Unknown transform: nope.")
    else:
        assert err == res.stderr
    assert not torch.cuda.is_initialized()
    assert kernels.library.cache_info().currsize == 0
    if transform == "sha256" and network is None:
        assert "P2PKH (uncompressed): 1JwSSubhmg6iPtRjtyqhUYYH7bZg3Lfy1T\n" in out
    if transform in ("milksad",) or passphrase == "x" * 33:
        assert err == "No key generated from passphrase.\n" and out == ""


def test_d1_and_d2_operation_counts():
    """The bounds' counts (``kernels/work.py``): D1's grow by one
    compression a block, sha256d adds one from the IV, MD5 is cheaper; D2
    needs two SHA-256 compressions and the base58 divisions besides."""
    from vuke_tpu_torch.kernels import work

    one, two = work.digest("sha256", 1), work.digest("sha256", 2)
    per_block = work.Trace()
    work.sha256_block(per_block, [None] * 8, [None] * 16)
    assert two.alu - one.alu == per_block.ops.alu and two.add - one.add == per_block.ops.add
    assert work.digest("double_sha256", 1).alu > one.alu > work.digest("md5", 1).alu > 0
    assert work.digest_chain(1).cycles() == 0
    assert work.digest_chain(10).alu == 9 * (work.digest_chain(2).alu)
    assert work.p2pkh().mul > 0 and work.p2pkh().alu > 2 * one.alu * 0.9
