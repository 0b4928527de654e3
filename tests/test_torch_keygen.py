"""vuke_tpu_torch's numeric transforms: the plain keygens against the JAX
package's ``numeric.fn`` for every transform string its registry accepts,
lane for lane (tolerance 0: the keygens compute integers), with the JAX
side run eagerly in numpy (``vuke_tpu._lazy.numpy_backend``: no jit, no XLA
compile); a few lanes of each family against hashlib and
``tests/oracles.py``; ``parse_transform``'s specs and error texts against
the JAX registry; the constant tables against the JAX modules'; and the
operation counts of ``kernels/work.py`` run on known words."""

import hashlib

import numpy as np
import pytest
import torch

import chip_smoke
import oracles
from vuke_tpu._lazy import numpy_backend
from vuke_tpu.cores import lcg as jlcg, md5 as jmd5, sha256 as jsha, sha256_chain as jchain
from vuke_tpu.cores import xorshift as jxs
from vuke_tpu.transforms import parse_transform as jparse
from vuke_tpu.transforms import registry as jregistry
from vuke_tpu_torch.cores import hash160, keygen, lcg, md5, sha256_chain, xorshift
from vuke_tpu_torch.kernels import work
from vuke_tpu_torch.transforms import parse_transform
from vuke_tpu_torch.transforms import registry

LANES = 256
# decimal strings of 1 to 20 bytes, the u32 and the LCG caps' edges
EDGE = [0, 9, 10, 99, 100, (1 << 31) - 2, (1 << 31) - 1, 1 << 31, (1 << 32) - 1, 1 << 32,
        10 ** 9, 10 ** 10 - 1, 10 ** 19 - 1, 10 ** 19, (1 << 64) - 1]

NUMERIC = (["direct", "direct:be", "direct:le", "direct:str", "sha256", "double_sha256", "md5",
            "milksad", "mt64", "lcg", "lcg:le"]
           + [f"lcg:{v.name}" for v in lcg.ALL_VARIANTS]
           + [f"lcg:{v.name}:le" for v in lcg.ALL_VARIANTS]
           + ["xorshift", "xorshift:64", "xorshift:128", "xorshift:128plus", "xorshift:xoroshiro"]
           + ["sha256_chain", "sha256_chain:iterated", "sha256_chain:indexed",
              "sha256_chain:indexed:le", "sha256_chain:counter"])
ALIASES = (["DIRECT", "Sha256", "lcg:be", "lcg:big", "lcg:little", "lcg:glibc:big",
            "lcg:msvc:little", "lcg:", "sha256_chain:indexed:be", "sha256_chain:indexed:big",
            "sha256_chain:indexed:little", "sha256_chain:"]
           + [f"xorshift:{a}" for a in registry._XS_ALIASES])
BAD = ["nope", "lcg:foo", "lcg:glibc:xx", "lcg:foo:be", "lcg:a:b:c", "xorshift:99",
       "xorshift:64:be", "sha256_chain:foo", "sha256_chain:indexed:xx",
       "sha256_chain:counter:be", "direct:xx", "sha256:1"]
NOT_PORTED = ["armory", "multibit", "electrum", "electrum:change", "bitimage", "Bitimage:x"]


def _seeds():
    rng = np.random.default_rng(6)
    rand = rng.integers(0, 1 << 64, LANES - len(EDGE), dtype=np.uint64)
    rand[::2] &= np.uint64(0xFFFFFFFF)
    return np.concatenate([np.array(EDGE, dtype=np.uint64), rand])


SEEDS = _seeds()
HI = (SEEDS >> np.uint64(32)).astype(np.uint32)
LO = (SEEDS & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _t(a):
    return torch.from_numpy(a.astype(np.int64)).to(torch.uint32)


def _key(keys, slot, lane) -> bytes:
    return b"".join(int(w).to_bytes(4, "big") for w in keys[slot, :, lane].to(torch.int64))


@pytest.fixture(scope="module")
def port_keys():
    """{transform: (keys (S, 8, N), valid (S, N))} of the plain keygens on SEEDS."""
    return {}


def _port(cache, name):
    if name not in cache:
        cache[name] = parse_transform(name).numeric.keygen(_t(HI), _t(LO), plain=True)
    return cache[name]


@pytest.mark.parametrize("name", NUMERIC)
def test_plain_keygen_matches_jax(name, port_keys):
    """Keys and validity, transposed to the JAX package's (N, S, 8)."""
    keys, valid = _port(port_keys, name)
    with numpy_backend():
        jkeys, jvalid = jparse(name).numeric.fn(HI, LO)
    assert keys.dtype == torch.uint32 and valid.dtype == torch.bool
    assert np.array_equal(keys.to(torch.int64).permute(2, 0, 1).numpy(), np.asarray(jkeys))
    assert np.array_equal(valid.T.numpy(), np.asarray(jvalid))


@pytest.mark.parametrize("name", NUMERIC + ALIASES)
def test_parse_transform_matches_jax(name):
    spec, jspec = parse_transform(name), jparse(name)
    assert spec.name == jspec.name
    assert spec.numeric.name == jspec.numeric.name
    assert list(spec.numeric.slots) == list(jspec.numeric.slots)
    assert spec.numeric.sequential_slot == jspec.numeric.sequential_slot
    assert parse_transform(name) is spec


@pytest.mark.parametrize("name", BAD)
def test_parse_transform_errors_match_jax(name):
    with pytest.raises(ValueError) as want:
        jparse(name)
    with pytest.raises(ValueError) as got:
        parse_transform(name)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", NOT_PORTED)
def test_wallet_transforms_are_not_ported(name):
    """The wallet names, which the port once refused as not ported: now
    the JAX registry's spec, its name, paths and slots
    (``tests/test_torch_wallets.py`` holds their keys)."""
    spec = parse_transform(name)
    want = jparse(name)
    assert (spec.name, spec.numeric is None, spec.string.slots) == (
        want.name, want.numeric is None, tuple(want.string.slots))


def test_constant_tables_match_jax():
    assert [(v.name, v.a, v.c, v.m, v.max_seed) for v in lcg.ALL_VARIANTS] == [
        (v.name, v.a, v.c, v.m, v.max_seed) for v in jlcg.ALL_VARIANTS]
    assert xorshift.VARIANT_NAMES == jxs.VARIANT_NAMES
    assert sha256_chain.VARIANTS == jchain.VARIANTS
    assert sha256_chain.DEFAULT_CHAIN_DEPTH == jchain.DEFAULT_CHAIN_DEPTH
    assert list(hash160.SHA_K) == jsha._K.tolist() and list(hash160.SHA_IV) == jsha.IV.tolist()
    assert list(md5.K) == jmd5._K.tolist() and list(md5.S) == list(jmd5._S)
    assert list(md5.IV) == jmd5._IV.tolist()
    assert registry._XS_ALIASES == jregistry._XS_ALIASES
    assert registry._CHAIN_NAMES == jregistry._CHAIN_NAMES


# --- the edges, against hashlib and tests/oracles.py ---

def _lanes():
    return list(range(len(EDGE))) + [40, 77, 130, 255]


def test_decimal_strings_of_every_length(port_keys):
    """The direct:str key: the decimal string of 0, 9, 10, 2^32 - 1, 2^32,
    10^19, 2^64 - 1 (1 to 20 bytes) and more, zero-padded."""
    keys, _ = _port(port_keys, "direct")
    lengths = set()
    for j in _lanes():
        text = str(int(SEEDS[j])).encode()
        lengths.add(len(text))
        assert _key(keys, 2, j) == text.ljust(32, b"\0")
    assert {1, 2, 10, 19, 20} <= lengths


def test_hash_modes_against_hashlib(port_keys):
    """sha256: the string, the 8 BE bytes, the 8 LE bytes ([byteswap(lo),
    byteswap(hi)]); double_sha256 hashes each 32-byte digest; md5's key is
    the digest twice (its LE words byteswapped)."""
    sha = _port(port_keys, "sha256")
    dbl = _port(port_keys, "double_sha256")
    m5 = _port(port_keys, "md5")
    direct = _port(port_keys, "direct")
    for j in _lanes():
        seed = int(SEEDS[j])
        msgs = [str(seed).encode(), seed.to_bytes(8, "big"), seed.to_bytes(8, "little")]
        for s, msg in enumerate(msgs):
            digest = hashlib.sha256(msg).digest()
            assert _key(sha[0], s, j) == digest
            assert _key(dbl[0], s, j) == hashlib.sha256(digest).digest()
        d = hashlib.md5(msgs[0]).digest()
        assert _key(m5[0], 0, j) == d + d
        assert _key(direct[0], 0, j) == seed.to_bytes(32, "big")
        assert _key(direct[0], 1, j) == seed.to_bytes(8, "little") + bytes(24)


def test_lcg_against_the_oracle(port_keys):
    """8 outputs from the raw u32 seed through the first step, BE and LE;
    a seed is valid where hi == 0 and lo <= min(m - 1, 2^32 - 1); minstd
    keeps 0 canonical (2^31 - 1 steps to 0); labels '', ':name', ':name:le'."""
    be, valid = _port(port_keys, "lcg")
    le, _ = _port(port_keys, "lcg:le")
    for j in _lanes():
        seed = int(SEEDS[j])
        for s, v in enumerate(lcg.ALL_VARIANTS):
            for keys, big in ((be, True), (le, False)):
                assert _key(keys, s, j) == oracles.lcg_key(seed & 0xFFFFFFFF, v.a, v.c, v.m, big)
            assert bool(valid[s, j]) == (seed < 1 << 32 and seed <= min(v.m - 1, 0xFFFFFFFF))
    j = EDGE.index((1 << 31) - 1)
    assert _key(be, 1, j)[:4] == bytes(4)
    assert parse_transform("lcg").numeric.slots == (":glibc", ":minstd", ":msvc", ":borland")
    assert parse_transform("lcg:le").numeric.slots == (
        ":glibc:le", ":minstd:le", ":msvc:le", ":borland:le")
    assert parse_transform("lcg:msvc:le").numeric.slots == ("",)


def test_xorshift_and_mt64_against_the_oracles(port_keys):
    """A zero seed becomes 1; the 128-bit variants are seeded by splitmix64;
    u64 outputs high word first; MT19937-64's outputs serialized LE."""
    xs, _ = _port(port_keys, "xorshift")
    mt, _ = _port(port_keys, "mt64")
    fns = [oracles.xorshift64_key, oracles.xorshift128_key, oracles.xorshift128plus_key,
           oracles.xoroshiro128starstar_key]
    for j in _lanes():
        seed = int(SEEDS[j])
        for s, fn in enumerate(fns):
            assert _key(xs, s, j) == fn(seed)
        assert _key(mt, 0, j) == oracles.MT19937_64(seed).fill_bytes(32)
    assert _key(xs, 0, 0) == oracles.xorshift64_key(1)


def test_chains_against_hashlib(port_keys):
    """The decimal-string half (every seed) then the 4-byte half (valid
    where hi == 0), the counter and index bytes appended at the string's
    per-lane length; labels '[variant:d]' the same in both halves."""
    keys, valid = _port(port_keys, "sha256_chain")
    depth = sha256_chain.DEFAULT_CHAIN_DEPTH
    for j in _lanes():
        seed = int(SEEDS[j])
        for half, msg in enumerate((str(seed).encode(), (seed & 0xFFFFFFFF).to_bytes(4, "big"))):
            for k, v in enumerate(sha256_chain.VARIANTS):
                for d in range(depth):
                    slot = (half * 4 + k) * depth + d
                    assert _key(keys, slot, j) == chip_smoke.host_chain_key(msg, v, d)
                    assert bool(valid[slot, j]) == (half == 0 or seed < 1 << 32)
    slots = parse_transform("sha256_chain").numeric.slots
    assert slots[:2] == ("[iterated:0]", "[iterated:1]") and slots[40:] == slots[:40]


def test_keygen_wrappers_take_the_plain_version_on_the_cpu():
    hi, lo = _t(HI[:32]), _t(LO[:32])
    assert torch.equal(keygen.keygen_hash(hi, lo, "md5"), keygen.keygen_hash_plain(hi, lo, "md5"))
    assert torch.equal(keygen.keygen_prng(hi, lo, "xorshift", 2),
                       keygen.keygen_prng_plain(hi, lo, "xorshift", 2))
    assert keygen.keygen_chain(hi, lo, 1, 3).shape == (6, 8, 32)
    with pytest.raises(ValueError):
        keygen.keygen_hash(hi.to(torch.int64), lo, "md5")
    with pytest.raises(ValueError):
        keygen.keygen_prng(hi, lo, "lcg", 4)


# --- the operation counts of kernels/work.py, run on known words ---

@pytest.mark.parametrize("seed", [0, 1, 0x12345678_9ABCDEF0, (1 << 64) - 1])
def test_counted_generators_are_the_generators(seed):
    hi, lo = torch.tensor([seed >> 32]), torch.tensor([seed & 0xFFFFFFFF])
    for name in xorshift.VARIANT_NAMES:
        assert work.xorshift_lane(work.Trace(), name, seed >> 32, seed & 0xFFFFFFFF) == [
            int(w[0]) for w in xorshift.KEY_FNS[name](hi, lo)]
    want = oracles.MT19937_64(seed).fill_bytes(32)
    got = work.mt64_lane(work.Trace(), seed >> 32, seed & 0xFFFFFFFF)
    assert b"".join(w.to_bytes(4, "big") for w in got) == want
    for v in lcg.ALL_VARIANTS:
        got = work.lcg_lane(work.Trace(), seed & 0xFFFFFFFF, v, False)
        assert b"".join(w.to_bytes(4, "big") for w in got) == oracles.lcg_key(
            seed & 0xFFFFFFFF, v.a, v.c, v.m, False)


def test_counted_md5_is_md5():
    msg = b"12345"
    block = list(np.frombuffer(jmd5.pad_message(msg).tobytes(), dtype="<u4").astype(int))
    got = work.md5_block(work.Trace(), list(md5.IV), [int(x) for x in block])
    assert b"".join(w.to_bytes(4, "little") for w in got) == hashlib.md5(msg).digest()


def test_keygen_counts():
    """The sha256 mode: three compressions of ~960 ALU operations; twice as
    many for double_sha256; one chain compression a slot; no keygen is
    free of work."""
    sha = work.keygen_hash("sha256", 10)
    assert 2_800 < sha.alu < 3_000 and sha.pipe() == "ALU"
    assert work.keygen_hash("double_sha256", 10).alu > 1.9 * sha.alu
    assert 78 * 940 < work.keygen_chain(10).alu < 80 * 1_000
    for ops in (work.keygen_hash("direct", 1), work.keygen_hash("md5", 1),
                work.keygen_prng("lcg"), work.keygen_prng("xorshift"), work.keygen_prng("mt64")):
        assert ops.cycles() > 0
    assert work.keygen_prng("mt64").mul > 159 * 3
