"""vuke_tpu_torch's wallet code against the JAX package's on the CPU: bip39,
bip32, armory, bitimage, electrum and multibit on the same inputs and the
published vectors (the official Electrum seed and master public key, the
MultiBit bug vector's mnemonic, BIP39's all-zero entropy, BIP32 vector 1);
the four transform specs' keys, validity, slots and labels on the same
strings and blobs, armory's host-only numeric path on seeds across 2^32;
the wordlist copy; the registry's names and error texts.

The JAX package's ``ref.point_mul`` (an affine double-and-add) is swapped
for the port's Jacobian one in this file's JAX calls: the same integers
(``tests/test_torch_host.py``), in milliseconds rather than ~70 ms a key.
Every comparison is exact.
"""

import hashlib

import numpy as np
import pytest
import torch

import vuke_tpu.ecc.ref as jref
import vuke_tpu.transforms.registry as jregistry
from vuke_tpu.transforms import wallets as jwallets
from vuke_tpu.wallets import armory as jarmory, bip32 as jbip32, bip39 as jbip39
from vuke_tpu.wallets import bitimage as jbitimage, electrum as jelectrum
from vuke_tpu.wallets import multibit as jmultibit
from vuke_tpu_torch import encode
from vuke_tpu_torch.analyze.multibit import _truncate_mnemonic
from vuke_tpu_torch.ecc import ref
from vuke_tpu_torch.transforms import parse_transform, wallets
from vuke_tpu_torch.wallets import armory, bip32, bip39, bitimage, electrum, multibit

ELECTRUM_SEED = "acb740e454c3134901d7c8f16497cc1c"
ELECTRUM_MPK = ("e9d4b7866dd1e91c862aebf62a49548c7dbf7bcc6e4b7b8c9da820c7737968df"
                "9c09d5a3e271dc814a29981f81b3faaf2737b551ef5dcc6189cf0f8252c442b3")
MNEMONIC_445 = ("skin join dog sponsor camera puppy ritual diagram arrow poverty boy "
                "elbow")
RNG = np.random.default_rng(11)


@pytest.fixture(autouse=True)
def fast_jax_ec(monkeypatch):
    monkeypatch.setattr(jref, "point_mul", ref.point_mul)


def _uncompressed_p2pkh(key: bytes) -> str:
    return encode.p2pkh_address(encode.hash160(ref.pubkey_uncompressed(
        int.from_bytes(key, "big"))))


def test_wordlist_is_a_byte_copy():
    import vuke_tpu_torch
    from pathlib import Path
    port = Path(vuke_tpu_torch.__file__).parent / "data" / "bip39_english.txt"
    assert port.read_bytes() == Path(jbip39._WORDLIST_PATH).read_bytes()
    assert bip39.wordlist() == jbip39.wordlist()


@pytest.mark.parametrize("n", [0, 1, 4, 16, 20, 32, 33, 64])
def test_bip39_entropy_to_mnemonic_matches_jax(n):
    entropy = bytes(RNG.bytes(n))
    assert bip39.entropy_to_mnemonic(entropy) == jbip39.entropy_to_mnemonic(entropy)


def test_bip39_vectors_and_validation():
    words = bip39.entropy_to_mnemonic(bytes(16))
    assert " ".join(words) == " ".join(["abandon"] * 11 + ["about"])
    assert bip39.mnemonic_to_seed(" ".join(words), "TREZOR").hex().startswith(
        "c55257c360c07c72029aebc1b53c05ed")
    assert len(bip39.entropy_to_mnemonic(bytes(64))) == 48
    for bad in ("abandon abandon abandon", " ".join(["abandon"] * 11 + ["notaword"])):
        with pytest.raises(bip39.MnemonicError) as got:
            bip39.validate_mnemonic(bad)
        with pytest.raises(jbip39.MnemonicError) as want:
            jbip39.validate_mnemonic(bad)
        assert str(got.value) == str(want.value)


def test_bip32_vector1_and_paths_match_jax():
    seed = bytes.fromhex("000102030405060708090a0b0c0d0e0f")
    master, chain = bip32.seed_to_master_key(seed)
    assert master.hex() == "e8f32e723decf4051aefac8e2c93c9c5b214313817cdb01a1494b917c8436b35"
    assert bip32.derive_path(master, chain, "m/0'/1").hex() == (
        "3c6cb8d0f6a264c91ea8b5030fadaa8e538b020f0a387421a12de9319dc93368")
    for path in ("m", "m/0'", "m/84'/0'/0'/0/0", "m/44h/0h/1/2/3", "m/7//8"):
        assert bip32.derive_path(master, chain, path) == jbip32.derive_path(master, chain, path)
        assert bip32.parse_derivation_path(path) == jbip32.parse_derivation_path(path)
    for bad in ("x/1", "m/2147483648", "m/abc", "m/-1"):
        with pytest.raises(bip32.Bip32Error) as got:
            bip32.parse_derivation_path(bad)
        with pytest.raises(jbip32.Bip32Error) as want:
            jbip32.parse_derivation_path(bad)
        assert str(got.value) == str(want.value)
    kids = bip32.derive_normal_children(master, chain, 3)
    assert kids == [jbip32.derive_normal_child(master, chain, i)[0] for i in range(3)]


def test_armory_matches_jax():
    roots = [hashlib.sha256(b"x").digest(), (5).to_bytes(32, "big"), b"short root",
             bytes(32), ref.N.to_bytes(32, "big")]
    assert [armory.armory_key(r) for r in roots] == [jarmory.armory_key(r) for r in roots]
    assert armory.armory_key(bytes(32)) is None


def test_bitimage_matches_jax():
    data = bytes(RNG.bytes(300))
    for pp in ("", "pw"):
        d, jd = bitimage.BitimageDeriver(data, pp), jbitimage.BitimageDeriver(data, pp)
        assert (d.master_key, d.chain_code) == (jd.master_key, jd.chain_code)
        assert d.derive_path("m/84'/0'/0'/0/1") == jd.derive_path("m/84'/0'/0'/0/1")
    for path in ("m/84'/0'/0'/0/0", "m/1h", "m", "m/x", "m/5'"):
        assert bitimage.increment_path_index(path) == jbitimage.increment_path_index(path)


def test_electrum_vectors_and_helpers():
    d = electrum.ElectrumDeriver.from_hex_seed(ELECTRUM_SEED)
    assert d.master_pubkey_hex() == ELECTRUM_MPK
    assert _uncompressed_p2pkh(d.derive_key(0)) == "1FJEEB8ihPMbzs2SkLmr37dHyRFzakqUmo"
    change = electrum.ElectrumDeriver.from_hex_seed(ELECTRUM_SEED, for_change=True)
    assert _uncompressed_p2pkh(change.derive_key(0)) == "1KRW8pH6HFHZh889VDq6fEKvmrsmApwNfe"
    jd = jelectrum.ElectrumDeriver(electrum.stretch_key(ELECTRUM_SEED.encode()))
    assert d.derive_keys(5) == jd.derive_keys(5)
    for s in ("abcd1234", "a" * 40, "0123456789abcdefghij", "0123456789abcdefghijk"):
        assert electrum.truncate_seed(s) == jelectrum.truncate_seed(s)
    assert electrum.get_sequence(bytes(64), 1, 7) == jelectrum.get_sequence(bytes(64), 1, 7)
    for bad in ("not_valid_hex!", ""):
        with pytest.raises(electrum.ElectrumError, match="Seed must be valid hex"):
            electrum.ElectrumDeriver.from_hex_seed(bad)
    with pytest.raises(electrum.ElectrumError, match="Invalid stretched key"):
        electrum.ElectrumDeriver(bytes(32))


def test_multibit_vector_and_batch_match_jax():
    """The MultiBit bug vector; ``multibit_hd_keys_batch`` on the CPU (hashlib)
    against the JAX batch and the single-mnemonic path, invalid entries
    dropped; the truncations."""
    keys = multibit.multibit_hd_keys(MNEMONIC_445, "", 3)
    pub = ref.pubkey_compressed(int.from_bytes(keys[0], "big"))
    assert encode.p2pkh_address(encode.hash160(pub)) == "1LQ8XnNKqC7Vu7atH5k4X8qVCc9ug2q7WE"
    assert keys == jmultibit.multibit_hd_keys(MNEMONIC_445, "", 3)
    d = multibit.MultibitBugDeriver(MNEMONIC_445, "pp")
    assert [d.derive_key(i) for i in range(2)] == d.derive_keys(2)
    ms = [MNEMONIC_445, " ".join(["abandon"] * 11 + ["about"]), "not valid at all"]
    got = multibit.multibit_hd_keys_batch(ms, "pp", 2)
    assert got == [(m, list(k)) for m, k in jmultibit.multibit_hd_keys_batch(ms, "pp", 2)]
    assert [m for m, _ in got] == ms[:2]
    with pytest.raises(ValueError, match="Invalid word count: 4"):
        multibit.multibit_hd_keys("a b c d", "", 1)
    for m in (MNEMONIC_445, "a b c d", "a b c d e"):
        assert multibit.truncate_mnemonic(m) == jmultibit.truncate_mnemonic(m)
    from vuke_tpu.analyze.multibit import _truncate_mnemonic as jtrunc
    for m in (MNEMONIC_445, "a b c d e f", "a b c d e f g"):
        assert _truncate_mnemonic(m) == jtrunc(m)


STRINGS = ["1400000000", ELECTRUM_SEED, "not hex", "", "abc", MNEMONIC_445,
           " ".join(["abandon"] * 11 + ["about"]), "abandon abandon"]


def _spec_parity(port, jax, strings):
    """Keys, validity, slots, names and labels of a string spec."""
    assert (port.name, list(port.string.slots)) == (jax.name, list(jax.string.slots))
    got = port.string.fn(strings)
    valid = port.string.valid_fn(strings)
    want = jax.string.fn(strings)
    assert np.array_equal(valid, jax.string.valid_fn(strings))
    assert np.array_equal(got[valid], np.asarray(want)[valid])
    jlabel = getattr(jax.string, "label_fn", None) or (lambda s: s)
    assert [port.string.label(s) for s in strings] == [jlabel(s) for s in strings]
    return got, valid


@pytest.mark.parametrize("name", ["electrum", "electrum:change", "multibit", "armory"])
def test_string_specs_match_jax(name):
    strings = STRINGS[:5] if name.startswith("electrum") else STRINGS
    port = parse_transform(name)
    jregistry.parse_transform.cache_clear()
    _, valid = _spec_parity(port, jregistry.parse_transform(name), strings)
    jregistry.parse_transform.cache_clear()
    assert valid.any()


def test_bitimage_spec_and_blobs_match_jax(tmp_path):
    pp = tmp_path / "pp.txt"
    pp.write_text("one\n\ntwo\n")
    kw = dict(path="m/44'/0'/0'/0/7", passphrase_wordlist=str(pp), derive_count=3)
    port, jax = wallets.bitimage_spec(**kw), jwallets.bitimage_spec(**kw)
    _spec_parity(port, jax, ["some bytes", ""])
    blobs = [(bytes(RNG.bytes(50)), "a"), (b"", "b")]
    got = port.string.blob_fn(blobs)
    want = jax.string.blob_fn(blobs)
    assert np.array_equal(got, want) and np.array_equal(port.string.valid_fn([]),
                                                        jax.string.blob_fn.last_valid)
    assert port.string.slots[0] == ":one[m/44'/0'/0'/0/7]" and len(port.string.slots) == 6
    assert parse_transform("Bitimage:x").string.slots == ("[m/84'/0'/0'/0/0]",)


def test_armory_numeric_path_matches_jax():
    """The host-only numeric path on seeds across 2^32 and near 2^64: the
    keys of SHA256(str(v)) and of v as 32 BE bytes, the first ``limit``
    lanes only; the plain keygen (the host confirm) gives the same."""
    spec = parse_transform("armory")
    nt = spec.numeric
    assert nt.host_only and nt.slots == ("", "")
    seeds = [0, 1, (1 << 32) - 1, 1 << 32, (1 << 64) - 1]
    hi = torch.tensor([s >> 32 for s in seeds]).to(torch.uint32)
    lo = torch.tensor([s & 0xFFFFFFFF for s in seeds]).to(torch.uint32)
    keys, valid = nt.keygen(hi, lo, limit=4)
    jkeys, jvalid = jwallets.armory_spec().numeric.fn(
        np.array([s >> 32 for s in seeds], dtype=np.uint32),
        np.array([s & 0xFFFFFFFF for s in seeds], dtype=np.uint32))
    jkeys, jvalid = np.asarray(jkeys), np.asarray(jvalid)
    k = keys.view(torch.int32).numpy().view(np.uint32).transpose(2, 0, 1)
    assert np.array_equal(valid.numpy().T[:4], jvalid[:4]) and not valid[:, 4].any()
    assert np.array_equal(k[:4][valid.numpy().T[:4]], jkeys[:4][jvalid[:4]])
    k1, v1 = nt.keygen(hi[2:3], lo[2:3], plain=True)
    assert torch.equal(k1[:, :, 0], keys[:, :, 2]) and torch.equal(v1[:, 0], valid[:, 2])


@pytest.mark.parametrize("name", ["armory", "multibit", "electrum", "electrum:change",
                                  "bitimage", "BITIMAGE:m/1"])
def test_registry_names_match_jax(name):
    port = parse_transform(name)
    jregistry.parse_transform.cache_clear()
    jax = jregistry.parse_transform(name)
    jregistry.parse_transform.cache_clear()
    assert port.name == jax.name
    assert (port.numeric is None) == (jax.numeric is None)
    assert port.string.slots == tuple(jax.string.slots)
    assert parse_transform(name) is port
