"""The plain reference against published vectors, and against the port's
own plain versions at a few inputs (two implementations that share no
code)."""

import hashlib
import json

import pytest

from portbench.harness import ROOT, load_json, load_module
from portbench.reference import address, mt, secp256k1


def test_mt19937_standard_vectors():
    # C++11 [rand.predef]: the 10000th output of mt19937 seeded 5489
    g = mt.mt19937(5489)
    out = [next(g) for _ in range(10000)]
    assert out[0] == 3499211612
    assert out[-1] == 4123659995


def test_mt19937_64_standard_vector():
    # C++11 [rand.predef]: the 10000th output of mt19937_64 seeded 5489
    g = mt.mt19937_64(5489)
    out = [next(g) for _ in range(10000)]
    assert out[-1] == 9981545732273789042


def test_ripemd160_vectors():
    # the RIPEMD-160 paper's test vectors
    assert address.ripemd160(b"").hex() == "9c1185a5c5e9fc54612808977ee8f548b2258d31"
    assert address.ripemd160(b"abc").hex() == "8eb208f7e05d987a9b044a8e98c6b087f15a0bfc"
    assert (address.ripemd160(b"a" * 1000).hex()
            == hashlib.new("ripemd160", b"a" * 1000).hexdigest()
            if "ripemd160" in hashlib.algorithms_available else True)


def test_generator_point_addresses():
    key = (1).to_bytes(32, "big")
    a = address.addresses(key)
    assert a["p2pkh_compressed"][0] == "1BgGZ9tcN4rm9KBzDn7KprQz87SZ26SAMH"
    assert a["p2pkh_uncompressed"][0] == "1EHNa6Q4Jz2uvNExL497mE43ikXhwF6kZm"
    # BIP 173's example is the compressed generator point's hash160
    assert a["p2wpkh"][0] == "bc1qw508d6qejxtdg4y5r3zarvary0c5xw7kv8f3t4"


def test_brainwallet_vector():
    key = hashlib.sha256(b"correct horse battery staple").digest()
    assert address.addresses(key)["p2pkh_uncompressed"][0] == "1JwSSubhmg6iPtRjtyqhUYYH7bZg3Lfy1T"


@pytest.mark.parametrize("key,addr", [(0x15, "1E6NuFjCi27W5zoXg8TRdcSRq84zJeBW3k"),
                                      (0x202, "1LeBZP5QCwwgXRtmVUvTVrraqPUokyLHqe"),
                                      (0xD2C55, "1HsMJxNiV7TLxmoF6uJNkydxPFDog4NQum")])
def test_b1000_puzzle_keys(key, addr):
    """Puzzles 5, 10 and 20 of the bitcoin puzzle transaction."""
    assert address.addresses(key.to_bytes(32, "big"))["p2pkh_compressed"][0] == addr


def test_key_normalization():
    assert secp256k1.normalize_key(bytes(32)) == 1
    assert secp256k1.normalize_key(secp256k1.N.to_bytes(32, "big")) == 1
    assert secp256k1.normalize_key((secp256k1.N + 5).to_bytes(32, "big")) == 5


def test_milksad_keys_and_addresses_against_the_port():
    import torch
    from vuke_tpu_torch.cores.mt19937 import milksad_key_words_plain
    from vuke_tpu_torch.derive import KeyDeriver

    seeds = [0, 1, 5489, 0x7FFFFFFF, 0xFFFFFFFF]
    words = milksad_key_words_plain(torch.tensor(seeds, dtype=torch.int64).to(torch.uint32))
    for i, s in enumerate(seeds):
        key = b"".join((int(w) & 0xFFFFFFFF).to_bytes(4, "big") for w in words[:, i])
        assert mt.milksad_key(s) == key
    d = KeyDeriver().derive(mt.milksad_key(1))
    a = address.addresses(mt.milksad_key(1))
    assert (a["p2pkh_compressed"][0], a["p2pkh_uncompressed"][0], a["p2wpkh"][0]) == (
        d.p2pkh_compressed, d.p2pkh_uncompressed, d.p2wpkh)


def test_numeric_sha256_keys_against_the_port():
    import torch
    from vuke_tpu_torch.cores.keygen import keygen_hash_plain

    ref = load_module(ROOT / "portbench/configs/brainwallet_numeric.py", "bn_ref")
    seeds = [1000000000, 4294967296, 9999999999]
    hi = torch.tensor([s >> 32 for s in seeds]).to(torch.uint32)
    lo = torch.tensor([s & 0xFFFFFFFF for s in seeds]).to(torch.uint32)
    keys = keygen_hash_plain(hi, lo, "sha256")
    for i, s in enumerate(seeds):
        for slot in range(3):
            got = b"".join((int(w) & 0xFFFFFFFF).to_bytes(4, "big") for w in keys[slot, :, i])
            assert ref.keys(s)[slot] == got


def test_mt64_keys_and_cascade_against_the_port():
    import torch
    from vuke_tpu_torch import provider
    from vuke_tpu_torch.cores.mt19937 import mt64_key_words_plain

    seeds = [0, 5489, (1 << 64) - 1, 0x123456789ABCDEF0]
    hi = torch.tensor([s >> 32 for s in seeds], dtype=torch.int64)
    lo = torch.tensor([s & 0xFFFFFFFF for s in seeds], dtype=torch.int64)
    keys = mt64_key_words_plain(hi, lo, 2)
    for i, s in enumerate(seeds):
        for j in range(2):
            got = b"".join((int(keys[8 * j + w][i]) & 0xFFFFFFFF).to_bytes(4, "big")
                           for w in range(8))
            assert mt.mt64_keys(s, 2)[j] == got
    ref = load_module(ROOT / "portbench/configs/b1000_mt64.py", "b1000_ref")
    cfg = load_json(ROOT / "portbench/configs/b1000_mt64.json")
    assert ref.puzzle_cascade(cfg) == [tuple(t) for t in provider.build_cascade("b1000", 67)]
    c = ref.cascade_of(5489, [62, 63])
    assert ref.matches(5489, c) and not ref.matches(5490, c)


def test_puzzle_keys_match_the_puzzle_data():
    data = json.loads((ROOT / "vuke_tpu_torch/data/puzzles.json").read_text())["b1000"]
    by_id = {p["id"]: p for p in data}
    cfg = load_json(ROOT / "portbench/configs/b1000_mt64.json")
    for bits, key in cfg["cascade"]:
        assert int(by_id[bits]["key_hex"], 16) == int(key, 16)
        a = address.addresses(int(key, 16).to_bytes(32, "big"))
        assert a["p2pkh_compressed"][0] == by_id[bits]["address"]
