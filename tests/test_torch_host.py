"""vuke_tpu_torch's own host helpers (``ecc/ref.py``, ``encode.py``,
``derive.py``) against the JAX package's, on fixed vectors."""

import dataclasses
import hashlib

import pytest

from vuke_tpu import derive as jderive
from vuke_tpu import encode as jencode
from vuke_tpu.ecc import ref as jref
from vuke_tpu_torch import derive, encode
from vuke_tpu_torch.ecc import ref

N = jref.N
KEYS = [0, 1, N - 1, N, N + 1, (1 << 256) - 1,
        int.from_bytes(hashlib.sha256(b"correct horse battery staple").digest(), "big")]


def test_curve_constants_match():
    assert (ref.P, ref.N, ref.GX, ref.GY) == (jref.P, jref.N, jref.GX, jref.GY)


@pytest.mark.parametrize("k", [1, 2, 3, 1026, (1 << 64) - 2, N - 1, N + 5] + KEYS[-1:])
def test_point_mul_and_pubkeys_match(k):
    assert ref.point_mul(k) == jref.point_mul(k)
    assert ref.pubkey_compressed(k) == jref.pubkey_compressed(k)
    assert ref.pubkey_uncompressed(k) == jref.pubkey_uncompressed(k)


def test_point_add_edges_match():
    g, g2 = jref.point_mul(1), jref.point_mul(2)
    neg_g = (g[0], jref.P - g[1])
    for a, b in [(g, g), (g, g2), (None, g), (g, None), (g, neg_g)]:
        assert ref.point_add(a, b) == jref.point_add(a, b)


@pytest.mark.parametrize("k", KEYS)
def test_key_deriver_matches_every_field(k):
    key = k.to_bytes(32, "big")
    got = dataclasses.asdict(derive.KeyDeriver().derive(key))
    want = dataclasses.asdict(jderive.KeyDeriver().derive(key))
    assert got == want
    assert derive.normalize_key(key) == jderive.normalize_key(key)


def test_the_golden_vector():
    d = derive.KeyDeriver().derive(KEYS[-1].to_bytes(32, "big"))
    assert d.wif_uncompressed == "5KJvsngHeMpm884wtkJNzQGaCErckhHJBGFsvd3VyK5qMZXj3hS"
    assert d.p2pkh_uncompressed == "1JwSSubhmg6iPtRjtyqhUYYH7bZg3Lfy1T"


@pytest.mark.parametrize("data", [b"", b"abc", b"\x02" + bytes(32), bytes(range(65)),
                                  b"x" * 200])
def test_hash160_and_the_written_out_ripemd160(data):
    assert encode.hash160(data) == jencode.hash160(data)
    d = hashlib.sha256(data).digest()
    assert encode.ripemd160(d) == hashlib.new("ripemd160", d).digest()
    assert encode.ripemd160(data) == hashlib.new("ripemd160", data).digest()


def _addresses():
    h = encode.hash160(b"vuke")
    return [
        jencode.p2pkh_address(h),
        jencode.p2wpkh_address(h),
        jencode.p2pkh_address(h, jencode.TESTNET),
        jencode.p2wpkh_address(h, jencode.TESTNET),
        jencode.p2wpkh_address(h, jencode.REGTEST),
        jencode.p2wpkh_address(h).upper(),
        "1BoatSLRHtKNngkdXEeobR76b53LETtpyT",
        "not an address", "", "1", "bc1qqqqqqq", "1BoatSLRHtKNngkdXEeobR76b53LETtpyU",
        "3J98t1WpEZ73CNmQviecrnyiWrnqRhWNLy", "bc1zw508d6qejxtdg4y5r3zarvaryvqyzf3du",
    ]


@pytest.mark.parametrize("addr", _addresses())
def test_decode_address_h160_matches(addr):
    assert encode.decode_address_h160(addr) == jencode.decode_address_h160(addr)


def test_encoders_match():
    h = encode.hash160(b"vuke")
    key = KEYS[-1].to_bytes(32, "big")
    assert encode.p2pkh_address(h) == jencode.p2pkh_address(h)
    assert encode.p2wpkh_address(h) == jencode.p2wpkh_address(h)
    for compressed in (True, False):
        assert encode.wif(key, compressed) == jencode.wif(key, compressed)
    payload = b"\x00\x00" + h
    assert encode.base58check_encode(payload) == jencode.base58check_encode(payload)
    assert encode.base58check_decode(jencode.base58check_encode(payload)) == payload
