"""Full key derivation on the host: every representation of a private key.

The port's copy of ``vuke_tpu/derive.py``: ``DerivedKey`` field for field,
``normalize_key`` and ``KeyDeriver``.  The public point comes from the
bignum ``ecc.ref.point_mul`` (about 10 ms); the JAX package's optional
native C++ ladder is left out, since only candidate hits are derived here.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import encode
from .ecc import ref


@dataclass
class DerivedKey:
    raw: bytes
    private_key_hex: str
    private_key_decimal: str
    private_key_binary: str
    bit_length: int
    hamming_weight: int
    leading_zeros: int
    pubkey_compressed: str
    pubkey_uncompressed: str
    wif_compressed: str
    wif_uncompressed: str
    p2pkh_compressed: str
    p2pkh_uncompressed: str
    p2wpkh: str


def normalize_key(key: bytes) -> bytes:
    """Keys reduced mod the curve order; zero -> 1."""
    v = int.from_bytes(key, "big") % ref.N
    return (v or 1).to_bytes(32, "big")


class KeyDeriver:
    """Converts 32-byte keys to every address and string format."""

    def __init__(self, network: encode.Network = encode.BITCOIN):
        self.network = network

    def derive(self, key: bytes) -> DerivedKey:
        key = normalize_key(key)
        k = int.from_bytes(key, "big")
        x, y = ref.point_mul(k)
        comp = bytes([2 + (y & 1)]) + x.to_bytes(32, "big")
        uncomp = b"\x04" + x.to_bytes(32, "big") + y.to_bytes(32, "big")
        h160c = encode.hash160(comp)
        h160u = encode.hash160(uncomp)
        hex_str = key.hex()
        return DerivedKey(
            raw=key,
            private_key_hex=hex_str,
            private_key_decimal=str(k),
            private_key_binary=format(k, "0256b"),
            bit_length=k.bit_length(),
            hamming_weight=bin(k).count("1"),
            leading_zeros=len(hex_str) - len(hex_str.lstrip("0")),
            pubkey_compressed=comp.hex(),
            pubkey_uncompressed=uncomp.hex(),
            wif_compressed=encode.wif(key, True, self.network),
            wif_uncompressed=encode.wif(key, False, self.network),
            p2pkh_compressed=encode.p2pkh_address(h160c, self.network),
            p2pkh_uncompressed=encode.p2pkh_address(h160u, self.network),
            p2wpkh=encode.p2wpkh_address(h160c, self.network),
        )
