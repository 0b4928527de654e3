"""BIP32 child keys on the host, the EC through the port's ``ecc/ref.py``.

The port's copy of ``vuke_tpu/wallets/bip32.py``: the master key from
HMAC-SHA512("Bitcoin seed", seed); a hardened child from 0x00 || key ||
index, a normal one from the compressed public key || index; child =
(IL + parent) mod n; derivation paths as the reference parses them.
``derive_normal_children`` gives many normal children of one parent with
its public key computed once.
"""

from __future__ import annotations

import hashlib
import hmac
from typing import List, Tuple

from ..ecc import ref


class Bip32Error(ValueError):
    pass


def seed_to_master_key(seed: bytes) -> Tuple[bytes, bytes]:
    d = hmac.new(b"Bitcoin seed", seed, hashlib.sha512).digest()
    return d[:32], d[32:]


def _pubkey_compressed(key: bytes) -> bytes:
    return ref.pubkey_compressed(int.from_bytes(key, "big"))


def _scalar_add(il: bytes, parent: bytes) -> bytes:
    a = int.from_bytes(il, "big")
    b = int.from_bytes(parent, "big")
    if a >= ref.N:
        raise Bip32Error("scalar overflow")
    child = (a + b) % ref.N
    if child == 0:
        raise Bip32Error("zero child key")
    return child.to_bytes(32, "big")


def derive_hardened_child(parent_key: bytes, chain_code: bytes,
                          index: int) -> Tuple[bytes, bytes]:
    data = b"\x00" + parent_key + (index | 0x80000000).to_bytes(4, "big")
    d = hmac.new(chain_code, data, hashlib.sha512).digest()
    return _scalar_add(d[:32], parent_key), d[32:]


def _normal_child(parent_key: bytes, pubkey: bytes, chain_code: bytes,
                  index: int) -> Tuple[bytes, bytes]:
    d = hmac.new(chain_code, pubkey + index.to_bytes(4, "big"), hashlib.sha512).digest()
    return _scalar_add(d[:32], parent_key), d[32:]


def derive_normal_child(parent_key: bytes, chain_code: bytes,
                        index: int) -> Tuple[bytes, bytes]:
    return _normal_child(parent_key, _pubkey_compressed(parent_key), chain_code, index)


def derive_normal_children(parent_key: bytes, chain_code: bytes, count: int) -> List[bytes]:
    """The keys of normal children 0..count-1: one EC multiplication."""
    pub = _pubkey_compressed(parent_key)
    return [_normal_child(parent_key, pub, chain_code, i)[0] for i in range(count)]


def parse_derivation_path(path: str) -> List[Tuple[int, bool]]:
    """m/84'/0'/0'/0/0 -> [(84, True), (0, True), ...]."""
    path = path.strip()
    if path == "m":
        return []
    if not path.startswith("m/"):
        raise Bip32Error("Path must start with 'm/' or be 'm'")
    out = []
    for comp in path[2:].split("/"):
        if not comp:
            continue
        if comp.endswith("'") or comp.endswith("h"):
            idx_s, hardened = comp[:-1], True
        else:
            idx_s, hardened = comp, False
        try:
            idx = int(idx_s)
        except ValueError:
            raise Bip32Error(f"Invalid index: {comp}")
        if idx < 0 or idx >= 0x80000000:
            raise Bip32Error(f"Index {idx} exceeds BIP32 limit (must be < 2^31)")
        out.append((idx, hardened))
    return out


def derive_path(master_key: bytes, chain_code: bytes, path: str) -> bytes:
    key, chain = master_key, chain_code
    for index, hardened in parse_derivation_path(path):
        if hardened:
            key, chain = derive_hardened_child(key, chain, index)
        else:
            key, chain = derive_normal_child(key, chain, index)
    return key
