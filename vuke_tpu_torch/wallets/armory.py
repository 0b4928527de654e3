"""Armory's legacy (pre-BIP32) derivation, the port's copy of
``vuke_tpu/wallets/armory.py``.

chaincode = HMAC-SHA256(key = SHA256(SHA256(root)), "Derive Chaincode from
Root Key"); each of 4 steps multiplies the key by SHA256(SHA256(its
uncompressed public key)) XOR chaincode, mod n: the P5 key.  A 32-byte
root is the key itself, any other its SHA-256.  Host code: 4 EC
multiplications a key.
"""

from __future__ import annotations

import hashlib
import hmac
from typing import Optional

from ..ecc import ref


def armory_key(seed: bytes) -> Optional[bytes]:
    h1 = hashlib.sha256(seed).digest()
    h2 = hashlib.sha256(h1).digest()
    chaincode = int.from_bytes(
        hmac.new(h2, b"Derive Chaincode from Root Key", hashlib.sha256).digest(), "big")
    k = int.from_bytes(seed if len(seed) == 32 else h1, "big")
    if k == 0 or k >= ref.N:
        return None
    for _ in range(4):
        d = hashlib.sha256(hashlib.sha256(ref.pubkey_uncompressed(k)).digest()).digest()
        scalar = int.from_bytes(d, "big") ^ chaincode
        if scalar >= ref.N or scalar == 0:
            return None
        k = (k * scalar) % ref.N
        if k == 0:
            return None
    return k.to_bytes(32, "big")
