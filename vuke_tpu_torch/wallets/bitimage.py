"""Bitimage: file bytes -> base64 -> SHA-256 entropy -> BIP39 mnemonic ->
seed (with an optional passphrase) -> a BIP32 path, by default
m/84'/0'/0'/0/0; more addresses by incrementing the path's last index.

The port's copy of ``vuke_tpu/wallets/bitimage.py``.  Host code.
"""

from __future__ import annotations

import base64
import hashlib

from . import bip32, bip39


class BitimageDeriver:
    def __init__(self, data: bytes, passphrase: str = ""):
        entropy = hashlib.sha256(base64.b64encode(data)).digest()
        mnemonic = " ".join(bip39.entropy_to_mnemonic(entropy))
        seed = bip39.mnemonic_to_seed(mnemonic, passphrase)
        self.master_key, self.chain_code = bip32.seed_to_master_key(seed)

    def derive_path(self, path: str) -> bytes:
        return bip32.derive_path(self.master_key, self.chain_code, path)


def increment_path_index(path: str) -> str:
    """m/84'/0'/0'/0/0 -> m/84'/0'/0'/0/1 (the last component + 1)."""
    parts = path.rsplit("/", 1)
    if len(parts) != 2:
        return path
    last = parts[1]
    hardened = last.endswith("'") or last.endswith("h")
    suffix = last[-1] if hardened else ""
    idx_s = last[:-1] if hardened else last
    try:
        idx = int(idx_s)
    except ValueError:
        return path
    return f"{parts[0]}/{idx + 1}{suffix}"
