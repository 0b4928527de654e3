"""MultiBit HD's seed-as-entropy bug: mnemonic -> BIP39 seed -> (the bug)
the 64-byte seed taken as entropy -> a 48-word mnemonic -> its BIP39 seed
-> BIP32 m/0'/0/i.  Pinned by the reference's MultiBit bug vector.

The port's copy of ``vuke_tpu/wallets/multibit.py``.  In a batch
(``multibit_hd_keys_batch``, the dictionary attack) the two PBKDF2
stretches, 2 x 2048 iterations a candidate, run through W1 on the card
(``pbkdf2_device.py``) once there are ``min_device_batch`` valid
candidates; the BIP32 tail stays on the host, as in the JAX package, with
one EC multiplication for m/0' -> m/0'/0 and one for the children of
m/0'/0 (``bip32.derive_normal_children``).
"""

from __future__ import annotations

from typing import List

from . import bip32, bip39


class MultibitError(ValueError):
    pass


def _tail(seed: bytes, count: int) -> List[bytes]:
    """m/0'/0/0 .. m/0'/0/(count - 1) of a BIP39 seed."""
    mk, cc = bip32.seed_to_master_key(seed)
    k0h, c0h = bip32.derive_hardened_child(mk, cc, 0)
    k0h0, c0h0 = bip32.derive_normal_child(k0h, c0h, 0)
    return bip32.derive_normal_children(k0h0, c0h0, count)


class MultibitBugDeriver:
    def __init__(self, mnemonic: str, passphrase: str = ""):
        try:
            bip39.validate_mnemonic(mnemonic)
        except bip39.MnemonicError as e:
            raise MultibitError(str(e))
        original_seed = bip39.mnemonic_to_seed(mnemonic, passphrase)
        buggy_mnemonic = " ".join(bip39.entropy_to_mnemonic(original_seed))
        self.buggy_seed = bip39.mnemonic_to_seed(buggy_mnemonic, passphrase)
        self.master_key, self.chain_code = bip32.seed_to_master_key(self.buggy_seed)

    def derive_key(self, index: int) -> bytes:
        k0h, c0h = bip32.derive_hardened_child(self.master_key, self.chain_code, 0)
        k0h0, c0h0 = bip32.derive_normal_child(k0h, c0h, 0)
        key, _ = bip32.derive_normal_child(k0h0, c0h0, index)
        return key

    def derive_keys(self, count: int) -> List[bytes]:
        return _tail(self.buggy_seed, count)


def multibit_hd_keys(mnemonic: str, passphrase: str, count: int) -> List[bytes]:
    try:
        deriver = MultibitBugDeriver(mnemonic, passphrase)
    except MultibitError as e:
        raise ValueError(str(e))
    return deriver.derive_keys(count)


def multibit_hd_keys_batch(mnemonics: List[str], passphrase: str, count: int,
                           min_device_batch: int = 32, device=None):
    """The dictionary attack's batch: [(mnemonic, [keys])] for the valid
    entries.  On a CUDA ``device`` with at least ``min_device_batch`` valid
    candidates the two stretches run through W1, two launches; otherwise,
    and on the CPU, hashlib per candidate."""
    from .pbkdf2_device import device_available, pbkdf2_hmac_sha512_batch

    valid = []
    for m in mnemonics:
        try:
            bip39.validate_mnemonic(m)
            valid.append(m)
        except bip39.MnemonicError:
            continue
    if not valid:
        return []
    salt = ("mnemonic" + passphrase).encode()
    if device_available(device) and len(valid) >= min_device_batch:
        seeds = pbkdf2_hmac_sha512_batch([m.encode() for m in valid], salt, device=device)
        buggy = [" ".join(bip39.entropy_to_mnemonic(s)) for s in seeds]
        buggy_seeds = pbkdf2_hmac_sha512_batch([b.encode() for b in buggy], salt,
                                               device=device)
    else:
        buggy_seeds = []
        for m in valid:
            s = bip39.mnemonic_to_seed(m, passphrase)
            b = " ".join(bip39.entropy_to_mnemonic(s))
            buggy_seeds.append(bip39.mnemonic_to_seed(b, passphrase))
    return [(m, _tail(bs, count)) for m, bs in zip(valid, buggy_seeds)]


def truncate_mnemonic(mnemonic: str) -> str:
    words = mnemonic.split()
    if len(words) <= 4:
        return mnemonic
    return f"{' '.join(words[:2])}...{' '.join(words[-2:])}"
