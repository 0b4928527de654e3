"""BIP39 mnemonics: the English wordlist, entropy -> mnemonic, and the seed.

The port's copy of ``vuke_tpu/wallets/bip39.py``: word-count and
word-membership validation without the checksum, and entropy of any length
(the MultiBit bug's 64 bytes give 48 words).  The wordlist is
``vuke_tpu_torch/data/bip39_english.txt``, a byte copy of the JAX
package's.
"""

from __future__ import annotations

import functools
import hashlib
import os
from typing import List

_WORDLIST_PATH = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                              "data", "bip39_english.txt")

VALID_WORD_COUNTS = (12, 15, 18, 21, 24)


@functools.lru_cache(maxsize=1)
def wordlist() -> List[str]:
    with open(_WORDLIST_PATH) as f:
        words = [w.strip() for w in f if w.strip()]
    assert len(words) == 2048, "BIP39 wordlist must have 2048 entries"
    return words


@functools.lru_cache(maxsize=1)
def word_index() -> dict:
    return {w: i for i, w in enumerate(wordlist())}


class MnemonicError(ValueError):
    pass


def validate_mnemonic(mnemonic: str):
    """The word count and every word's membership; the checksum is not
    verified, as the reference does not."""
    words = mnemonic.split()
    if len(words) not in VALID_WORD_COUNTS:
        raise MnemonicError(
            f"Invalid word count: {len(words)} (expected 12, 15, 18, 21, or 24)")
    idx = word_index()
    for w in words:
        if w not in idx:
            raise MnemonicError(f"Unknown word: {w}")


def entropy_to_mnemonic(entropy: bytes) -> List[str]:
    """Entropy bytes -> words: the bits, then len(entropy) / 4 checksum bits
    of its SHA-256, 11 bits a word."""
    cs_bits = len(entropy) * 8 // 32
    h = int.from_bytes(hashlib.sha256(entropy).digest(), "big")
    bits = (int.from_bytes(entropy, "big") << cs_bits) | (h >> (256 - cs_bits))
    n = (len(entropy) * 8 + cs_bits) // 11
    total = len(entropy) * 8 + cs_bits
    wl = wordlist()
    return [wl[(bits >> (total - 11 * (i + 1))) & 0x7FF] for i in range(n)]


def mnemonic_to_seed(mnemonic: str, passphrase: str = "") -> bytes:
    """PBKDF2-HMAC-SHA512, 2048 iterations, salt 'mnemonic' + passphrase."""
    return hashlib.pbkdf2_hmac("sha512", mnemonic.encode(),
                               ("mnemonic" + passphrase).encode(), 2048, 64)
