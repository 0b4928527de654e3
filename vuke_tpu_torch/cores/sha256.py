"""SHA-256 over int64-held u32 words.

Counterpart of ``vuke_tpu/cores/sha256.py`` and of the parts of
``vuke_tpu/cores/decimal.py`` the numeric transforms use: one-block
messages of a fixed length (``sha256_words``, ``sha256_key_words``) and of
a per-lane length (``sha256_single_block_varlen``); and for the string
transforms, byte strings padded on the host (``pad_message``) and digested
block by block (``sha256_blocks``), the plain version of the string-digest
kernel (``cores/digest.py``).  The compression is K2's plain one
(``cores/hash160.py``); words are big-endian message words, int64 tensors
or Python ints.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import MASK32, i64, u32
from .hash160 import SHA_IV, _sha_compress


def sha256_words(words, nbytes: int):
    """SHA-256 of an ``nbytes``-byte message (at most 55) given as its BE
    words, the last one holding its bytes in its high positions -> 8 words."""
    if nbytes > 55 or len(words) != (nbytes + 3) // 4:
        raise ValueError(f"{len(words)} words for a {nbytes}-byte one-block message")
    block = list(words) + [0] * (14 - len(words))
    block[nbytes // 4] = block[nbytes // 4] | (0x80 << (8 * (3 - nbytes % 4)))
    return _sha_compress(SHA_IV, block + [0, nbytes * 8])


def sha256_key_words(key):
    """SHA-256 of a 32-byte key given as 8 BE words -> 8 words."""
    return sha256_words(list(key), 32)


def sha256_single_block_varlen(words, length: torch.Tensor):
    """SHA-256 of messages of a per-lane length (at most 55 bytes): ``words``
    at most 14 BE words, zeros beyond each lane's ``length`` bytes -> 8 words."""
    widx = length >> 2
    term = (0x80 << (8 * (3 - (length & 3)))) & MASK32
    block = [(words[i] if i < len(words) else 0) | torch.where(widx == i, term, 0)
             for i in range(14)]
    return _sha_compress(SHA_IV, block + [0, length * 8])


def pad_message(data: bytes) -> np.ndarray:
    """SHA-256 padding of a byte message -> (B, 16) uint32 BE words: the
    0x80 byte, zeros, and the bit length as 8 BE bytes."""
    ml = len(data)
    padded = data + b"\x80"
    padded += b"\x00" * ((-(len(padded) + 8)) % 64)
    padded += (ml * 8).to_bytes(8, "big")
    return np.frombuffer(padded, dtype=">u4").astype(np.uint32).reshape(-1, 16)


def sha256_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """Padded messages of B blocks each, (M, B, 16) words -> (M, 8) uint32
    digest words."""
    w = i64(blocks)
    state = list(SHA_IV)
    for b in range(w.shape[1]):
        state = _sha_compress(state, [w[:, b, j] for j in range(16)])
    return u32(torch.stack([x + w[:, 0, 0] * 0 for x in state], dim=1))
