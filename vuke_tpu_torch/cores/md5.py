"""MD5 over int64-held u32 words.

Counterpart of ``vuke_tpu/cores/md5.py`` and of
``vuke_tpu/cores/decimal.py::md5_single_block_varlen``: one-block messages
of a per-lane length, and byte strings padded on the host
(``pad_message``) and digested block by block (``md5_blocks``, the plain
version of the string-digest kernel's md5 mode).  MD5 reads its message as
little-endian words and returns 4 little-endian state words: serialized
little-endian they are the digest's bytes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._device import MASK32, byteswap32, i64, rotl32, u32

K = tuple(int(abs(math.sin(i + 1)) * 2**32) & MASK32 for i in range(64))
S = (7, 12, 17, 22) * 4 + (5, 9, 14, 20) * 4 + (4, 11, 16, 23) * 4 + (6, 10, 15, 21) * 4
IV = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476)


def compress(state, m):
    """One MD5 compression of the 16 LE message words ``m`` into ``state``."""
    a, b, c, d = state
    A, B, C, D = a, b, c, d
    for i in range(64):
        if i < 16:
            f, g = (B & C) | ((B ^ MASK32) & D), i
        elif i < 32:
            f, g = (D & B) | ((D ^ MASK32) & C), (5 * i + 1) % 16
        elif i < 48:
            f, g = B ^ C ^ D, (3 * i + 5) % 16
        else:
            f, g = C ^ (B | (D ^ MASK32)), (7 * i) % 16
        f = (f + A + K[i] + m[g]) & MASK32
        A, D, C = D, C, B
        B = (B + rotl32(f, S[i])) & MASK32
    return [(x + y) & MASK32 for x, y in zip((a, b, c, d), (A, B, C, D))]


def md5_single_block_varlen(words_be, length: torch.Tensor):
    """MD5 of messages of a per-lane length (at most 55 bytes) given as BE
    words in string order, zeros beyond ``length`` -> 4 LE digest words."""
    widx = length >> 2
    term = 0x80 << (8 * (length & 3))
    m = [byteswap32(words_be[i]) if i < len(words_be) else 0 for i in range(14)]
    m = [w | torch.where(widx == i, term, 0) for i, w in enumerate(m)]
    return compress(IV, m + [length * 8, 0])


def pad_message(data: bytes) -> np.ndarray:
    """MD5 padding of a byte message -> (B, 16) uint32 LE words: the 0x80
    byte, zeros, and the bit length as 8 LE bytes."""
    ml = len(data)
    padded = data + b"\x80"
    padded += b"\x00" * ((-(len(padded) + 8)) % 64)
    padded += (ml * 8 & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little")
    return np.frombuffer(padded, dtype="<u4").astype(np.uint32).reshape(-1, 16)


def md5_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """Padded messages of B blocks each, (M, B, 16) LE words -> (M, 4)
    uint32 LE digest words."""
    w = i64(blocks)
    state = list(IV)
    for b in range(w.shape[1]):
        state = compress(state, [w[:, b, j] for j in range(16)])
    return u32(torch.stack([x + w[:, 0, 0] * 0 for x in state], dim=1))
