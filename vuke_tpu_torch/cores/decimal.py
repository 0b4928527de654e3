"""The decimal ASCII string of a u64 seed as big-endian message words.

Counterpart of ``vuke_tpu/cores/decimal.py::decimal_ascii_words_be``: the
reference hashes the decimal string of every numeric input
(SHA256("12345")).  Plain PyTorch over int64-held u32 words: twenty long
divisions of (hi, lo) by 10 give the digits, least significant first, and a
gather puts byte i of the string (``'0'`` + digit ``length - 1 - i``) into
its word.  The kernels render it in ``csrc/keygen.cuh::decimal_words``.
"""

from __future__ import annotations

import torch

from .._device import MASK32

MAX_DIGITS = 20
N_WORDS = 5


def decimal_digits(hi: torch.Tensor, lo: torch.Tensor):
    """int64 (hi, lo) u32 words -> ((20, N) int64 digits, least significant
    first; (N,) int64 length, 1..20: "0" has one digit)."""
    digits = []
    length = torch.ones_like(lo)
    for j in range(MAX_DIGITS):
        r = hi % 10
        hi = hi // 10
        t = (r << 32) | lo                    # below 10 * 2^32
        lo = t // 10
        d = t % 10
        digits.append(d)
        if j:
            length = torch.where(d != 0, j + 1, length)
    return torch.stack(digits), length


def decimal_ascii_words_be(hi: torch.Tensor, lo: torch.Tensor):
    """int64 (hi, lo) u32 words -> (5 int64 BE words of the string's bytes,
    zeros beyond its end; its (N,) int64 length in bytes)."""
    digits, length = decimal_digits(hi, lo)
    words = []
    for w in range(N_WORDS):
        word = torch.zeros_like(lo)
        for b in range(4):
            i = 4 * w + b
            src = (length - 1 - i).clamp(min=0)
            dig = torch.gather(digits, 0, src[None])[0]
            byte = torch.where(i < length, dig + 0x30, 0)
            word = word | (byte << (8 * (3 - b)))
        words.append(word & MASK32)
    return words, length
